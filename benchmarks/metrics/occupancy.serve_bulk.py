"""Slots decoding a horizon, from the engine's occupancy records
(ServingMetrics.occupancy, one a dispatched horizon) in the window, over
the slot count."""


def read(rec):
    w = rec["window"]
    if w.get("occupancy_mean") is None:
        return None
    return 100.0 * w["occupancy_mean"] / w["n_slots"]
