"""Kernels in the traced window over the decode substeps dispatched in it
(horizons x K, from the engine's occupancy records)."""


def read(rec):
    tr, w = rec["trace"], rec["work"]
    if tr is None or not w.get("substeps"):
        return None
    return len(tr.kernels()) / w["substeps"]
