"""A backlog: every request is due at once, and the load generator keeps
the engine's queue at its depth, so a slot that frees is filled at the
next step."""


def rate(spec: dict) -> None:
    return None


def gaps(spec: dict, u) -> None:
    return None
