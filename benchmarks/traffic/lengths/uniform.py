"""Lengths uniform over the whole numbers ``min`` to ``max``."""

import numpy as np


def quantiles(spec: dict, u: np.ndarray) -> np.ndarray:
    return spec["min"] + u * (spec["max"] - spec["min"] + 1) - 0.5
