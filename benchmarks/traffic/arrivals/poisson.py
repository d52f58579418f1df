"""Poisson arrivals at ``rate`` requests a second: exponential gaps."""

import numpy as np


def rate(spec: dict) -> float:
    return float(spec["rate"])


def gaps(spec: dict, u: np.ndarray) -> np.ndarray:
    return -np.log1p(-u) / rate(spec)
