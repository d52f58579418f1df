"""Lognormal lengths: ``median`` and ``sigma`` (of the log)."""

import math
from statistics import NormalDist

import numpy as np


def quantiles(spec: dict, u: np.ndarray) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
    return np.exp(math.log(spec["median"]) + spec["sigma"] * z)
