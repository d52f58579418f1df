"""Math utilities.

≙ reference util/MathUtils.java:1272 + berkeley/SloppyMath.java:1026 —
the subset with live call sites in the reference (entropy, information
gain helpers, correlation, distances, log-sum-exp, sigmoid variants,
normalization, permutations).

The port's copy of ``deeplearning4j_tpu/utils/math_utils.py``.
"""

from __future__ import annotations

import math

import numpy as np


def entropy(probs) -> float:
    p = np.asarray(probs, dtype=np.float64)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def information_gain(parent_probs, splits: list[tuple[float, list]]) -> float:
    """Entropy(parent) - sum_i w_i * Entropy(split_i)."""
    return entropy(parent_probs) - sum(w * entropy(p) for w, p in splits)


def log_sum_exp(xs) -> float:
    xs = np.asarray(xs, dtype=np.float64)
    m = xs.max()
    return float(m + np.log(np.exp(xs - m).sum()))


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x)))


def euclidean_distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))


def manhattan_distance(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def cosine_similarity(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def correlation(a, b) -> float:
    """Pearson correlation (≙ MathUtils.correlation)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.corrcoef(a, b)[0, 1])

def ssr(predicted, actual) -> float:
    """Sum of squared residuals."""
    p, a = np.asarray(predicted), np.asarray(actual)
    return float(((p - a) ** 2).sum())


def normalize(x, min_v=None, max_v=None):
    x = np.asarray(x, dtype=np.float64)
    lo = x.min() if min_v is None else min_v
    hi = x.max() if max_v is None else max_v
    return (x - lo) / max(hi - lo, 1e-12)


def bernoulli_log_likelihood(x, p) -> float:
    x, p = np.asarray(x, np.float64), np.clip(np.asarray(p, np.float64), 1e-12, 1 - 1e-12)
    return float((x * np.log(p) + (1 - x) * np.log(1 - p)).sum())


def factorial(n: int) -> float:
    return math.factorial(n)


def combinations(n: int, r: int) -> float:
    return math.comb(n, r)


def permutations(n: int, r: int) -> float:
    return math.perm(n, r)


def round_to(x: float, decimals: int) -> float:
    return round(x, decimals)


def next_power_of_2(n: int) -> int:
    return 1 if n <= 1 else 2 ** math.ceil(math.log2(n))


def clamp(x, lo, hi):
    return max(lo, min(hi, x))
