"""Weight-initialization schemes (the JAX package's ``nn/weights.py``) on
the reference's key stream: from the same key, the uniform schemes give the
reference's weights bit for bit and the normal scheme within a few ulps
(``rng.normal``)."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from deeplearning4j_tpu_torch import dtypes, rng

#: the scheme names (string-valued in configs)
SCHEMES = ("vi", "zero", "size", "distribution", "normalized", "uniform")


def init_weights(
    key,
    shape: Sequence[int],
    scheme: str = "vi",
    dist: tuple[str, float, float] | None = None,
    dtype=None,
    device=None,
) -> torch.Tensor:
    """Initialize a weight tensor on ``device`` (the CPU by default).

    Args:
      key: host key data (``rng``).
      shape: tensor shape; fan-in is ``shape[0]``, fan-out ``shape[1]``.
      scheme: one of SCHEMES (case-insensitive).
      dist: for ``distribution``: ("normal"|"uniform", a, b) where
        normal=(mean, std), uniform=(low, high).
      dtype: overrides the active dtype policy's param dtype.
    """
    dtype = dtype or dtypes.get_policy().param_dtype
    scheme = scheme.lower()
    shape = tuple(int(s) for s in shape)
    fan_in = shape[0]
    fan_out = shape[1] if len(shape) > 1 else shape[0]

    def uniform(lo, hi):
        return rng.uniform(key, shape, lo, hi, device=device, dtype=dtype)

    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype, device=device)
    if scheme == "normalized":
        # rand(shape) - 0.5 / fan_in
        return (uniform(0.0, 1.0) - 0.5) / fan_in
    if scheme == "uniform":
        # U(-1/fan_in, 1/fan_in)
        a = 1.0 / fan_in
        return uniform(-a, a)
    if scheme == "vi":
        # Glorot-style: U(-r, r), r = sqrt(6)/sqrt(sum(shape)+1)
        r = math.sqrt(6.0) / math.sqrt(sum(shape) + 1)
        return uniform(-r, r)
    if scheme == "size":
        # U(-4*sqrt(6/(fan_in+fan_out)), +)
        r = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-r, r)
    if scheme == "distribution":
        if dist is None:
            dist = ("normal", 0.0, 0.01)
        kind, a, b = dist
        if kind == "normal":
            return a + b * rng.normal(key, shape, device=device, dtype=dtype)
        if kind == "uniform":
            return uniform(a, b)
        raise ValueError(f"Unknown distribution kind {kind!r}")
    raise ValueError(f"Unknown weight init scheme {scheme!r}; known: {SCHEMES}")
