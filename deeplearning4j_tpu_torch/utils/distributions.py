"""Distribution factory (the port's version of
``deeplearning4j_tpu/utils/distributions.py``).

≙ reference distributions/Distributions.java:109 (commons-math factory
for normal/uniform/binomial used by weight init and sampling). Names map
to samplers over the port's threefry keys (``rng.py``): ``normal``,
``uniform`` and ``binomial`` with ``n == 1`` draw the reference's
``jax.random`` streams for the same key; ``binomial`` with ``n > 1`` is
the sum of ``n`` Bernoulli draws over ``split(key, n)`` (the same
distribution, another stream than ``jax.random.binomial``'s).
"""

from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.device import resolve_device

Sampler = Callable[..., torch.Tensor]


def normal(mean: float = 0.0, std: float = 1.0) -> Sampler:
    def sample(key, shape, dtype=torch.float32, device=None):
        return mean + std * rng.normal(key, shape,
                                       device=resolve_device(device),
                                       dtype=dtype)

    return sample


def uniform(low: float = 0.0, high: float = 1.0) -> Sampler:
    def sample(key, shape, dtype=torch.float32, device=None):
        return rng.uniform(key, shape, low, high,
                           device=resolve_device(device)).to(dtype)

    return sample


def binomial(n: int = 1, p: float = 0.5) -> Sampler:
    def sample(key, shape, dtype=torch.float32, device=None):
        device = resolve_device(device)
        if n == 1:
            return rng.bernoulli(key, p, shape, device=device).to(dtype)
        draws = [rng.bernoulli(k, p, shape, device=device).to(dtype)
                 for k in rng.split(key, n)]
        return torch.stack(draws).sum(0)

    return sample


def get(name: str, *args, **kw) -> Sampler:
    try:
        return {"normal": normal, "uniform": uniform,
                "binomial": binomial}[name](*args, **kw)
    except KeyError:
        raise ValueError(f"Unknown distribution {name!r}") from None
