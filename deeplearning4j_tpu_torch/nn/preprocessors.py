"""Inter-layer activation pre/post processors (the JAX package's
``nn/preprocessors.py``), configured per layer index on
``MultiLayerConfig.preprocessors``; the binomial sampler draws on the
reference's key stream. The statistics of the ``zero_mean`` and
``unit_variance`` processors are the whole batch's over a data axis
(``parallel.lockstep.batch_moments``), as the reference's sharded step
takes them."""

from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.parallel.lockstep import batch_moments

Processor = Callable[..., torch.Tensor]

_REGISTRY: dict[str, Processor] = {}


def register(name: str):
    def deco(fn: Processor) -> Processor:
        _REGISTRY[name] = fn
        return fn

    return deco


def get(name: str) -> Processor:
    if name.startswith("reshape:"):
        dims = tuple(int(x) for x in name.split(":", 1)[1].split(","))
        return lambda x, key=None: x.reshape((x.shape[0], *dims))
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown preprocessor {name!r}; known: {sorted(_REGISTRY)}") from None


@register("flatten")
def flatten(x, key=None):
    return x.reshape(x.shape[0], -1)


@register("binomial_sampling")
def binomial_sampling(x, key=None):
    """Sample Bernoulli(x); deterministic eval (no key) passes x through."""
    if key is None:
        return x
    return rng.bernoulli(key, torch.clamp(x, 0.0, 1.0),
                         batch=True).to(x.dtype)


@register("zero_mean_unit_variance")
def zero_mean_unit_variance(x, key=None):
    mean, std = batch_moments(x, (0,), std=True)
    return (x - mean) / (std + 1e-8)


@register("zero_mean")
def zero_mean(x, key=None):
    return x - batch_moments(x, (0,))[0]


@register("unit_variance")
def unit_variance(x, key=None):
    return x / (batch_moments(x, (0,), std=True)[1] + 1e-8)
