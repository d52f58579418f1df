"""Activation-function registry (the JAX package's ``nn/activations.py``):
the reference's activation names onto PyTorch functions, so a config's
string names the same function in both packages."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: dict[str, ActivationFn] = {}


def register(name: str) -> Callable[[ActivationFn], ActivationFn]:
    def deco(fn: ActivationFn) -> ActivationFn:
        _REGISTRY[name] = fn
        return fn

    return deco


def get(name: str) -> ActivationFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@register("relu")
def relu(x):
    return torch.relu(x)


@register("leakyrelu")
def leakyrelu(x):
    return F.leaky_relu(x, 0.01)


@register("softplus")
def softplus(x):
    # log1p(exp(x)) without a threshold, as jax.nn.softplus (logaddexp)
    return torch.logaddexp(x, torch.zeros_like(x))


@register("softsign")
def softsign(x):
    return x / (torch.abs(x) + 1)


@register("linear")
def linear(x):
    return x


@register("exp")
def exp(x):
    return torch.exp(x)


@register("softmax")
def softmax(x):
    # row-wise over the feature axis, numerically stabilized
    return torch.softmax(x, dim=-1)


@register("rounded")
def rounded(x):
    return torch.round(x)


def derivative(name: str, activated: torch.Tensor) -> torch.Tensor:
    """Derivative expressed in terms of the *activated* value (the
    reference's closed forms; autodiff makes them unnecessary on the main
    path)."""
    if name == "sigmoid":
        return activated * (1.0 - activated)
    if name == "tanh":
        return 1.0 - activated**2
    if name == "hardtanh":
        return ((activated > -1.0) & (activated < 1.0)).to(activated.dtype)
    if name == "relu":
        return (activated > 0.0).to(activated.dtype)
    if name == "linear":
        return torch.ones_like(activated)
    if name == "softmax":
        return activated * (1.0 - activated)
    raise ValueError(f"No closed-form derivative registered for {name!r}")
