"""Loss functions (the JAX package's ``nn/losses.py``): MSE, EXPLL, XENT,
MCXENT, RMSE_XENT, SQUARED_LOSS, RECONSTRUCTION_CROSSENTROPY,
NEGATIVELOGLIKELIHOOD, each a pure ``(labels, output) -> scalar`` (mean over
the batch) with the reference's ``EPS`` clipping, and ``logits_loss``, the
fused activation + loss on logits for the softmax/MCXENT and sigmoid/XENT
pairs."""

from __future__ import annotations

from typing import Callable

import torch

EPS = 1e-7

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REGISTRY: dict[str, LossFn] = {}


def register(name: str) -> Callable[[LossFn], LossFn]:
    def deco(fn: LossFn) -> LossFn:
        _REGISTRY[name.upper()] = fn
        return fn

    return deco


def get(name: str) -> LossFn:
    try:
        return _REGISTRY[name.upper()]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}; known: {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def _clip(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, EPS, 1.0 - EPS)


@register("MSE")
def mse(labels, output):
    return torch.mean(torch.sum((labels - output) ** 2, dim=-1))


@register("SQUARED_LOSS")
def squared_loss(labels, output):
    return torch.mean(torch.sum((labels - output) ** 2, dim=-1))


@register("RMSE_XENT")
def rmse_xent(labels, output):
    # root of the per-example squared error
    return torch.mean(torch.sqrt(torch.sum((labels - output) ** 2, dim=-1) + EPS))


@register("XENT")
def xent(labels, output):
    """Element-wise binary cross-entropy (sigmoid outputs)."""
    p = _clip(output)
    return torch.mean(torch.sum(
        -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p)), dim=-1))


@register("MCXENT")
def mcxent(labels, output):
    """Multiclass cross-entropy against softmax outputs (one-hot labels)."""
    return torch.mean(torch.sum(-labels * torch.log(_clip(output)), dim=-1))


@register("NEGATIVELOGLIKELIHOOD")
def negative_log_likelihood(labels, output):
    return mcxent(labels, output)


@register("EXPLL")
def expll(labels, output):
    """Exponential log-likelihood (Poisson-style)."""
    return torch.mean(torch.sum(output - labels * torch.log(_clip(output)), dim=-1))


@register("RECONSTRUCTION_CROSSENTROPY")
def reconstruction_crossentropy(labels, output):
    """Reconstruction cross-entropy for pretraining layers."""
    p = _clip(output)
    return torch.mean(torch.sum(
        -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p)), dim=-1))


def logits_loss(name: str, labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Numerically stable fused activation + loss on logits for the common
    pairs; ``ValueError`` for a loss with no fused form."""
    name = name.upper()
    if name in ("MCXENT", "NEGATIVELOGLIKELIHOOD"):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.mean(torch.sum(-labels * logp, dim=-1))
    if name in ("XENT", "RECONSTRUCTION_CROSSENTROPY"):
        # sigmoid cross-entropy from logits
        return torch.mean(torch.sum(
            torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))), dim=-1))
    raise ValueError(f"No fused logits form for loss {name!r}")
