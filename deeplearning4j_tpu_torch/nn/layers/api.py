"""Layer module protocol + shared helpers (the JAX package's
``nn/layers/api.py``).

A layer module provides pure functions over a dict of tensors:

- ``init(key, conf, device=None) -> params``
- ``pre_output(params, conf, x)``        the affine part
- ``activate(params, conf, x, key=None, training=False)``
                                         f(pre_output) + dropout
- ``score(params, conf, x, key)``        unsupervised objective of the
                                         pretrain layers (lower is better)
- ``gradient(params, conf, x, key) -> (score, grads)``
                                         autodiff of ``score`` by default;
                                         the RBM returns CD-k statistics.

Keys are the reference's (host key data, ``rng``), so a layer's dropout,
corruption and sampling draws are the reference's for the same key. Param
keys reuse the reference's names (W, b, vb, recurrentweights,
decoderweights, decoderbias, convweights, convbias); the conv layer holds
its weights in PyTorch's OIHW layout where the reference holds HWIO
(``models/multilayer.params_from_jax`` converts).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.nn.conf import LayerConfig

Params = dict[str, torch.Tensor]

WEIGHT_KEY = "W"
BIAS_KEY = "b"
VISIBLE_BIAS_KEY = "vb"
RECURRENT_WEIGHTS = "recurrentweights"
DECODER_WEIGHTS = "decoderweights"
DECODER_BIAS = "decoderbias"
CONV_WEIGHTS = "convweights"
CONV_BIAS = "convbias"

_REGISTRY: dict[str, Any] = {}


def register(name: str) -> Callable[[Any], Any]:
    def deco(mod: Any) -> Any:
        _REGISTRY[name] = mod() if isinstance(mod, type) else mod
        return mod

    return deco


def get(name: str) -> Any:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown layer type {name!r}; known: {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def dropout_mask(key, shape, rate: float, dtype, device,
                 batch: bool = False) -> torch.Tensor:
    """Inverted-dropout mask: Bernoulli(1 - rate) / (1 - rate), the
    reference's draw from the same key; ``batch`` for a mask over a batch
    (``rng.batch_rows``)."""
    keep = 1.0 - rate
    return rng.bernoulli(key, keep, tuple(shape), device=device,
                         batch=batch).to(dtype) / keep


def apply_dropout(x: torch.Tensor, conf: LayerConfig, key,
                  training: bool) -> torch.Tensor:
    """Dropout over a batch ``x`` (rows first), the reference's mask over
    the same element order."""
    if not training or conf.dropout <= 0.0 or key is None:
        return x
    return x * dropout_mask(key, x.shape, conf.dropout, x.dtype, x.device,
                            batch=True)


def value_and_grad(fn: Callable) -> Callable:
    """``fn(params, *args) -> scalar`` to ``(value, grads)``: the forward
    and the backward run inside ``dtypes.precision()`` (cuDNN's and
    cuBLAS's TF32 as the policy says, deterministic cuDNN), the grads a
    tree of ``params``' structure; the value is detached."""

    def wrapped(params, *args, **kw):
        leaves, spec = pytree.tree_flatten(params)
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        with torch.enable_grad(), dtypes.precision():
            value = fn(pytree.tree_unflatten(live, spec), *args, **kw)
            grads = torch.autograd.grad(value, live, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g
                 for leaf, g in zip(leaves, grads)]
        return value.detach(), pytree.tree_unflatten(grads, spec)

    return wrapped


def default_gradient(mod, params: Params, conf: LayerConfig, x: torch.Tensor,
                     key):
    """(score, grads) by autodiff of the module's score."""
    return value_and_grad(lambda p: mod.score(p, conf, x, key))(params)


def l2_penalty(params: Params, conf: LayerConfig):
    if not conf.use_regularization or conf.l2 <= 0.0:
        return 0.0
    w = params.get(WEIGHT_KEY)
    if w is None:
        return 0.0
    return 0.5 * conf.l2 * torch.sum(w * w)
