"""Global dtype policy (the reference's ``dtypes.py``).

Parameters and accumulations in float32; matmul and conv inputs in the
policy's compute dtype. ``FLOAT32`` is f32 everywhere, ``MIXED_BF16``
bfloat16 compute with f32 params and accumulation.

A policy also says whether TF32 may stand in for f32 on the card
(``allow_tf32``, off in both presets). cuDNN convolutions run in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True out of the box), which
would cost LeNet under ``FLOAT32`` about 1e-3 relative accuracy. The layers,
every gradient the port takes (``value_and_grad``, each solve, Hessian-free's
``torch.func`` products) and the network's inference run inside
:func:`precision`, which sets cuDNN's and cuBLAS's TF32 switches (and
cuDNN's deterministic algorithms) from the policy for the length of the
call and puts the caller's settings back after it; nothing flips the
process-wide flags for good.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy: where params live, what compute runs in, what
    accumulates, and whether TF32 may replace f32 products on the card."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32
    allow_tf32: bool = False

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_to_param(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.param_dtype)


#: float32 everywhere (no TF32): the reference's forced float32 test dtype
FLOAT32 = Policy()

#: bfloat16 compute with float32 params and accumulation
MIXED_BF16 = Policy(compute_dtype=torch.bfloat16)

_current = FLOAT32


def get_policy() -> Policy:
    return _current


def set_policy(policy: Policy) -> None:
    global _current
    _current = policy


@contextlib.contextmanager
def policy(p: Policy) -> Iterator[Policy]:
    global _current
    prev = _current
    _current = p
    try:
        yield p
    finally:
        _current = prev


@contextlib.contextmanager
def precision(p: Policy | None = None) -> Iterator[None]:
    """cuBLAS and cuDNN TF32 as policy ``p`` (the current one by default)
    says, and cuDNN's deterministic algorithms, until the block ends; the
    caller's settings come back after it. Wraps a forward and the backward
    of a gradient: cuDNN reads its switches when each kernel is chosen."""
    p = p or _current
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (mm.allow_tf32, dnn.allow_tf32, dnn.deterministic)
    mm.allow_tf32 = dnn.allow_tf32 = p.allow_tf32
    dnn.deterministic = True
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32, dnn.deterministic = prev
