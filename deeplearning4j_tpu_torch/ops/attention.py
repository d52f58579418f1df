"""Dense causal attention — the plain path bulk prefill takes when the
flash kernel does not apply (port of ``deeplearning4j_tpu/ops/attention.py``
``attention``)."""

from __future__ import annotations

import math

import torch


def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: the reference
    casts its scale constants to the input dtype, and a host scalar keeps
    the device stream free of a blocking upload."""
    return torch.tensor(value, dtype=dtype).item()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, layout: str = "bthd") -> torch.Tensor:
    """Reference dense attention.

    ``layout="bthd"``: q, k, v (B, T, H, D) -> (B, T, H, D).
    ``layout="bhtd"``: q, k, v (B, H, T, D) -> (B, H, T, D).
    The logits divide by ``sqrt(D)`` cast to the input dtype, as the
    reference does; the softmax runs in the input dtype.
    """
    d = q.shape[-1]
    if layout == "bhtd":
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    logits = logits / dtype_scalar(math.sqrt(d), q.dtype)
    if causal:
        t_q, t_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if layout == "bhtd":
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
