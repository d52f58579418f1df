"""Dense causal attention — the plain path bulk prefill takes when the
flash kernel does not apply — and the online-softmax block update ring
attention is built on (port of ``deeplearning4j_tpu/ops/attention.py``:
``attention``, ``online_softmax_block``, ``finalize_online_softmax``,
``blocked_attention``)."""

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


def _exp_or_zero(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """exp(x - m) with a 0 where the running max ``m`` is still -inf (a
    row that has seen only masked keys), the reference's ``safe``."""
    neg = torch.isneginf(m)[..., None]
    return torch.where(neg, torch.zeros_like(x),
                       torch.exp(x - torch.where(neg, torch.zeros_like(
                           m[..., None]), m[..., None])))


def online_softmax_block(q, k_blk, v_blk, m_prev, l_prev, o_prev,
                         block_bias=None):
    """One KV-block update of streaming attention: q (B, Tq, H, D),
    k_blk/v_blk (B, Tb, H, D), running max and normalizer m_prev/l_prev
    (B, H, Tq), numerator o_prev (B, Tq, H, D) -> (m, l, o). Combining
    every KV block, in any order, gives exact softmax attention. In q's
    dtype, as the reference's."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) / dtype_scalar(
        math.sqrt(d), q.dtype)
    if block_bias is not None:
        s = s + block_bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = _exp_or_zero(s, m_new)
    neg_new = torch.isneginf(m_new)
    correction = torch.where(
        torch.isneginf(m_prev), torch.zeros_like(m_prev),
        torch.exp(m_prev - torch.where(neg_new, torch.zeros_like(m_new),
                                       m_new)))
    l_new = correction * l_prev + p.sum(dim=-1)
    o_new = correction.transpose(1, 2)[..., None] * o_prev + torch.einsum(
        "bhqk,bkhd->bqhd", p, v_blk)
    return m_new, l_new, o_new


def finalize_online_softmax(l, o):
    """The accumulated numerator over the normalizer."""
    return o / torch.clamp_min(l.transpose(1, 2)[..., None], 1e-30)


def causal_bias(pos_q, pos_k, dtype) -> torch.Tensor:
    """(1, 1, Tq, Tk) additive mask: 0 where the key's global position is
    at most the query's, -inf elsewhere."""
    keep = pos_q[:, None] >= pos_k[None, :]
    return torch.where(keep, 0.0, float("-inf")).to(dtype)[None, None]


def blocked_attention(q, k, v, block_size: int,
                      causal: bool = False) -> torch.Tensor:
    """Single-device streaming attention over KV blocks of
    ``block_size`` (the online-softmax math ring attention distributes):
    q, k, v (B, T, H, D) -> (B, T, H, D)."""
    b, t, h, _ = q.shape
    m = torch.full((b, h, t), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, t), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    pos_q = torch.arange(t, device=q.device)
    for start in range(0, t, block_size):
        k_blk = k[:, start:start + block_size]
        v_blk = v[:, start:start + block_size]
        bias = None
        if causal:
            bias = causal_bias(pos_q, start + torch.arange(
                k_blk.shape[1], device=q.device), q.dtype)
        m, l, o = online_softmax_block(q, k_blk, v_blk, m, l, o, bias)
    return finalize_online_softmax(l, o)
