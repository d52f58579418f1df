"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attn_fwd.cu``) and its plain PyTorch version.

Replaces ``_flash_fwd_stream_kernel`` (deeplearning4j_tpu/ops/pallas_kernels.py
:125, called through ``_flash_fwd_call`` :179) on the bulk-prefill path,
where the reference calls ``flash_attention_trainable(..., causal=True,
layout="bhtd")`` forward-only (models/transformer.py:1310).

What bounds it on the H100, and what the design does: at the serving shapes
(B*H = 6, T <= 128, D = 128, bf16) one call moves well under a megabyte and
does under 0.1 GFLOP, so it is bound by launch and latency rather than by
HBM bytes or tensor-core operations. The kernel keeps every intermediate on
chip — one block per (head-batch row, 64-row Q tile), K/V tiles in shared
memory, f32 running max/sum/accumulator in registers — and skips the KV
tiles above the causal diagonal. See the source for the tile layout.

Dispatch: a CPU tensor runs :func:`flash_attention_fwd_plain`; a CUDA tensor
launches the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops.attention import dtype_scalar

#: kernel launches since the last reset (counted where the kernel launches)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, same signature and layouts:
    (BH, T, D) in, O (BH, T, D) in q's dtype and lse (BH, T, 1) f32 out.

    Rounds where the reference rounds: the Q tile is scaled in the input
    dtype (by the scale cast to that dtype), the scores and the softmax are
    f32, and the probabilities are cast to V's dtype for the PV product with
    f32 accumulation."""
    d = q.shape[-1]
    qs = (q * dtype_scalar(1.0 / math.sqrt(d), q.dtype)).float()
    s = qs @ k.float().transpose(-1, -2)
    if causal:
        t = q.shape[-2]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float()) / l.clamp_min(1e-30)
    lse = m + torch.log(l.clamp_min(1e-30))
    return o.to(q.dtype), lse


def _check_cuda_args(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(
            f"flash_attention_fwd needs q, k, v of one (BH, T, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash_attention_fwd takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on the same device")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"flash_attention_fwd launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), got tensors on {q.device}"
        )
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention_fwd kernel takes head_dim in {_HEAD_DIMS}, "
            f"got {q.shape[-1]}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_fwd needs contiguous {name}")


def _kernel():
    lib = _build.library("flash_attn_fwd")
    fn = lib.dl4j_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, k, v, causal):
    global launches
    _check_cuda_args(q, k, v)
    bh, t, d = q.shape
    lib, fn = _kernel()
    o = torch.empty_like(q)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, t, d, 1.0 / math.sqrt(d), int(causal),
             _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attn_fwd")
    launches += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(BH, T, D) flash forward -> (O, lse (BH, T, 1)). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Forward flash attention in the reference's ``layout="bhtd"``
    (``flash_attention_trainable`` forward): (B, H, T, D) in and out."""
    b, h, t, d = q.shape
    qf, kf, vf = (x.reshape(b * h, t, d).contiguous() for x in (q, k, v))
    o, _ = flash_attention_fwd(qf, kf, vf, causal)
    return o.reshape(b, h, t, d)
