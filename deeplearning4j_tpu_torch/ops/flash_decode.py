"""Flash decode attention over the packed, stacked KV cache: the
hand-written CUDA kernel (``csrc/flash_decode.cu``) and its plain PyTorch
version.

Replaces ``_flash_decode_kernel`` (deeplearning4j_tpu/ops/pallas_kernels.py
:502, launched by ``flash_decode_attention`` :645) in its bf16/f32 mode. The
reference calls it from ``block_decode`` (models/transformer.py:1066) in
every decode substep of every layer; the int8 mode (``kv_scales``) is not on
this slice's path and is not ported here.

What bounds it on the H100, and what the design does: HBM bytes. A call must
read the visible K and V rows of one layer, ``sum_b (pos[b]+1) * Hkv*K * 2``
elements, at a few flops per element. The kernel streams every visible row
once per (batch row, KV head) block, serves all G query heads of the group
from one read (the reference's GQA fold), reads layer ``layer`` straight out
of the stacked buffer through strides (no slice copy), and never touches a
tile past ``pos[b]``. Its grid is only B x Hkv blocks (48 at 8 slots x 6
heads on a 132-SM card); splitting T across blocks is the first redesign
item.

Dispatch: a CPU tensor runs :func:`flash_decode_attention_plain`; a CUDA
tensor launches the kernel or raises. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import _build

#: kernel launches since the last reset (counted where the kernel launches)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


def reset_launches() -> None:
    global launches
    launches = 0


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar position broadcast to every row, or the per-row (B,)
    vector, as int32 on ``device``."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        if p.dim() == 0:
            p = p.expand(b)
        return p.contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def flash_decode_attention_plain(q: torch.Tensor, kvcache: torch.Tensor,
                                 pos, n_kv_heads: int, layer: int = 0
                                 ) -> torch.Tensor:
    """Plain version of the kernel, same signature and layouts: q
    (B, G, Hkv*K), kvcache (n_layers, 2, B, T, Hkv*K), pos scalar or (B,)
    -> (B, G, Hkv*K) in q's dtype.

    f32 scores (scale applied after the dot, as the reference does), rows
    past ``pos[b]`` masked, f32 softmax, probabilities cast to the cache
    dtype for the PV product with f32 accumulation."""
    b, g, hk = q.shape
    t = kvcache.shape[3]
    kd = hk // n_kv_heads
    p = _pos_vector(pos, b, q.device).long()
    k = kvcache[layer, 0].reshape(b, t, n_kv_heads, kd).float()
    v = kvcache[layer, 1].reshape(b, t, n_kv_heads, kd)
    qh = q.reshape(b, g, n_kv_heads, kd).float()
    s = torch.einsum("bghk,bthk->bght", qh, k) * (1.0 / math.sqrt(kd))
    rows = torch.arange(t, device=q.device)
    s = s.masked_fill((rows[None, :] > p[:, None])[:, None, None, :],
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp(s - m)
    l = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bght,bthk->bghk", w.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    return o.reshape(b, g, hk).to(q.dtype)


def _check_cuda_args(q, kvcache, n_kv_heads, layer):
    if q.dim() != 3 or kvcache.dim() != 5:
        raise ValueError(
            f"flash_decode_attention needs q (B, G, Hkv*K) and kvcache "
            f"(n_layers, 2, B, T, Hkv*K), got {tuple(q.shape)}, "
            f"{tuple(kvcache.shape)}"
        )
    b, g, hk = q.shape
    nl, two, cb, _, chk = kvcache.shape
    if two != 2 or cb != b or chk != hk:
        raise ValueError(
            f"kvcache {tuple(kvcache.shape)} does not match q "
            f"{tuple(q.shape)}"
        )
    if hk % n_kv_heads or hk // n_kv_heads > _MAX_HEAD_DIM:
        raise ValueError(
            f"Hkv*K = {hk} with {n_kv_heads} KV heads: head_dim must divide "
            f"it and be <= {_MAX_HEAD_DIM}"
        )
    if not 0 <= layer < nl:
        raise ValueError(f"layer {layer} outside the {nl}-layer cache")
    if q.dtype != kvcache.dtype or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash_decode_attention takes f32 or bf16 q and cache of one "
            f"dtype, got {q.dtype}, {kvcache.dtype}"
        )
    if q.device != kvcache.device:
        raise ValueError("q and kvcache must be on the same device")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"flash_decode_attention launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), got tensors on {q.device}"
        )
    if not q.is_contiguous() or not kvcache.is_contiguous():
        raise ValueError("flash_decode_attention needs contiguous q and "
                         "kvcache")


def _kernel():
    lib = _build.library("flash_decode")
    fn = lib.dl4j_flash_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, kvcache, pos, n_kv_heads, layer):
    global launches
    _check_cuda_args(q, kvcache, n_kv_heads, layer)
    b, g, hk = q.shape
    kd = hk // n_kv_heads
    p = _pos_vector(pos, b, q.device)
    lib, fn = _kernel()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kvcache.data_ptr(), p.data_ptr(), out.data_ptr(),
             b, g, n_kv_heads, kd, kvcache.shape[3], layer,
             1.0 / math.sqrt(kd), _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_decode")
    launches += 1
    return out


def flash_decode_attention(q: torch.Tensor, kvcache: torch.Tensor, pos,
                           n_kv_heads: int, layer: int = 0) -> torch.Tensor:
    """One decode step of causal attention against the packed stacked
    cache (the reference's public layouts; see the module doc). ``pos`` is
    an int, a 0-d tensor, or a (B,) int tensor of per-row positions."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, kvcache, pos, n_kv_heads,
                                            layer)
    if q.device.type == "cuda":
        return _launch(q, kvcache, pos, n_kv_heads, layer)
    raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
