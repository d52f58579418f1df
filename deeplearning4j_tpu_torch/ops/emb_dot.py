"""Fused embedding dot (kernel #5): the hand-written CUDA kernel
(``csrc/emb_dot.cu``) and its plain PyTorch version.

Replaces ``_emb_dot_kernel`` (deeplearning4j_tpu/ops/pallas_kernels.py:906,
launched by ``fused_embedding_dot`` :918): for h (B, D), w_rows (B, L, D)
and mask (B, L), all f32,

    f[b, l] = sigmoid(clip(<h[b], w_rows[b, l]>, -6, 6)) * mask[b, l]

the read side of Word2Vec's hierarchical-softmax step. That step skips, and
does not clip, pairs whose raw dot is saturated (|dot| >= 6, the reference's
exp-table range check, models/word2vec.py:68-76); where the dot is in range
the clip changes nothing, so the step's gradient is unchanged, but the flag
itself cannot be recovered from f in f32. The kernel therefore writes it in
the same pass: :func:`fused_embedding_dot_range` returns ``(f, in_range)``
(``in_range`` 1.0 or 0.0, f32) and is what the port's HS step calls;
:func:`fused_embedding_dot` returns f alone, as the reference function does.

What bounds it on the H100 and what the design does: see the note in
``csrc/emb_dot.cu`` (HBM bytes; one warp per (b, l) row, float4 loads, f32
throughout).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import _build

#: kernel launches since the last reset
launches = 0

#: the reference's exp-table domain: sigmoid inputs are clipped to it
MAX_EXP = 6.0


def reset_launches() -> None:
    global launches
    launches = 0


def fused_embedding_dot_range_plain(
    h: torch.Tensor, w_rows: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel #5 and its range flag: (f, in_range), both
    (B, L) in h's dtype. The dot is an elementwise product summed over D
    (never a TF32 matrix product)."""
    dot = (h[:, None, :] * w_rows).sum(-1)
    f = torch.sigmoid(dot.clamp(-MAX_EXP, MAX_EXP)) * mask
    return f, (dot.abs() < MAX_EXP).to(dot.dtype)


def fused_embedding_dot_plain(h, w_rows, mask) -> torch.Tensor:
    return fused_embedding_dot_range_plain(h, w_rows, mask)[0]


# -- CUDA ----------------------------------------------------------------------

def _check(h, w_rows, mask) -> None:
    what = "fused_embedding_dot"
    if h.dim() != 2 or w_rows.dim() != 3 or mask.dim() != 2:
        raise ValueError(f"{what} needs h (B, D), w_rows (B, L, D), mask "
                         f"(B, L), got {tuple(h.shape)}, "
                         f"{tuple(w_rows.shape)}, {tuple(mask.shape)}")
    b, d = h.shape
    if w_rows.shape[0] != b or w_rows.shape[2] != d or tuple(
            mask.shape) != tuple(w_rows.shape[:2]):
        raise ValueError(f"{what}: shapes {tuple(h.shape)}, "
                         f"{tuple(w_rows.shape)}, {tuple(mask.shape)} do not "
                         f"match")
    for x in (h, w_rows, mask):
        if x.dtype != torch.float32:
            raise TypeError(f"{what} takes f32 operands, got {x.dtype}")
        if x.device != h.device:
            raise ValueError(f"{what}: every operand must be on {h.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")
    if h.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), got tensors on {h.device}")


def _launch(h, w_rows, mask):
    global launches
    _check(h, w_rows, mask)
    b, L, d = w_rows.shape
    if d == 0:
        raise ValueError("fused_embedding_dot needs rows of width D > 0")
    f = torch.empty((b, L), dtype=torch.float32, device=h.device)
    in_range = torch.empty_like(f)
    if f.numel() == 0:  # an empty batch, or a one-word vocabulary's empty path
        return f, in_range
    lib = _build.library("emb_dot")
    fn = lib.dl4j_emb_dot
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    vec = d % 4 == 0 and h.data_ptr() % 16 == 0 and w_rows.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), w_rows.data_ptr(), mask.data_ptr(), f.data_ptr(),
             in_range.data_ptr(), b, L, d, int(vec), stream)
    _build.check(lib, err, "fused_embedding_dot")
    launches += 1
    return f, in_range


def fused_embedding_dot_range(
    h: torch.Tensor, w_rows: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel #5 and the range flag of its raw dot, (B, L) each."""
    if h.device.type == "cpu":
        return fused_embedding_dot_range_plain(h, w_rows, mask)
    if h.device.type == "cuda":
        return _launch(h, w_rows, mask)
    raise ValueError(f"fused_embedding_dot: unsupported device {h.device}")


def fused_embedding_dot(
    h: torch.Tensor, w_rows: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """sigmoid(clip(<h_b, w_{b,l}>, +-6)) * mask — (B, D), (B, L, D),
    (B, L) -> (B, L), the reference's function."""
    return fused_embedding_dot_range(h, w_rows, mask)[0]
