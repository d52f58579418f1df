"""Fused embedding dot (kernel #5): the hand-written CUDA kernel
(``csrc/emb_dot.cu``) in its two modes, and their plain PyTorch versions.

Replaces ``_emb_dot_kernel`` (deeplearning4j_tpu/ops/pallas_kernels.py:906,
launched by ``fused_embedding_dot`` :918).

**Dense mode**, the reference's function: for h (B, D), w_rows (B, L, D)
and mask (B, L), all f32,

    f[b, l] = sigmoid(clip(<h[b], w_rows[b, l]>, -6, 6)) * mask[b, l]

Word2Vec's hierarchical-softmax step skips, and does not clip, pairs whose
raw dot is saturated (|dot| >= 6, the reference's exp-table range check,
models/word2vec.py:68-76); where the dot is in range the clip changes
nothing, but the flag itself cannot be recovered from f in f32, so
:func:`fused_embedding_dot_range` returns ``(f, in_range)`` (``in_range``
1.0 or 0.0, f32); :func:`fused_embedding_dot` returns f alone, as the
reference function does.

**Fused mode**, :func:`fused_hs_rows`, what the port's HS step calls: the
gathers of h and of the path rows from the merged table, the dense mode's
f and flag, g, grad_in and the g ⊗ h delta rows in one pass, written at
the positions ``dest`` gives (the sorted scatter's), so that the step
materializes neither the gathered rows nor the products.

What bounds it on the H100 and what the design does: see the note in
``csrc/emb_dot.cu`` (HBM bytes; a warp per batch row holding h in
registers, only the valid path rows loaded, several in flight, f32
throughout).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback between them. ``launches`` counts
the launches of both modes.
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


def fused_hs_rows_plain(S, v, inputs, codes, points, mask, lr, dest=None,
                        out=None) -> torch.Tensor:
    """Plain version of the fused mode: the (B + B*L, D) delta rows of one
    HS batch from the pre-batch table S, in the row order of the scatter's
    index list ``cat([inputs, (v + points).reshape(-1)])`` (grad_in first,
    then g ⊗ h per path entry; masked entries are zeros), or entry i at
    ``dest[i]``; into ``out`` when given. The operations of the port's HS
    step, in its order."""
    h = S[inputs]  # (B, D)
    w1 = S[v + points]  # (B, L, D)
    f, in_range = fused_embedding_dot_range_plain(h, w1, mask)
    g = (1.0 - codes - f) * lr * mask * in_range  # (B, L)
    grad_in = (g[:, :, None] * w1).sum(1)
    deltas = torch.cat([grad_in, (g[:, :, None] * h[:, None, :]).reshape(
        -1, S.shape[1])])
    if dest is None and out is None:
        return deltas
    if out is None:
        out = torch.empty_like(deltas)
    if dest is None:
        return out.copy_(deltas)
    return out.index_copy_(0, dest, deltas)


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


def _check_hs(S, inputs, codes, points, mask, dest, out) -> None:
    what = "fused_hs_rows"
    if dest is None:
        raise ValueError(f"{what} on the card needs dest (the scatter "
                         f"plan's positions): it writes only the kept "
                         f"entries")
    if S.dim() != 2 or inputs.dim() != 1 or points.dim() != 2:
        raise ValueError(f"{what} needs S (rows, D), inputs (B,), points "
                         f"(B, L), got {tuple(S.shape)}, "
                         f"{tuple(inputs.shape)}, {tuple(points.shape)}")
    b, L = points.shape
    n = b + b * L
    if inputs.shape[0] != b or tuple(codes.shape) != (b, L) or tuple(
            mask.shape) != (b, L):
        raise ValueError(f"{what}: shapes {tuple(inputs.shape)}, "
                         f"{tuple(codes.shape)}, {tuple(points.shape)}, "
                         f"{tuple(mask.shape)} do not match")
    if tuple(dest.shape) != (n,):
        raise ValueError(f"{what}: dest must be ({n},), got "
                         f"{tuple(dest.shape)}")
    if out is not None and tuple(out.shape) != (n, S.shape[1]):
        raise ValueError(f"{what}: out must be ({n}, {S.shape[1]}), got "
                         f"{tuple(out.shape)}")
    for x, dt in ((S, torch.float32), (codes, torch.float32),
                  (mask, torch.float32), (out, torch.float32),
                  (inputs, torch.int64), (points, torch.int64),
                  (dest, torch.int64)):
        if x is None:
            continue
        if x.dtype != dt:
            raise TypeError(f"{what} takes {dt} for this operand, got "
                            f"{x.dtype}")
        if x.device != S.device:
            raise ValueError(f"{what}: every operand must be on {S.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")
    if S.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), got tensors on {S.device}")


def _launch_hs(S, v, inputs, codes, points, mask, lr, dest, out):
    global launches
    _check_hs(S, inputs, codes, points, mask, dest, out)
    b, L = points.shape
    d = S.shape[1]
    if d == 0:
        raise ValueError("fused_hs_rows needs rows of width D > 0")
    if out is None:
        out = torch.empty((b + b * L, d), dtype=torch.float32,
                          device=S.device)
    if b == 0:
        return out
    lib = _build.library("emb_dot")
    fn = lib.dl4j_emb_dot_hs
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong] + [ctypes.c_void_p] * 5 + [
            ctypes.c_float, ctypes.c_void_p] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    vec = d % 4 == 0 and S.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(S.device).cuda_stream
    err = fn(S.data_ptr(), S.shape[0], int(v), inputs.data_ptr(),
             codes.data_ptr(), points.data_ptr(), mask.data_ptr(),
             dest.data_ptr(), float(lr), out.data_ptr(), b, L, d, int(vec),
             stream)
    _build.check(lib, err, "fused_hs_rows")
    launches += 1
    return out


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


def fused_hs_rows(S: torch.Tensor, v: int, inputs: torch.Tensor,
                  codes: torch.Tensor, points: torch.Tensor,
                  mask: torch.Tensor, lr: float,
                  dest: torch.Tensor | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel #5's fused mode: one HS batch's delta rows, (B + B*L, D) f32.

    S (rows, D) f32 is the merged table (read, not written); inputs (B,)
    and points (B, L) int64, with the syn1 rows at ``v + points``; codes
    and mask (B, L) f32; lr the f32 learning rate. Entry b of the result is
    grad_in[b] = sum_l g[b, l] * S[v + points[b, l]], entry B + b*L + l is
    g[b, l] * S[inputs[b]], with g = (1 - codes - f) * lr * mask * in_range
    and f, in_range as :func:`fused_embedding_dot_range` gives them for
    the gathered rows. With ``dest`` (int64 (B + B*L,), a permutation:
    the scatter plan's), entry i is written at row dest[i]; the card takes
    only that form and leaves the entries with mask 0 unwritten (the plan
    places them where its sums read nothing). The plain version also takes
    no ``dest`` (the list's own order) and holds masked entries as exact
    zeros. ``out`` is the buffer to write into (allocated when None). An
    input, a valid path row or a dest out of range makes the kernel trap
    (a sticky CUDA error, as PyTorch's device-side index assert)."""
    if S.device.type == "cpu":
        return fused_hs_rows_plain(S, v, inputs, codes, points, mask, lr,
                                   dest, out)
    if S.device.type == "cuda":
        return _launch_hs(S, v, inputs, codes, points, mask, lr, dest, out)
    raise ValueError(f"fused_hs_rows: unsupported device {S.device}")
