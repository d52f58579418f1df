"""Flash attention: the hand-written CUDA kernels of the forward
(``csrc/flash_attn_fwd.cu``) and of the backward (``csrc/flash_attn_bwd.cu``),
their plain PyTorch versions, and the ``autograd.Function`` that trains
through both.

The forward replaces ``_flash_fwd_stream_kernel``
(deeplearning4j_tpu/ops/pallas_kernels.py :125, called through
``_flash_fwd_call`` :179): bulk prefill calls it forward-only
(models/transformer.py:1133) and the training block under autograd (:482). The
backward replaces ``_flash_bwd_fused_kernel`` (:213, called through
``_flash_bwd_rule`` :358).

What bounds them on the H100, and what the design does: at the serving
shapes (B*H = 6, T <= 128, D = 128, bf16) one forward call moves well under
a megabyte and is bound by launch and latency. At the training shape (B*H =
144, T = 1024, D = 128) both are bound by the bf16 tensor-core rate. In bf16
at head dims 64 and 128 both kernels run every product on the tensor cores
(``wgmma``, f32 accumulators in registers) over tiles that TMA loads into a
shared-memory ring; f32 inputs and the other head dims take FMA bodies. The
choice is a static table on (dtype, D) in each source, which
:func:`fwd_body` / :func:`bwd_body` read back from the built library. Both
keep every intermediate on chip and skip tiles above the causal diagonal;
see the sources for the tile layouts.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from one to the other.

The plain versions build (BH, T, T) f32 tensors, 17 GB each at BH 4 and T
32,768. Their row-blocked forms (``flash_attention_fwd_plain_blocked``,
``flash_attention_bwd_plain_blocked``) take the query rows in blocks and
build no such tensor; ``chip_smoke.py`` holds the kernels to them at long
T. No path of the port calls them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import _build, _leaf
from deeplearning4j_tpu_torch.ops.attention import dtype_scalar

#: forward / backward kernel launches since the last reset (counted where
#: each kernel launches)
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, same signature and layouts:
    (BH, T, D) in, O (BH, T, D) in q's dtype and lse (BH, T, 1) f32 out.

    Rounds where the reference rounds: the Q tile is scaled in the input
    dtype (by the scale cast to that dtype), the scores and the softmax are
    f32, and the probabilities are cast to V's dtype for the PV product with
    f32 accumulation."""
    return _fwd_rows(q, k, v, causal, 0)


def _causal_mask(s: torch.Tensor, row0: int) -> torch.Tensor:
    """-inf where key j lies past query row ``row0 + i`` of the (..., rows,
    T) scores."""
    rows = torch.arange(row0, row0 + s.shape[-2], device=s.device)
    cols = torch.arange(s.shape[-1], device=s.device)
    return s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))


def _fwd_rows(q, k, v, causal: bool, row0: int):
    """The plain forward of query rows ``row0 ..`` (the rows of ``q``)
    against every row of k and v."""
    d = q.shape[-1]
    qs = (q * dtype_scalar(1.0 / math.sqrt(d), q.dtype)).float()
    s = qs @ k.float().transpose(-1, -2)
    if causal:
        s = _causal_mask(s, row0)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float()) / l.clamp_min(1e-30)
    lse = m + torch.log(l.clamp_min(1e-30))
    return o.to(q.dtype), lse


#: f32 elements of one (BH, rows, T) score block of the row-blocked plain
#: versions (1 GiB)
PLAIN_BLOCK_ELEMS = 1 << 28


def plain_block_rows(bh: int, t: int) -> int:
    """Query rows a block of the row-blocked plain versions takes: as many
    as keep a (BH, rows, T) f32 block within :data:`PLAIN_BLOCK_ELEMS`."""
    return max(1, min(t, PLAIN_BLOCK_ELEMS // (bh * t)))


def flash_attention_fwd_plain_blocked(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, causal: bool = True
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd_plain` over blocks of
    :func:`plain_block_rows` query rows, so no (BH, T, T) tensor is built:
    the plain version at long T (T 32,768 at BH 4 would need 17 GB a
    score tensor). Each block takes every key row, masked, so its PV
    product contracts over the same T rows as the whole one: a row's
    output and lse are bitwise the unblocked function's wherever the
    matmul's rows do not depend on how many rows it is given (true of the
    CPU's; on the card a library may pick another kernel by shape)."""
    bh, t, _ = q.shape
    step = plain_block_rows(bh, t)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q.device)
    for r0 in range(0, t, step):
        o[:, r0:r0 + step], lse[:, r0:r0 + step] = _fwd_rows(
            q[:, r0:r0 + step], k, v, causal, r0)
    return o, lse


def _check_cuda_args(what: str, **xs):
    """Raise on what the kernels do not take: tensors of one (BH, T, D)
    shape and one f32/bf16 dtype, contiguous and 16-byte aligned, on the
    current device, with a head dim the kernels are built for. The common
    case costs a few attribute reads: the serving prefill's call is bound
    by the host."""
    q = next(iter(xs.values()))
    shape, dtype, device = q.shape, q.dtype, q.device
    for x in xs.values():
        if x.shape != shape or x.dtype != dtype or x.device != device:
            _raise_mismatch(what, xs)
    if len(shape) != 3:
        raise ValueError(f"{what} needs {', '.join(xs)} of one (BH, T, D) "
                         f"shape, got {tuple(shape)}")
    if dtype not in _DTYPES:
        raise TypeError(f"{what} takes f32 or bf16 {', '.join(xs)} of one "
                        f"dtype, got {dtype}")
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), got tensors on {device}"
        )
    if shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {shape[-1]}")
    if shape[0] > 65535:
        raise ValueError(f"{what} kernel takes at most 65535 (batch x head) "
                         f"rows (the grid's y extent), got {shape[0]}")
    for name, x in xs.items():
        if not x.is_contiguous():
            raise ValueError(f"{what} needs contiguous {name}")
        # the tensor-core bodies load tiles by TMA, which takes 16-byte-
        # aligned bases only
        if x.data_ptr() % 16:
            raise ValueError(f"{what} needs a 16-byte-aligned {name}, got "
                             f"address {x.data_ptr():#x}")


def _raise_mismatch(what: str, xs: dict) -> None:
    shapes = {tuple(x.shape) for x in xs.values()}
    if len(shapes) != 1:
        raise ValueError(f"{what} needs {', '.join(xs)} of one (BH, T, D) "
                         f"shape, got {sorted(shapes)}")
    dtypes = {x.dtype for x in xs.values()}
    if len(dtypes) != 1:
        raise TypeError(f"{what} takes f32 or bf16 {', '.join(xs)} of one "
                        f"dtype, got {sorted(map(str, dtypes))}")
    raise ValueError(f"{', '.join(xs)} must be on the same device")


def _current_stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream on x's device, without building
    the Stream object ``torch.cuda.current_stream(dev).cuda_stream`` does:
    the serving prefill's call is bound by the host, not the kernel."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _kernel():
    lib = _build.library("flash_attn_fwd")
    fn = lib.dl4j_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


#: names of the bodies the C libraries' ``*_body`` queries return
_BODIES = ("fma", "wgmma")


def fwd_body(dtype: torch.dtype, d: int) -> str:
    """The body the forward kernel takes for this dtype and head dim
    (``dl4j_flash_attn_fwd_body``): "wgmma" (tensor cores) or "fma"."""
    fn = _build.library("flash_attn_fwd").dl4j_flash_attn_fwd_body
    return _BODIES[fn(_DTYPES[dtype], d)]


def _launch(q, k, v, causal):
    global launches
    _check_cuda_args("flash_attention_fwd", q=q, k=k, v=v)
    bh, t, d = q.shape
    lib, fn = _kernel()
    o = torch.empty_like(q)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q.device)
    stream = _current_stream(q)
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
    hook = _leaf.HOOK
    if hook is not None:
        return hook("flash_attn_fwd", flash_attention_fwd_plain, q, k, v,
                    causal)
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


# -- backward ------------------------------------------------------------------

def flash_attention_bwd_delta(o: torch.Tensor, do: torch.Tensor
                              ) -> torch.Tensor:
    """delta_i = <dO_i, O_i> in f32, (BH, T, 1): the softmax normalizer
    correction. A plain reduction, as the reference computes it outside its
    kernel (``_flash_bwd_rule`` :371)."""
    # bf16 x bf16 products are exact in f32, so promoting one side (do
    # computes in f32 against the f32 o) gives the same sums as casting both
    return (do * o.float()).sum(dim=-1, keepdim=True)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the backward kernel, same signature and layouts:
    q, k, v, O, dO (BH, T, D) and lse (BH, T, 1) f32 in; dQ, dK, dV (BH, T,
    D) in the inputs' dtype out.

    Rounds where the reference rounds: the Q tile is scaled in the input
    dtype, P is f32 and cast to the input dtype for the dV product, ds is the
    product of the cast P and the cast (dp - delta) taken in the input dtype,
    dK contracts ds with the scaled Q, dQ is scaled after its f32 sum, and
    each gradient is cast once."""
    delta = flash_attention_bwd_delta(o, do)
    dq, dk, dv = _bwd_rows(q, k, v, lse, do, delta, causal, 0)
    dt = q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _bwd_rows(q, k, v, lse, do, delta, causal: bool, row0: int):
    """The plain backward of query rows ``row0 ..`` (the rows of q, lse,
    do and delta) against every row of k and v: their dQ rows (f32, scaled)
    and their f32 parts of dK and dV."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * dtype_scalar(scale, dt)
    s = qs.float() @ k.float().transpose(-1, -2)
    if causal:
        s = _causal_mask(s, row0)
    p = torch.exp(s - lse).to(dt)
    dv = p.float().transpose(-1, -2) @ do.float()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta).to(dt)
    dk = ds.float().transpose(-1, -2) @ qs.float()
    dq = (ds.float() @ k.float()) * scale
    return dq, dk, dv


def flash_attention_bwd_plain_blocked(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, o: torch.Tensor,
                                      lse: torch.Tensor, do: torch.Tensor,
                                      causal: bool = True
                                      ) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """:func:`flash_attention_bwd_plain` over blocks of
    :func:`plain_block_rows` query rows: no (BH, T, T) tensor is built. Each
    block takes every key row, masked, so dQ is bitwise the unblocked
    function's wherever the matmul's rows do not depend on how many rows
    it is given (as the forward); dK and dV sum the blocks' f32 parts in
    block order, which only reassociates the unblocked sums."""
    bh, t, _ = q.shape
    step = plain_block_rows(bh, t)
    delta = flash_attention_bwd_delta(o, do)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for r0 in range(0, t, step):
        rows = slice(r0, r0 + step)
        dq_r, dk_r, dv_r = _bwd_rows(q[:, rows], k, v, lse[:, rows],
                                     do[:, rows], delta[:, rows], causal, r0)
        dq[:, rows] = dq_r
        dk += dk_r
        dv += dv_r
    return dq, dk.to(q.dtype), dv.to(q.dtype)


def _bwd_kernel():
    lib = _build.library("flash_attn_bwd")
    fn = lib.dl4j_flash_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def bwd_body(dtype: torch.dtype, d: int) -> str:
    """The bodies the backward kernel takes for this dtype and head dim
    (``dl4j_flash_attn_bwd_body``): "wgmma" (tensor cores) or "fma"."""
    fn = _build.library("flash_attn_bwd").dl4j_flash_attn_bwd_body
    return _BODIES[fn(_DTYPES[dtype], d)]


def _launch_bwd(q, k, v, o, lse, do, causal):
    global bwd_launches
    _check_cuda_args("flash_attention_bwd", q=q, k=k, v=v, o=o, do=do)
    bh, t, d = q.shape
    if (lse.shape != (bh, t, 1) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(
            f"flash_attention_bwd needs a contiguous f32 lse of shape "
            f"{(bh, t, 1)} on {q.device}, got {lse.dtype} "
            f"{tuple(lse.shape)} on {lse.device}")
    lib, fn = _bwd_kernel()
    delta = flash_attention_bwd_delta(o, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # the tensor-core bodies' dQ pass writes the scaled q here for their
    # dK/dV pass to stream
    qs = torch.empty_like(q) if bwd_body(q.dtype, d) == "wgmma" else None
    stream = _current_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), None if qs is None else qs.data_ptr(), bh, t, d,
             1.0 / math.sqrt(d), int(causal), _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attn_bwd")
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(BH, T, D) flash backward -> (dQ, dK, dV). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, o, lse, do, causal)
    raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")


# -- autograd ------------------------------------------------------------------

# The forward is also an operator of its own (``torch.ops.dl4j.flash_attn_fwd``)
# so a selective-checkpoint policy can name it and keep its outputs, as the
# reference's policy keeps the residuals it names "flash_out" / "flash_lse"
# (models/transformer.py:853): the backward then never reruns the forward.
_LIB = torch.library.Library("dl4j", "FRAGMENT")
_LIB.define("flash_attn_fwd(Tensor q, Tensor k, Tensor v, bool causal) "
            "-> (Tensor, Tensor)")
_LIB.impl("flash_attn_fwd",
          lambda q, k, v, causal: flash_attention_fwd(q, k, v, causal),
          "CompositeExplicitAutograd")


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable (BH, T, D) flash attention: the forward saves O and
    lse (as ``_flash_fwd_rule`` does), the backward is the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = torch.ops.dl4j.flash_attn_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              layout: str = "bthd") -> torch.Tensor:
    """Differentiable flash attention, the reference's
    ``flash_attention_trainable``: (B, T, H, D) in and out, or (B, H, T, D)
    with ``layout="bhtd"``. Memory is O(T): the backward recomputes the
    probabilities from the saved lse."""
    if layout == "bhtd":
        b, h, t, d = q.shape
        flat = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v)]
    elif layout == "bthd":
        b, t, h, d = q.shape
        # at B 1 the reshape of the transpose is a strided view, which the
        # kernels do not take
        flat = [x.transpose(1, 2).reshape(b * h, t, d).contiguous()
                for x in (q, k, v)]
    else:
        raise ValueError(f"layout must be 'bthd' or 'bhtd', got {layout!r}")
    o = FlashAttentionFn.apply(*flat, causal).reshape(b, h, t, d)
    return o if layout == "bhtd" else o.transpose(1, 2)
