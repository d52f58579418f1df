"""Flash decode attention over the packed, stacked KV cache (kernel #3) and
over a block-paged pool (kernel #4): the hand-written CUDA kernels
(``csrc/flash_decode.cu``) and their plain PyTorch versions.

Replaces ``_flash_decode_kernel`` (deeplearning4j_tpu/ops/pallas_kernels.py
:502, launched by ``flash_decode_attention`` :645) in its bf16/f32 mode and
its int8 mode (``kv_scales``), and ``_paged_decode_kernel`` (:783, launched
by ``flash_decode_attention_paged`` :794) in both modes. The reference
calls the slab kernel from ``block_decode`` (models/transformer.py:1066) in
every decode substep of every layer; the port's paged decode step calls the
paged kernel the same way (the reference's own engine gathers a slab view
and runs the slab kernel instead).

What bounds them on the H100, and what the design does: HBM bytes. A call
must read the visible K and V rows of one layer (int8 mode: one byte an
element plus a 4-byte scale a row; paged: plus the table ints) at a few
operations per byte. Layer ``layer`` is read straight out of the stacked
buffer through strides (no slice copy), no row past ``pos[b]`` is touched,
and every block streams its rows through a ring of ``cp.async`` stages.
bf16/f32 mode splits each row's visible rows over a cluster of 8 blocks
per (batch row, KV head) (:func:`last_launch` reads a launch's grid and
cluster) and combines their partials through distributed shared memory;
int8 mode spreads each tile of
a batch row over a cluster of blocks that exchange the lane maxima, the
softmax-weight scale and the int32 P V sums the same way (its scale spans
every head and row of a tile). Split boundaries depend on ``pos[b]`` and
``block_t`` alone, so a row decodes bitwise the same at any batch size and
the paged kernel over a pool is bitwise the slab kernel over the gathered
slab.

int8 mode can take its two scales from outside (the slab kernel only):
``q_scales`` for each (group, KV head) lane and ``p_scales`` for each
(batch row, tile), both already divided by 127. A launch over some of a
row's heads (a mesh rank's, ``models/transformer._MeshDecode``) then
computes the whole row's function on its lanes: the caller takes the
q scale's maximum over the row's lanes, and the weight scale's from each
launch's maxima pass (:func:`flash_decode_int8_maxima`, the same body up to
each tile's max of p * vsc, K side only). Without them the function is
unchanged.

The tile is part of the function in int8 mode (one softmax-weight scale per
tile). Its default is the reference's (:func:`default_block_t`, a copy of
``pallas_kernels.py:682-712``): at GPT-2-small's width one tile over the
whole cache. Kernels and plain versions take any ``block_t`` that is a
positive multiple of 8 (the last tile may be short); in bf16/f32 mode it
changes nothing.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from deeplearning4j_tpu_torch.ops import _build, _leaf

#: launches since the last reset, counted where each kernel launches:
#: kernel #3 in bf16/f32 mode, kernel #3 in int8 mode (scales from outside
#: or not), its int8 maxima pass, kernel #4 (both modes)
launches = 0
int8_launches = 0
maxima_launches = 0
paged_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
#: int8 mode keeps the G x Hkv softmax lanes of a batch row in each block
_MAX_INT8_LANES = 64


def reset_launches() -> None:
    global launches, int8_launches, maxima_launches, paged_launches
    launches = int8_launches = maxima_launches = paged_launches = 0


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar position broadcast to every row, or the per-row (B,)
    vector, as int32 on ``device``."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        if p.dim() == 0:
            p = p.expand(b)
        return p.contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def default_block_t(t: int, hk: int, itemsize: int) -> int:
    """The reference's default decode tile (pallas_kernels.py:682-712): as
    few tiles as its VMEM budget allows, at most 14 MiB / (hk * eff_bytes *
    4) rows (eff_bytes 3 for an int8 cache, else the item size), then the
    smallest tile count that divides T into 8-aligned tiles. ``t`` is the
    logical cache length (``bps * bs`` for a block pool)."""
    if t <= 0 or t % 8:
        raise ValueError(f"cache T must be a positive multiple of 8, got {t}")
    eff_bytes = 3 if itemsize == 1 else itemsize
    cap = max(8, (14 * 1024 * 1024) // (hk * eff_bytes * 4))
    n_t = -(-t // cap)
    while t % n_t or (t // n_t) % 8:
        n_t += 1
    return t // n_t


def _tile(block_t, store: torch.Tensor, t: int, int8: bool) -> int:
    """The int8 tile: ``block_t``, or the reference's default for this
    cache (logical length ``t``); a given ``block_t`` is checked in both
    modes."""
    if block_t is not None:
        bt = int(block_t)
        if bt <= 0 or bt % 8:
            raise ValueError(f"block_t must be a positive multiple of 8, "
                             f"got {block_t}")
        return bt
    if not int8:
        return 0  # the bf16/f32 function has no tile
    return default_block_t(t, store.shape[-1], store.element_size())


def _quant8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to +-127 (the values, kept in x's
    float dtype)."""
    return torch.clamp(torch.round(x), -127, 127)


#: the divisor 127 as a 0-d tensor on each device
_N127: dict = {}


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 rounded as one IEEE division, on every device. On CUDA,
    PyTorch divides by a Python number (or a CPU scalar) by multiplying
    with its reciprocal, which is off in the last bit for some x; the
    scales then quantize q and the softmax weights differently from the
    kernel (and the reference). The divisor is made once a device (not
    kept when made inside a CUDA graph's capture, where its fill only
    runs on replay)."""
    n = _N127.get(x.device)
    if n is None:
        n = torch.full((), 127.0, device=x.device)
        if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            _N127[x.device] = n
    return x / n


def _plain_int8(q, kv8, scales, p, n_kv_heads: int, layer: int,
                block_t: int, q_scales=None, p_scales=None,
                maxima: bool = False) -> torch.Tensor:
    """The reference's quantized arithmetic (pallas_kernels.py:576-642),
    tile by tile. Integer dot products are exact (summed in f64, cast to
    f32 as the reference casts its int32 sums). ``q_scales`` (B, G, Hkv)
    and ``p_scales`` (B, n_t) replace the two scales; ``maxima`` returns
    each tile's max of p * vsc (B, n_t) instead of the output."""
    b, g, hk = q.shape
    t = kv8.shape[3]
    kd = hk // n_kv_heads
    scale = torch.tensor(1.0 / math.sqrt(kd), dtype=torch.float32)
    qf = q.float().reshape(b, g, n_kv_heads, kd)
    if q_scales is None:
        # one q scale per group over ALL heads
        q_scales = _div127(qf.abs().amax((2, 3)).clamp_min(1e-8))[
            ..., None].expand(b, g, n_kv_heads)
    qsc = q_scales[..., None]  # (B, G, Hkv, 1)
    qi = _quant8(qf / qsc).double()
    k8 = kv8[layer, 0].reshape(b, t, n_kv_heads, kd)
    v8 = kv8[layer, 1].reshape(b, t, n_kv_heads, kd)
    ksc = scales[layer, 0, :, :, 0] * scale  # (B, T): ksc * scale
    vsc = scales[layer, 1, :, :, 0]
    m = torch.full((b, g, n_kv_heads), float("-inf"), device=q.device)
    l = torch.zeros((b, g, n_kv_heads), device=q.device)
    acc = torch.zeros((b, g, n_kv_heads, kd), device=q.device)
    rows = torch.arange(t, device=q.device)
    tile_max = []
    for t0 in range(0, t, block_t):
        t1 = min(t0 + block_t, t)
        dots = torch.einsum("bghk,bthk->bght", qi,
                            k8[:, t0:t1].double()).float()
        s = dots * ksc[:, None, None, t0:t1] * qsc
        s = s.masked_fill((rows[t0:t1][None] > p[:, None])[:, None, None],
                          float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = corr * l + pr.sum(-1)
        # one softmax-weight scale per (batch row, tile) over every row
        # and every (g, h) lane
        pv = pr * vsc[:, None, None, t0:t1]
        # tiles past pos[b] are never read
        live = (t0 <= p)[:, None, None]
        pmax = pv.amax(dim=(1, 2, 3))
        if maxima:
            tile_max.append(pmax)
            m = torch.where(live, m_new, m)
            continue
        if p_scales is None:
            psc = _div127(pmax.clamp_min(1e-30))
        else:
            psc = p_scales[:, t0 // block_t]
        psc = psc[:, None, None, None]
        p8 = _quant8(pv / psc)
        o = torch.einsum("bght,bthk->bghk", p8.double(),
                         v8[:, t0:t1].double()).float()
        acc_new = acc * corr[..., None] + o * psc
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    if maxima:
        return torch.stack(tile_max, 1)
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.reshape(b, g, hk).to(q.dtype)


def flash_decode_attention_plain(q: torch.Tensor, kvcache: torch.Tensor,
                                 pos, n_kv_heads: int, layer: int = 0,
                                 block_t: int | None = None,
                                 kv_scales: torch.Tensor | None = None,
                                 q_scales: torch.Tensor | None = None,
                                 p_scales: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain version of kernel #3, same signature and layouts: q
    (B, G, Hkv*K), kvcache (n_layers, 2, B, T, Hkv*K), pos scalar or (B,)
    -> (B, G, Hkv*K) in q's dtype.

    bf16/f32 mode: f32 scores (scale applied after the dot, as the
    reference does), rows past ``pos[b]`` masked, f32 softmax against the
    row max, probabilities cast to the cache dtype for the PV product with
    f32 accumulation (``block_t`` changes nothing here). int8 mode
    (``kv_scales`` (n_layers, 2, B, T, 1) f32 beside an int8 cache): the
    reference's quantized online softmax over ``block_t``-row tiles, by
    default :func:`default_block_t` of this cache, under the scales from
    outside where given (``q_scales`` (B, G, Hkv), ``p_scales`` (B, n_t)
    f32, already divided by 127)."""
    b, g, hk = q.shape
    t = kvcache.shape[3]
    kd = hk // n_kv_heads
    bt = _tile(block_t, kvcache, t, kv_scales is not None)
    p = _pos_vector(pos, b, q.device).long()
    if kv_scales is not None:
        return _plain_int8(q, kvcache, kv_scales, p, n_kv_heads, layer, bt,
                           q_scales, p_scales)
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


def flash_decode_int8_maxima_plain(q: torch.Tensor, kvcache: torch.Tensor,
                                   pos, n_kv_heads: int, layer: int,
                                   block_t: int | None,
                                   kv_scales: torch.Tensor,
                                   q_scales: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """Plain version of int8 mode's maxima pass: :func:`_plain_int8` up to
    each tile's p * vsc, then its max over the tile's rows and every (g, h)
    lane -> (B, n_t) f32 (0 for a tile past pos[b])."""
    b = q.shape[0]
    bt = _tile(block_t, kvcache, kvcache.shape[3], True)
    p = _pos_vector(pos, b, q.device).long()
    return _plain_int8(q, kvcache, kv_scales, p, n_kv_heads, layer, bt,
                       q_scales, maxima=True)


def _gather_rows(x: torch.Tensor, tables: torch.Tensor, layer: int):
    """Layer ``layer`` of a block pool (n_layers, 2, n_blocks, bs, W) as the
    contiguous (1, 2, B, bps*bs, W) slab its (B, bps) tables name."""
    b, bps = tables.shape
    v = x[layer][:, tables.reshape(-1).long()]
    return v.reshape(1, 2, b, bps * x.shape[3], x.shape[4])


def flash_decode_attention_paged_plain(
    q: torch.Tensor, blocks: torch.Tensor, tables: torch.Tensor, pos,
    n_kv_heads: int, layer: int = 0, block_t: int | None = None,
    block_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of kernel #4: gather the rows the tables name (row t
    of batch row b is ``blocks[layer, :, tables[b, t // bs], t % bs]``) and
    run :func:`flash_decode_attention_plain` on that slab, so it is bitwise
    the slab plain version over the gathered cache."""
    kv = _gather_rows(blocks, tables, layer)
    sc = (None if block_scales is None
          else _gather_rows(block_scales, tables, layer))
    return flash_decode_attention_plain(q, kv, pos, n_kv_heads, 0, block_t,
                                        sc)


# -- CUDA ----------------------------------------------------------------------

def _check_common(q, n_kv_heads: int, kv_scales, what: str):
    if q.dim() != 3:
        raise ValueError(f"{what} needs q (B, G, Hkv*K), got "
                         f"{tuple(q.shape)}")
    b, g, hk = q.shape
    if hk % n_kv_heads or hk // n_kv_heads > _MAX_HEAD_DIM:
        raise ValueError(
            f"Hkv*K = {hk} with {n_kv_heads} KV heads: head_dim must divide "
            f"it and be <= {_MAX_HEAD_DIM}"
        )
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what} takes f32 or bf16 q, got {q.dtype}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), got tensors on {q.device}"
        )
    if kv_scales is not None and ((hk // n_kv_heads) % 4
                                  or g * n_kv_heads > _MAX_INT8_LANES):
        raise ValueError(
            f"{what} int8 mode needs head_dim % 4 == 0 and G * Hkv <= "
            f"{_MAX_INT8_LANES}, got head_dim {hk // n_kv_heads}, "
            f"G * Hkv {g * n_kv_heads}"
        )


def _check_store(q, store, scales, what: str) -> None:
    """The cache or block pool (n_layers, 2, N, R, Hkv*K), and its scale
    planes (n_layers, 2, N, R, 1) f32 in int8 mode."""
    if store.dim() != 5 or store.shape[1] != 2 or store.shape[4] != q.shape[2]:
        raise ValueError(f"{what}: cache {tuple(store.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if scales is None:
        if store.dtype != q.dtype:
            raise TypeError(f"{what} takes q and cache of one dtype, got "
                            f"{q.dtype}, {store.dtype}")
    else:
        if store.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError(f"{what} int8 mode takes an int8 cache and f32 "
                            f"scales, got {store.dtype}, {scales.dtype}")
        if tuple(scales.shape) != tuple(store.shape[:4]) + (1,):
            raise ValueError(f"{what}: scales {tuple(scales.shape)} do not "
                             f"match the cache {tuple(store.shape)}")
    for x in (store,) + (() if scales is None else (scales,)):
        if x.device != q.device:
            raise ValueError(f"{what}: every operand must be on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")
    if not q.is_contiguous():
        raise ValueError(f"{what} needs a contiguous q")


def _check_outside(q, store, n_kv_heads: int, block_t, kv_scales, q_scales,
                   p_scales, what: str) -> None:
    """The scales from outside: int8 mode only; q_scales (B, G, Hkv) and
    p_scales (B, n_t) f32, contiguous, on q's device."""
    if q_scales is None and p_scales is None:
        return
    if kv_scales is None:
        raise ValueError(f"{what}: scales from outside need int8 mode "
                         f"(kv_scales)")
    b, g, _ = q.shape
    t = store.shape[3]
    n_t = -(-t // _tile(block_t, store, t, True))
    for name, x, shape in (("q_scales", q_scales, (b, g, n_kv_heads)),
                           ("p_scales", p_scales, (b, n_t))):
        if x is None:
            continue
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{what} needs {name} {shape} contiguous f32 on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")


def _kernel(name: str, n_ptrs: int, n_ints: int, n_flags: int = 2):
    """The library's entry ``name``: pointers, ints, the f32 scale, then
    ``n_flags`` ints (dtype, and the int8 switch) and the stream."""
    lib = _build.library("flash_decode")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] + [ctypes.c_int] * n_flags
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def last_launch() -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """(grid, cluster) of this thread's last launch of either decode
    kernel, as the library passed them to ``cudaLaunchKernelEx``."""
    fn = _build.library("flash_decode").dl4j_flash_decode_last_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    dims = (ctypes.c_int * 6)()
    fn(dims)
    return tuple(dims[:3]), tuple(dims[3:])


@functools.lru_cache(maxsize=64)
def _needs_scratch(g: int, n_kv_heads: int, block_t: int, t: int) -> bool:
    """Whether int8 mode keeps a tile's scores in the wrapper's scratch
    tensor (the rows a block takes do not fit in its shared memory)."""
    need = _build.library("flash_decode").dl4j_flash_decode_int8_scratch
    need.argtypes, need.restype = [ctypes.c_int] * 4, ctypes.c_int
    return bool(need(g, n_kv_heads, block_t, t))


def _scratch(q, n_kv_heads: int, t: int, block_t: int, int8: bool, store):
    """int8 mode's score scratch, (B, T, G*Hkv + 1) f32, where the scores of
    a block's rows do not fit in shared memory (the kernel allocates
    nothing); an int8 store must start 4-byte aligned."""
    if not int8:
        return None
    if store.data_ptr() % 4:
        raise ValueError("the int8 cache must start 4-byte aligned")
    b, g, _ = q.shape
    if not _needs_scratch(g, n_kv_heads, block_t, t):
        return None
    return torch.empty((b, t, g * n_kv_heads + 1), dtype=torch.float32,
                       device=q.device)


def _check_slab(q, kvcache, n_kv_heads, layer, kv_scales, what: str) -> None:
    _check_common(q, n_kv_heads, kv_scales, what)
    _check_store(q, kvcache, kv_scales, what)
    if kvcache.shape[2] != q.shape[0]:
        raise ValueError(f"{what}: cache batch {kvcache.shape[2]} != q batch "
                         f"{q.shape[0]}")
    if not 0 <= layer < kvcache.shape[0]:
        raise ValueError(f"layer {layer} outside the {kvcache.shape[0]}-layer "
                         f"cache")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(q, kvcache, pos, n_kv_heads, layer, block_t=None,
            kv_scales=None, q_scales=None, p_scales=None):
    global launches, int8_launches
    what = "flash_decode_attention"
    _check_slab(q, kvcache, n_kv_heads, layer, kv_scales, what)
    b, g, hk = q.shape
    int8 = kv_scales is not None
    t = kvcache.shape[3]
    bt = _tile(block_t, kvcache, t, int8)
    lib, fn = _kernel("dl4j_flash_decode", 8, 7)
    kd = hk // n_kv_heads
    p = _pos_vector(pos, b, q.device)
    scr = _scratch(q, n_kv_heads, t, bt, int8, kvcache)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kvcache.data_ptr(), _ptr(kv_scales), p.data_ptr(),
             _ptr(scr), out.data_ptr(), _ptr(q_scales), _ptr(p_scales), b, g,
             n_kv_heads, kd, t, layer, bt, 1.0 / math.sqrt(kd),
             _DTYPES[q.dtype], int(int8), stream)
    _build.check(lib, err, what)
    if int8:
        int8_launches += 1
    else:
        launches += 1
    return out


def _launch_maxima(q, kvcache, pos, n_kv_heads, layer, block_t, kv_scales,
                   q_scales=None):
    global maxima_launches
    what = "flash_decode_int8_maxima"
    _check_slab(q, kvcache, n_kv_heads, layer, kv_scales, what)
    b, g, hk = q.shape
    t = kvcache.shape[3]
    bt = _tile(block_t, kvcache, t, True)
    lib, fn = _kernel("dl4j_flash_decode_int8_maxima", 7, 7, n_flags=1)
    kd = hk // n_kv_heads
    p = _pos_vector(pos, b, q.device)
    scr = _scratch(q, n_kv_heads, t, bt, True, kvcache)
    out = torch.empty((b, -(-t // bt)), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kvcache.data_ptr(), kv_scales.data_ptr(),
             p.data_ptr(), _ptr(scr), out.data_ptr(), _ptr(q_scales), b, g,
             n_kv_heads, kd, t, layer, bt, 1.0 / math.sqrt(kd),
             _DTYPES[q.dtype], stream)
    _build.check(lib, err, what)
    maxima_launches += 1
    return out


def _launch_paged(q, blocks, tables, pos, n_kv_heads, layer, block_t=None,
                  block_scales=None):
    global paged_launches
    what = "flash_decode_attention_paged"
    _check_common(q, n_kv_heads, block_scales, what)
    _check_store(q, blocks, block_scales, what)
    b, g, hk = q.shape
    if (tables.dim() != 2 or tables.shape[0] != b
            or tables.dtype != torch.int32 or tables.device != q.device
            or not tables.is_contiguous()):
        raise ValueError(f"{what} needs contiguous int32 tables (B, bps) on "
                         f"{q.device}, got {tuple(tables.shape)} "
                         f"{tables.dtype} on {tables.device}")
    if not 0 <= layer < blocks.shape[0]:
        raise ValueError(f"layer {layer} outside the {blocks.shape[0]}-layer "
                         f"pool")
    int8 = block_scales is not None
    t = tables.shape[1] * blocks.shape[3]  # the logical T of every row
    bt = _tile(block_t, blocks, t, int8)
    lib, fn = _kernel("dl4j_flash_decode_paged", 7, 9)
    kd = hk // n_kv_heads
    p = _pos_vector(pos, b, q.device)
    scr = _scratch(q, n_kv_heads, t, bt, int8, blocks)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), blocks.data_ptr(), _ptr(block_scales),
             tables.data_ptr(), p.data_ptr(), _ptr(scr), out.data_ptr(),
             b, g, n_kv_heads, kd, blocks.shape[2], blocks.shape[3],
             tables.shape[1], layer, bt, 1.0 / math.sqrt(kd),
             _DTYPES[q.dtype], int(int8), stream)
    _build.check(lib, err, what)
    paged_launches += 1
    return out


def flash_decode_attention(q: torch.Tensor, kvcache: torch.Tensor, pos,
                           n_kv_heads: int, layer: int = 0,
                           block_t: int | None = None,
                           kv_scales: torch.Tensor | None = None,
                           q_scales: torch.Tensor | None = None,
                           p_scales: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """One decode step of causal attention against the packed stacked
    cache (the reference's public layouts; see the module doc). ``pos`` is
    an int, a 0-d tensor, or a (B,) int tensor of per-row positions;
    ``kv_scales`` selects int8 mode, which takes the q scales (B, G, Hkv)
    and the weight scales (B, n_t) from outside where given."""
    args = (q, kvcache, pos, n_kv_heads, layer, block_t, kv_scales,
            q_scales, p_scales)
    _check_outside(q, kvcache, n_kv_heads, block_t, kv_scales, q_scales,
                   p_scales, "flash_decode_attention")
    hook = _leaf.HOOK
    if hook is not None:
        return hook("flash_decode", flash_decode_attention_plain, *args)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(*args)
    if q.device.type == "cuda":
        return _launch(*args)
    raise ValueError(f"flash_decode_attention: unsupported device {q.device}")


def flash_decode_int8_maxima(q: torch.Tensor, kvcache: torch.Tensor, pos,
                             n_kv_heads: int, layer: int,
                             block_t: int | None, kv_scales: torch.Tensor,
                             q_scales: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """int8 mode's maxima pass over the same operands as
    :func:`flash_decode_attention` (``q_scales`` from outside where given):
    (B, n_t) f32, each tile's max of p * vsc over this launch's rows and
    lanes, before the clamp and the division by 127 (0 for a tile past
    pos[b])."""
    what = "flash_decode_int8_maxima"
    if kv_scales is None:
        raise ValueError(f"{what} needs kv_scales (int8 mode)")
    _check_outside(q, kvcache, n_kv_heads, block_t, kv_scales, q_scales,
                   None, what)
    args = (q, kvcache, pos, n_kv_heads, layer, block_t, kv_scales, q_scales)
    if q.device.type == "cpu":
        return flash_decode_int8_maxima_plain(*args)
    if q.device.type == "cuda":
        return _launch_maxima(*args)
    raise ValueError(f"{what}: unsupported device {q.device}")


def flash_decode_attention_paged(q: torch.Tensor, blocks: torch.Tensor,
                                 tables: torch.Tensor, pos, n_kv_heads: int,
                                 layer: int = 0, block_t: int | None = None,
                                 block_scales: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """One decode step against a block-paged pool: ``blocks`` (n_layers, 2,
    n_blocks, bs, Hkv*K), ``tables`` (B, T/bs) int32 block ids (0 is the
    all-zero sentinel), ``block_scales`` (n_layers, 2, n_blocks, bs, 1) f32
    in int8 mode. The same function as :func:`flash_decode_attention` over
    the gathered slab."""
    hook = _leaf.HOOK
    if hook is not None:
        return hook("flash_decode_paged", flash_decode_attention_paged_plain,
                    q, blocks, tables, pos, n_kv_heads, layer, block_t,
                    block_scales)
    if q.device.type == "cpu":
        return flash_decode_attention_paged_plain(
            q, blocks, tables, pos, n_kv_heads, layer, block_t, block_scales)
    if q.device.type == "cuda":
        return _launch_paged(q, blocks, tables, pos, n_kv_heads, layer,
                             block_t, block_scales)
    raise ValueError(
        f"flash_decode_attention_paged: unsupported device {q.device}")
