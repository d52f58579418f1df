"""The reference's random key stream (``jax.random`` with threefry2x32 keys
and partitionable counters), bit for bit, and the categorical draw on it:
the hand-written CUDA kernel (``csrc/sample.cu``) and its plain PyTorch
version.

A key is a pair of 32-bit words; tensors hold them in int64 (PyTorch has
no shifts on ``uint32``), and the threefry arithmetic masks every add and shift
back to 32 bits. One cipher serves both sides: every key chain that does
not depend on data (the serving engine's master key,
``transformer_generate``'s per-step keys, speculative decoding's five-way
splits) runs it on Python ints on the host (a key there is a pair of
ints) and is uploaded, so it costs no device sync; on tensors the same
function is the draw kernel's plain version.

The functions reproduce, under JAX's defaults (``threefry2x32`` keys,
``jax_threefry_partitionable=True``):

- :func:`key` — ``jax.random.key_data(jax.random.key(seed))``;
- :func:`split` — ``jax.random.split``: row i is threefry2x32 of the key
  over the counter (0, i), so ``split(k)[i] == fold_in(k, i)``;
- :func:`fold_in` — threefry2x32 of the key over (0, data);
- :func:`random_bits` / :func:`uniform` — 32-bit draws over
  ``iota_2x32_shape`` counters (the row-major flat index, high word
  ``index >> 32``), a draw being ``bits1 ^ bits2``; ``uniform`` as
  ``jax.random._uniform`` computes it;
- :func:`categorical` — ``jax.random.categorical``: the first index of the
  maximum of ``gumbel + logits``, ``gumbel = -log(-log(uniform(minval=tiny,
  maxval=1)))``, in two modes: per-row keys folded with a position (the
  serving engine's ``vmap(fold_in)(slot_keys, pos)`` then a (V,) draw a
  row, counter v) and one key over the whole (R, V) array (``generate``
  and speculative decoding, counter r * V + v).

Raw bits and uniforms are bitwise JAX's. The Gumbel noise is not: XLA's
``log`` and PyTorch's differ in the last bit or two (about 1e-6 absolute),
so tokens equal JAX's except where the perturbed logits' top two are that
close.

Dispatch (:func:`draw`): a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises; there is no fallback between them.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import upload
from deeplearning4j_tpu_torch.ops import _build

#: kernel launches since the last reset
launches = 0

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal number, the low end of the Gumbel uniforms
_TINY = float(np.finfo(np.float32).tiny)


def reset_launches() -> None:
    global launches
    launches = 0


# -- the cipher (int64 tensors holding 32-bit words) ---------------------------

def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under the
    key ``(k0, k1)``: int64 tensors holding 32-bit words that broadcast,
    or Python ints (every add and shift masked back to 32 bits). Returns
    ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in_rows(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``vmap(fold_in)(keys, data)``: keys (R, 2) int64 words, data (R,)
    integers -> (R, 2) int64 words."""
    d = data.long() & _M32
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits_rows(keys: torch.Tensor, n: int, offset=None
                     ) -> torch.Tensor:
    """(R, n) 32-bit draws in int64: row r under ``keys[r]`` over the
    counters ``offset[r] + j`` (``offset`` (R,) int64, default 0)."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    if offset is not None:
        idx = idx + offset[:, None]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], idx >> 32, idx & _M32)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms from int64-held 32-bit draws, as ``_uniform`` computes
    them: ``bits >> 9 | 0x3F800000`` viewed as f32, minus 1, times
    ``maxval - minval`` (in f32), plus ``minval``, at least ``minval``.
    XLA fuses the scale and shift into one multiply-add (one rounding);
    the product and sum of these f32 operands are exact in f64, so they
    are formed there and rounded once to f32. Over ``[0, 1)`` and the
    Gumbel draw's ``[tiny, 1)`` the product is exact in f32 as well, so
    the draw kernel's f32 arithmetic gives the same values."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    u = f.double() * float(hi - lo) + float(lo)
    return u.float().clamp_min(float(lo))


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` ("low" mode) from the draws: -log(-log(u)),
    u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform_from_bits(bits, _TINY, 1.0)))


# -- host key chains (the cipher on Python ints) -------------------------------

#: host key data: the two 32-bit words as Python ints
Key = tuple[int, int]


def as_key(k) -> Key:
    """A key argument as host key data: an int seed goes through
    :func:`key`; a pair of words (a tuple, an array or a tensor of shape
    (2,)) is taken as key data."""
    if isinstance(k, (int, np.integer)):
        return key(int(k))
    if isinstance(k, torch.Tensor):
        k = k.tolist()
    words = np.asarray(k)
    if words.shape != (2,):
        raise ValueError(f"a threefry key is 2 uint32 words, got shape "
                         f"{words.shape}")
    return (int(words[0]) & _M32, int(words[1]) & _M32)


def key(seed: int) -> Key:
    """``jax.random.key_data(jax.random.key(seed))`` with 64-bit types
    off, as the reference runs: ``(0, seed mod 2^32)`` for every seed in
    [-2^63, 2^63); ``OverflowError`` outside that range, as JAX raises."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} outside the int64 range a key "
                            f"takes")
    return (0, seed & _M32)


def split(k, n: int = 2) -> list[Key]:
    """``jax.random.split(k, n)`` as n keys: ``k, sub = split(k)`` takes
    row 0 as the new key and row 1 as ``sub``."""
    k0, k1 = as_key(k)
    return [threefry2x32(k0, k1, i >> 32, i & _M32) for i in range(n)]


def fold_in(k, data: int) -> Key:
    """``jax.random.fold_in(k, data)``: ``data`` in [0, 2^32);
    ``OverflowError`` outside it, as JAX raises with 64-bit types off."""
    k0, k1 = as_key(k)
    data = int(data)
    if not 0 <= data <= _M32:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    return threefry2x32(k0, k1, 0, data)


def random_bits(k, shape, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (32-bit, in int64): ``bits1 ^ bits2``
    over the row-major flat index as counter, computed on ``device`` (the
    CPU by default; integer math, the same bits anywhere). The key's words
    enter the cipher as host numbers, so a draw uploads nothing. With
    ``offset`` the counters start there: the draw is that stretch of a
    larger one (partitionable counters depend on the index alone)."""
    shape = ((int(shape),) if np.isscalar(shape)
             else tuple(int(s) for s in shape))
    k0, k1 = as_key(k)
    idx = torch.arange(int(offset), int(offset) + int(np.prod(
        shape, dtype=np.int64)), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(shape)


def uniform(k, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` on
    ``device`` (the CPU by default), bit for bit; ``offset`` as
    :func:`random_bits`'s."""
    return uniform_from_bits(random_bits(k, shape, device, offset), minval,
                             maxval)


def _row_keys(logits, keys, pos):
    """Per-row keys and counter offsets of the two modes."""
    r, v = logits.shape
    if pos is not None:
        return fold_in_rows(keys, pos), None
    rows = keys.reshape(1, 2).expand(r, 2)
    return rows, torch.arange(r, dtype=torch.int64,
                              device=logits.device) * v


def categorical_plain(logits: torch.Tensor, keys: torch.Tensor,
                      pos: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the draw kernel: ``(tokens (R,) int32, values (R,)
    f32)``, the first index of the maximum of ``gumbel + logits`` a row and
    that maximum (a -0.0 maximum as +0.0, as the kernel's ordered keys hold
    it). ``keys`` (R, 2) int64 words with ``pos`` (R,): row r draws under
    ``fold_in(keys[r], pos[r])`` over counters 0..V-1; ``keys`` (2,)
    without ``pos``: one key over the (R, V) array, counter r * V + v."""
    rk, offset = _row_keys(logits, keys, pos)
    pert = gumbel_from_bits(random_bits_rows(rk, logits.shape[1], offset))
    pert = pert + logits
    tok = pert.argmax(dim=-1)
    val = pert.gather(1, tok[:, None])[:, 0] + 0.0
    return tok.to(torch.int32), val


# -- CUDA ----------------------------------------------------------------------

def _check(logits, keys, pos) -> None:
    what = "threefry draw"
    if logits.dim() != 2:
        raise ValueError(f"{what} needs logits (R, V), got "
                         f"{tuple(logits.shape)}")
    r = logits.shape[0]
    want = (r, 2) if pos is not None else (2,)
    if tuple(keys.shape) != want:
        raise ValueError(f"{what}: keys must be {want}, got "
                         f"{tuple(keys.shape)}")
    if pos is not None and tuple(pos.shape) != (r,):
        raise ValueError(f"{what}: pos must be ({r},), got "
                         f"{tuple(pos.shape)}")
    for x, dt in ((logits, torch.float32), (keys, torch.int64),
                  (pos, torch.int32)):
        if x is None:
            continue
        if x.dtype != dt:
            raise TypeError(f"{what} takes {dt} for this operand, got "
                            f"{x.dtype}")
        if x.device != logits.device:
            raise ValueError(f"{what}: every operand must be on "
                             f"{logits.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")
    if logits.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), got tensors on "
            f"{logits.device}")


def chunks(v: int) -> int:
    """V-chunks a row is cut into (one block each): the C entry's rule."""
    return -(-v // 1024)


def _launch(logits, keys, pos):
    global launches
    _check(logits, keys, pos)
    r, v = logits.shape
    tok = torch.empty((r,), dtype=torch.int32, device=logits.device)
    val = torch.empty((r,), dtype=torch.float32, device=logits.device)
    if r == 0:
        return tok, val
    if v == 0:
        raise ValueError("threefry draw needs rows of width V > 0")
    part = torch.empty((r, chunks(v)), dtype=torch.int64,
                       device=logits.device)
    lib = _build.library("sample")
    fn = lib.dl4j_threefry_draw
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = fn(logits.data_ptr(), keys.data_ptr(),
             None if pos is None else pos.data_ptr(), part.data_ptr(),
             tok.data_ptr(), val.data_ptr(), r, v, stream)
    _build.check(lib, err, "threefry draw")
    launches += 1
    return tok, val


def draw(logits: torch.Tensor, keys: torch.Tensor,
         pos: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.categorical`` on the reference's key stream, with the
    winning perturbed value: see :func:`categorical_plain` for the modes.
    logits f32 (R, V) contiguous (already filtered and scaled by the
    caller), keys int64 words, pos int32."""
    if logits.device.type == "cpu":
        return categorical_plain(logits, keys, pos)
    if logits.device.type == "cuda":
        return _launch(logits, keys, pos)
    raise ValueError(f"threefry draw: unsupported device {logits.device}")


def categorical(logits: torch.Tensor, keys: torch.Tensor,
                pos: torch.Tensor | None = None) -> torch.Tensor:
    """The draw's tokens, (R,) int32."""
    return draw(logits, keys, pos)[0]


def device_keys(keys, device: torch.device) -> torch.Tensor:
    """Host key data (a key, or a sequence of keys) as int64 key words on
    ``device`` (pinned and non-blocking on CUDA)."""
    return upload(np.asarray(keys, dtype=np.int64), device)
