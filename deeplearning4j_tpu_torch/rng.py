"""PRNG-key discipline (the reference's ``rng.py``) on the port's threefry
(``ops/threefry.py``), so a seed means the reference's draws.

A key is host key data, a pair of 32-bit words as Python ints: splitting
and folding run the cipher on the host and cost the device nothing. The
draws (:func:`uniform`, :func:`bernoulli`, :func:`normal`) run the cipher
over the counters on the tensor's device and reproduce ``jax.random``'s:

- ``uniform`` is bitwise ``jax.random.uniform`` (f32) as XLA computes it
  on the CPU (``threefry.uniform``: the key's words enter the cipher as
  host numbers, so a draw uploads nothing and does not sync the card);
- ``bernoulli(k, p)`` is ``uniform(k, shape) < p``, as JAX draws it: the
  same samples wherever ``p`` is the same f32 value (a ``p`` computed on
  both sides may differ by an ulp, and so flip a draw within an ulp of it);
- ``normal`` is ``sqrt(2) * erf_inv(u)`` over JAX's uniform on
  ``(nextafter(-1, 0), 1)``, with XLA's f32 ``erf_inv`` (M. Giles' single
  precision polynomial, its multiply-adds fused): the uniforms are bitwise
  JAX's; the one step computed otherwise, ``log1p``, leaves about 1% of the
  values off XLA's by 1-3 ulps (``torch.erfinv`` would leave over half of
  them off, by up to ~90 ulps).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import threefry

Key = threefry.Key

_SQRT2 = float(np.float32(np.sqrt(2)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


class KeyStream:
    """A stateful host-side supply of fresh keys from one seed (or key)."""

    def __init__(self, seed=0):
        self._key = threefry.as_key(seed)

    def next(self) -> Key:
        self._key, sub = threefry.split(self._key)
        return sub

    def next_n(self, n: int) -> list[Key]:
        self._key, *subs = threefry.split(self._key, n + 1)
        return subs

    def __call__(self) -> Key:
        return self.next()


def key_for(seed: int) -> Key:
    """``jax.random.key(seed)``'s key data."""
    return threefry.key(seed)


def split(key, n: int = 2) -> list[Key]:
    return threefry.split(key, n)


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if np.isscalar(shape) else tuple(int(s) for s in shape)


#: ``rows``: (first row, rows of the whole batch) while a data rank
#: computes its share of a batch (:func:`batch_rows`), per thread: the data
#: ranks of a lock-step step run in threads of their own
_state = threading.local()


@contextlib.contextmanager
def batch_rows(first: int, total: int) -> Iterator[None]:
    """Inside the block, a draw over a batch (``batch=True``: its leading
    axis the batch's rows) gives rows ``first..`` of the same draw over the
    whole batch of ``total`` rows: the share of one whole-batch draw (a
    dropout mask, a sample) that a data rank holding those rows takes, as
    the reference draws it over the batch sharded across its mesh. The
    setting is the calling thread's."""
    prev = getattr(_state, "rows", None)
    _state.rows = (int(first), int(total))
    try:
        yield
    finally:
        _state.rows = prev


def _offset(shape, batch: bool) -> int:
    """The counter offset of a draw over ``shape``: its rows' place in the
    whole batch's draw under :func:`batch_rows`, else 0."""
    rows = getattr(_state, "rows", None)
    if not batch or rows is None:
        return 0
    first, total = rows
    if first + shape[0] > total:
        raise ValueError(f"rows {first}..{first + shape[0]} of a draw over "
                         f"a batch of {total}")
    return first * int(np.prod(shape[1:], dtype=np.int64))


def random_bits(key, shape, device=None, batch: bool = False) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit words in int64) on
    ``device`` (``threefry.random_bits``); ``batch`` as in
    :func:`batch_rows`."""
    shape = _shape(shape)
    return threefry.random_bits(key, shape, device, _offset(shape, batch))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, dtype=torch.float32, batch: bool = False
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device`` (``threefry.uniform``, bit for bit), cast to ``dtype``;
    ``batch`` as in :func:`batch_rows`."""
    shape = _shape(shape)
    u = threefry.uniform(key, shape, minval, maxval, device,
                         _offset(shape, batch))
    return u if dtype == torch.float32 else u.to(dtype)


def bernoulli(key, p, shape=None, device=None, batch: bool = False
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` as a bool tensor: ``p`` a
    tensor (its shape and device unless given) or a number (an f32
    value, as JAX takes it); ``batch`` as in :func:`batch_rows`."""
    if isinstance(p, torch.Tensor):
        shape = p.shape if shape is None else shape
        return uniform(key, shape, device=p.device, batch=batch) < p.float()
    return uniform(key, shape, device=device, batch=batch) < float(
        np.float32(p))


#: XLA's ``ErfInv32`` coefficients (Giles), for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: ``w = -log1p(-x*x)``, a degree-8 polynomial
    in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times x; each Horner step one
    rounding, as XLA's fused multiply-add (formed in f64, where it is
    exact)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coeff(i):
        return torch.where(small, float(np.float32(_ERFINV_SMALL[i])),
                           float(np.float32(_ERFINV_LARGE[i])))

    p = coeff(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = (coeff(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key, shape, device=None, dtype=torch.float32,
           batch: bool = False) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)``, ``u`` JAX's uniform on ``(nextafter(-1, 0), 1)``;
    ``batch`` as in :func:`batch_rows`."""
    z = erf_inv(uniform(key, shape, _NORMAL_LO, 1.0, device=device,
                        batch=batch)) * _SQRT2
    return z if dtype == torch.float32 else z.to(dtype)
