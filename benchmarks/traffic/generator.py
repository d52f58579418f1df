"""The one traffic generator: it reads a traffic mix's data file
(``traffic/<name>.json``) and makes the inputs of a run from ``--seed``.

Two kinds of mix:

- ``"kind": "lm_batches"``: training batches of ``seq + 1`` tokens drawn
  uniformly from the vocabulary, one new batch a step, made on the device
  by a generator seeded from (seed, step), so step i's batch can be made
  again for the reference.
- ``"kind": "requests"``: a stream of generation requests. ``prompt`` and
  ``output`` give the length distributions, each clipped to
  ``[min, max]``: ``dist`` names a module ``traffic/lengths/<dist>.py``
  (its ``quantiles(spec, u)``). ``arrivals`` gives the process:
  ``process`` names a module ``traffic/arrivals/<process>.py`` (its
  ``rate(spec)`` in requests a second and ``gaps(spec, u)``, both None
  for a backlog kept at the engine's queue depth). A new distribution or
  process is a new file; nothing here changes.

Every seed gets the same sizes and the same gaps, in another order: the
lengths are ``pool`` stratified quantiles of their distributions and the
gaps stratified quantiles of the arrival process, each permuted by the
seed (a new permutation each time the pool is used up). ``pool`` is a
count, or ``"window"``: the requests a window of the run's length offers
at the mix's rate, so that each window offers the whole set once. So runs
on two seeds do the same work; only which tokens and which order differ.
"""

from __future__ import annotations

import importlib

import numpy as np

from benchmarks.harness.core import refuse_unknown

_STREAMS = {"window": 0, "warmup": 1}
#: the keys each kind of mix is read by (notes aside)
MIX_KEYS = {"requests": ("kind", "arrivals", "prompt", "output", "pool"),
            "lm_batches": ("kind", "seq")}


def piece(part: str, name: str):
    """The module ``traffic/<part>/<name>.py`` (``lengths`` or
    ``arrivals``)."""
    mod = f"benchmarks.traffic.{part}.{name}"
    try:
        return importlib.import_module(mod)
    except ModuleNotFoundError as e:
        if e.name != mod:
            raise
        raise ValueError(f"no traffic/{part}/{name}.py") from e


def _strata(pool: int) -> np.ndarray:
    return (np.arange(pool) + 0.5) / pool


def _lengths(spec: dict, pool: int) -> np.ndarray:
    """``pool`` stratified draws of a length distribution, as ints."""
    vals = piece("lengths", spec["dist"]).quantiles(spec, _strata(pool))
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


class RequestStream:
    """Requests of a ``requests`` mix, in order: (prompt tokens int32,
    max_new, due offset in seconds from the stream's start, or 0.0 for a
    backlog)."""

    def __init__(self, mix: dict, seed: int, vocab: int,
                 stream: str = "window", seconds: float | None = None):
        if mix["kind"] != "requests":
            raise ValueError(f"not a request mix: {mix['kind']!r}")
        refuse_unknown("traffic", mix, MIX_KEYS["requests"])
        self.vocab = vocab
        self.rng = np.random.default_rng([int(seed), _STREAMS[stream]])
        arr = mix["arrivals"]
        proc = piece("arrivals", arr["process"])
        self.rate = proc.rate(arr)
        #: a backlog (no due times): the load generator keeps the queue full
        self.backlog = self.rate is None
        pool = mix.get("pool", 4096)
        if pool == "window":
            pool = max(16, round(self.rate * (seconds or 10.0)))
        pool = int(pool)
        self._p = _lengths(mix["prompt"], pool)
        #: every prompt length the stream draws from (its pool, in order)
        self.prompt_pool = self._p
        self._o = _lengths(mix["output"], pool)
        self._g = proc.gaps(arr, _strata(pool))
        self._i = pool
        self._t = 0.0

    def _refill(self):
        n = len(self._p)
        self._pp = self._p[self.rng.permutation(n)]
        self._oo = self._o[self.rng.permutation(n)]
        self._gg = (self._g[self.rng.permutation(n)]
                    if self._g is not None else None)
        self._i = 0

    def next(self, prompt_range: tuple[int, int] | None = None):
        """The next request; with ``prompt_range`` the next whose prompt
        length lies in [lo, hi] (warm-up of one prompt bucket)."""
        while True:
            if self._i >= len(self._p):
                self._refill()
            i = self._i
            self._i += 1
            if self._gg is not None:
                self._t += float(self._gg[i])
            n = int(self._pp[i])
            if prompt_range is None or prompt_range[0] <= n <= prompt_range[1]:
                toks = self.rng.integers(0, self.vocab, n, dtype=np.int32)
                return toks, int(self._oo[i]), self._t


def lm_batch(mix: dict, seed: int, step: int, batch: int, vocab: int,
             device):
    """Training batch ``step`` of an ``lm_batches`` mix: (batch, seq + 1)
    int64 tokens uniform over the vocabulary, made on ``device``."""
    import torch

    if mix["kind"] != "lm_batches":
        raise ValueError(f"not a training mix: {mix['kind']!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (1 << 63))
    return torch.randint(0, vocab, (batch, int(mix["seq"]) + 1),
                         generator=gen, device=device, dtype=torch.int64)
