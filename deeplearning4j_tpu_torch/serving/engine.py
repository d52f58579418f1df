"""Continuous-batching decode engine — pipelined, multi-step hot path (port
of ``deeplearning4j_tpu/serving/engine.py``, single-device slab path).

The engine owns ``n_slots`` KV-cache slots (one pooled allocation, see
:mod:`cache_pool`) and batches DECODE STEPS, ``decode_horizon`` (K) of them
per dispatch. Every :meth:`ServingEngine.step`:

1. retires cancelled / deadline-expired slots;
2. admits queued requests into free slots: the prompt is right-padded to a
   power-of-two bucket (up to ``PREFILL_MAX_BUCKET``) and prefilled straight
   into the slot's slab of the pooled cache; longer prompts are chunked
   through ``forward_chunk`` at the same bucket sizes;
3. DISPATCHES the K fused decode substeps for all slots, then
4. reads back the PREVIOUS horizon's (slots, K) token block and does the
   host bookkeeping while the device computes the next horizon.

The per-slot decode state — pending logits, positions, active mask,
remaining budget, EOS id — lives on the device and is threaded through the
step program, so EOS / budget deactivation happens in-program; the host
replays the same stopping rule when the block arrives. Readback is the one
host sync per horizon: the token block is copied to pinned host memory
without blocking and an event marks its arrival (CUDA's stream order gives
the overlap that the reference's async dispatch gives).

Programs (``build_*_program``) are plain functions on tensors. Unlike the
reference's pure jitted programs they update the pooled cache and the slot
state IN PLACE, in stream order behind any in-flight horizon.

Greedy determinism: at ``temperature=0`` the step program takes the argmax
of the same ``_top_k_filter``ed logits ``transformer_generate`` uses, so
streams equal each request decoded alone wherever the two paths' logits
agree bitwise (on the CPU, and on the card except where the library's
matmul reduces a batch of 1 and of n_slots in different orders).

Sampled decoding: each slot gets a seed from the engine's
``torch.Generator`` at admission, in admission order, and token i is drawn
by Gumbel-max with noise that is a pure function of (slot seed, position),
so a stream does not depend on batch composition or K. It is not the
reference's threefry stream.

int8 serving needs nothing of the engine: a quantized params tree
(``quantize_decode_params``) and ``decode_int8`` make the pooled cache the
int8 ``{"kv", "scale"}`` dict, which every program here takes leafwise.

Block-paged KV (``paged=True``): the pool is a ``PagedKVPool`` of fixed-size
blocks with per-slot int32 tables. Admission allocates ``ceil((prompt +
max_new) / block_size)`` blocks (a request waits in the queue while they do
not fit). In both layouts a prompt is prefilled at batch 1 into a slab the
pool hands out and the pool then lands it: the slab pool hands out the
slot's own rows, the paged pool a scratch slab it scatters into the slot's
blocks. The paged decode step writes through the tables and runs the paged
decode kernel on the pool. The pool uploads its device copy of the tables
whenever they changed, between horizons, never inside one. Paging is
gated, as in the reference, by a one-time probe (``paged_parity="auto"``):
three decode steps over shuffled tables with an aliased block must give
logits bitwise equal to the slab step's, or the engine logs
``paged_parity_probe_failed`` and serves from slabs. An exception in the
probe propagates.

Left for later slices: the prefix cache, piggyback, the grammar/sampling
surface, LoRA, tensor parallelism, disaggregated prefill and crash replay.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _chunk_builder,
    _decode_builder,
    _kv_planes,
    _top_k_filter,
    check_supported,
    kv_map,
    paged_slot_scatter,
    params_to,
)
from deeplearning4j_tpu_torch.serving.cache_pool import KVSlotPool, PagedKVPool
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionError,
    Backpressure,
    Request,
    RequestScheduler,
    RequestStatus,
)

#: device EOS id for requests without one (never equals a sampled token)
_NO_EOS = -1
#: largest power-of-two prompt bucket; longer prompts are chunked
PREFILL_MAX_BUCKET = 128
#: finished streams kept for ``results`` / ``pop_result`` (oldest evicted)
RESULTS_CAP = 1024

_M32 = 0xFFFFFFFF

_log = logging.getLogger(__name__)


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors holding 32-bit values, with no
    intermediate above 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """A 32-bit integer mixer (lowbias32) on int64 tensors."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _gumbel_noise(seeds, pos, vocab: int):
    """(S, vocab) Gumbel noise, a pure function of each slot's seed, its
    position and the token id."""
    v = torch.arange(vocab, device=seeds.device, dtype=torch.int64)[None]
    h = _hash32(_hash32(_hash32(v) ^ pos.long()[:, None]) ^ seeds[:, None])
    u = ((h >> 8).double() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u)).float()


# -- program factories ----------------------------------------------------------

def build_step_program(fwd1, horizon: int, temperature: float,
                       top_k: int | None):
    """K fused decode substeps. The carry — caches (updated in place),
    pending logits, positions, active mask, remaining budget — stays on the
    device; a slot that emits its EOS or spends its budget stops advancing
    for the rest of the horizon."""

    def step(params, caches, logits, pos, active, budget, eos, seeds):
        toks_all = []
        for _ in range(horizon):
            filt = _top_k_filter(logits, top_k)
            if temperature == 0:
                toks = filt.argmax(dim=-1).to(torch.int32)
            else:
                noise = _gumbel_noise(seeds, pos, filt.shape[-1])
                toks = (filt / temperature + noise).argmax(dim=-1).to(
                    torch.int32)
            # inactive slots decode token 0 at their frozen position; the
            # row they write stays in their own slab (paged: their blocks,
            # or the re-zeroed sentinel) and the next admission rewrites
            # the whole slab
            toks = torch.where(active, toks, 0)
            logits, caches = fwd1(params, caches, toks, pos)
            pos = torch.where(active, pos + 1, pos)
            budget = torch.where(active, budget - 1, budget)
            active = active & (toks != eos) & (budget > 0)
            toks_all.append(toks)
        return caches, logits, pos, active, budget, torch.stack(toks_all, 1)

    return step


def build_deact_program():
    """Clear one slot's active bit (retirement between horizons)."""

    def deact(active, slot: int):
        active[slot] = False
        return active

    return deact


def build_insert_program():
    """Seat a slot's device state after its rows hold the prompt: pending
    logits row, position, active bit, budget and EOS id."""

    def insert(caches, logits, pos, active, budget, eos, lg, slot: int,
               pos0: int, max_new: int, eos_tok: int):
        logits[slot] = lg[0]
        pos[slot] = pos0
        active[slot] = True
        budget[slot] = max_new
        eos[slot] = eos_tok
        return caches, logits, pos, active, budget, eos

    return insert


def build_prefill_program(do_prefill):
    """Admission for one prompt bucket: prefill the padded prompt into a
    batch-1 slab (written in place); returns the (1, V) logits at
    ``last_idx``, the true last prompt row (the padded rows are causally
    invisible to it)."""

    def prefill(params, slab, prompt, last_idx: int):
        _, lg = do_prefill(params, slab, prompt, last_idx=last_idx)
        return slab, lg

    return prefill


def build_chunk_program(fwd_chunk):
    """One ``forward_chunk`` pass over a bucket of prompt rows at offset
    ``pos0`` into a batch-1 slab (written in place); returns the (1, V)
    logits at ``last_idx``."""

    def chunk(params, slab, toks, pos0: int, last_idx: int):
        lg, slab = fwd_chunk(params, slab, toks, pos0, last_idx=last_idx)
        return slab, lg

    return chunk


class _SlotState:
    """Host-side record for one occupied slot."""

    __slots__ = ("req", "tokens", "t_first_token", "gen")

    def __init__(self, req: Request, gen: int):
        self.req = req
        self.tokens: list[int] = []
        self.t_first_token: float | None = None
        self.gen = gen  # pool generation at admission (reuse detection)


class _Inflight:
    """A dispatched, not yet read back horizon: the (slots, K) token block
    on its way to host memory, the event that marks its arrival, and who
    occupied each slot at dispatch."""

    __slots__ = ("toks", "event", "snaps", "t_dispatch")

    def __init__(self, toks, event, snaps, t_dispatch):
        self.toks = toks
        self.event = event
        self.snaps = snaps
        self.t_dispatch = t_dispatch


class ServingEngine:
    """Fixed-shape pipelined continuous-batching decode loop.

    ``params`` is the float params tree (any device; moved to the engine's
    device and cast once to the compute dtype). The engine runs on
    ``device`` — ``cuda`` unless the caller passes ``device="cpu"``.
    Sampling settings are engine-wide; ``temperature=0`` decodes greedily.
    ``approx_top_k`` is the reference's flag, accepted and ignored: off
    the TPU its threshold is the exact one, which the port computes
    either way (``_top_k_filter``). The reference also turns its grammar
    surface off under the flag; the port has no grammar surface yet.
    ``decode_horizon`` (K) decode steps are fused into one dispatch.
    Prompts are padded to power-of-two buckets up to
    ``PREFILL_MAX_BUCKET`` and chunked beyond it. ``paged`` stores the KV
    cache in ``block_size``-row blocks (default 8; a size that does not
    divide Tpad disables paging) once the parity probe passes;
    ``paged_parity=True`` trusts the layout without the probe. Serving
    from slabs is ``paged=False``.
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        params,
        *,
        n_slots: int = 8,
        max_total: int | None = None,
        temperature: float = 0.0,
        top_k: int | None = None,
        approx_top_k: bool = False,
        decode_horizon: int = 1,
        scheduler: RequestScheduler | None = None,
        rng_seed: int = 0,
        device=None,
        paged: bool = False,
        block_size: int | None = None,
        paged_parity: bool | str = "auto",
    ):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_total = int(min(max_total or cfg.max_len, cfg.max_len))
        self.temperature = temperature
        self.top_k = top_k
        self.decode_horizon = max(1, int(decode_horizon))

        fwd1, init_caches, do_prefill, cast_params = _decode_builder(cfg)
        self._fwd1, self._init_caches = fwd1, init_caches
        self._do_prefill = do_prefill
        # one-time weight cast: every step reads the compute-dtype weights
        # (int8 leaves and their scales stay as they are)
        self.params = cast_params(params_to(params, self.device))

        if paged_parity not in ("auto", True):
            raise ValueError(f'paged_parity is "auto" or True, got '
                             f'{paged_parity!r}')
        self._paged = False
        self._block_size = int(block_size or 8)
        if paged:
            tpad = _kv_planes(init_caches(
                1, self.max_total, torch.device("meta")))[0].shape[3]
            if self._block_size > tpad or tpad % self._block_size:
                _log.warning("paged_disabled_bad_block_size block_size=%d "
                             "tpad=%d", self._block_size, tpad)
            elif (paged_parity is True
                  or self._probe_paged_parity(self._block_size)):
                self._paged = True
            else:
                _log.warning("paged_parity_probe_failed block_size=%d",
                             self._block_size)
        if self._paged:
            self.pool = PagedKVPool(cfg, n_slots, self.max_total,
                                    self.device,
                                    block_size=self._block_size)
        else:
            self.pool = KVSlotPool(cfg, n_slots, self.max_total, self.device)
        # NOT `scheduler or ...`: an empty scheduler is falsy (__len__)
        self.scheduler = scheduler if scheduler is not None else (
            RequestScheduler(max_total_tokens=self.max_total)
        )
        if self.scheduler.max_total_tokens is None:
            self.scheduler.max_total_tokens = self.max_total
        self.metrics = ServingMetrics()
        self.metrics.decode_horizon = self.decode_horizon
        reg = self.metrics.registry
        reg.gauge("serve_queue_depth", "Queued requests.").set_function(
            lambda: len(self.scheduler))
        reg.gauge("serve_kv_slots_active",
                  "KV slots holding a live request.").set_function(
            lambda: self.pool.n_active)
        reg.gauge("serve_kv_occupancy",
                  "Active fraction of the KV slot pool.").set_function(
            lambda: self.pool.occupancy)
        if self._paged:
            reg.gauge("serve_kv_blocks",
                      "Allocatable KV blocks in the paged pool (sentinel "
                      "excluded).").set_function(
                lambda: self.pool.n_blocks - 1)
            reg.gauge("serve_kv_blocks_free",
                      "KV blocks on the paged pool's free heap."
                      ).set_function(lambda: self.pool.n_free_blocks)
            reg.gauge("serve_kv_blocks_in_use",
                      "KV blocks held by slot tables.").set_function(
                lambda: self.pool.n_blocks_in_use)
            reg.gauge("serve_kv_block_size",
                      "Rows per KV block (paged layout granule)."
                      ).set_function(lambda: self.pool.block_size)

        # power-of-two prompt buckets: the largest respects the positional
        # table and the slab row count
        limit = min(PREFILL_MAX_BUCKET, cfg.max_len, self.pool.tpad)
        mb = 1
        while mb * 2 <= limit:
            mb *= 2
        self._max_bucket = mb
        self._min_bucket = min(8, mb)

        self._step_fn = build_step_program(
            fwd1, self.decode_horizon, temperature, top_k)
        self._prefill_fn = build_prefill_program(do_prefill)
        self._chunk_fn = build_chunk_program(_chunk_builder(cfg))
        self._insert_fn = build_insert_program()
        self._deact_fn = build_deact_program()

        # per-slot decode state, DEVICE-resident
        dev = self.device
        self._logits = torch.zeros((n_slots, cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
        self._dpos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._dactive = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
        self._dbudget = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._deos = torch.full((n_slots,), _NO_EOS, dtype=torch.int32,
                                device=dev)
        # per-slot sampling seeds, drawn at admission from the engine's
        # generator (host-side; snapshotted per dispatch)
        self._rng = torch.Generator().manual_seed(rng_seed)
        self._slot_seeds = np.zeros((n_slots,), np.int64)

        self._slots: list[_SlotState | None] = [None] * n_slots
        self._inflight: _Inflight | None = None
        self._results_lock = threading.Lock()
        self._results: dict[str, np.ndarray] = {}  # guarded-by: _results_lock
        self._admitting = 0
        #: programs that computed prompt rows (bucketed prefills + chunks)
        self.prefill_dispatches = 0

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, pinned and non-blocking on
        CUDA (a pageable upload would wait for every horizon queued ahead
        of it)."""
        return upload(arr, self.device)

    # -- buckets -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        """Smallest power-of-two bucket >= n (n <= max bucket)."""
        b = self._min_bucket
        while b < n:
            b *= 2
        return b

    def _chunk_schedule(self, n: int) -> list[tuple[int, int, int]]:
        """(offset, real_len, bucket) chunks covering a prompt of n rows
        through the bucket sizes. Every write window [offset,
        offset+bucket) fits Tpad: when a padded tail would spill, the
        remainder is cut into exact power-of-two pieces plus one minimal
        padded tail."""
        tpad = self.pool.tpad
        sched, t0, rem = [], 0, n
        while rem > self._max_bucket:
            sched.append((t0, self._max_bucket, self._max_bucket))
            t0 += self._max_bucket
            rem -= self._max_bucket
        if rem:
            b = self._bucket_for(rem)
            if t0 + b <= tpad:
                sched.append((t0, rem, b))
            else:
                while rem:
                    if rem >= b:
                        sched.append((t0, b, b))
                        t0 += b
                        rem -= b
                    elif b > self._min_bucket:
                        b //= 2
                    else:
                        sched.append((t0, rem, b))
                        rem = 0
        for t0, _, b in sched:
            if t0 + b > tpad:
                raise AssertionError(
                    f"chunk window [{t0}, {t0 + b}) spills Tpad {tpad}")
        return sched

    # -- public surface ------------------------------------------------------

    def submit(self, req: Request) -> str:
        """Queue a request; raises ``Backpressure`` / ``AdmissionError``."""
        if len(req.prompt) and int(req.prompt.max()) >= self.cfg.vocab_size:
            raise AdmissionError(
                f"request {req.id}: token id outside the vocabulary "
                f"({self.cfg.vocab_size})")
        if len(req.prompt) and int(req.prompt.min()) < 0:
            raise AdmissionError(f"request {req.id}: negative token id")
        try:
            return self.scheduler.submit(req)
        except Backpressure:
            self.metrics.record_backpressure()
            raise

    @property
    def results(self) -> dict[str, np.ndarray]:
        """Terminal streams (prompt + generated tokens) by request id."""
        with self._results_lock:
            return dict(self._results)

    def pop_result(self, req_id: str, default=None):
        with self._results_lock:
            return self._results.pop(req_id, default)

    @property
    def idle(self) -> bool:
        """No request queued, mid-admission, decoding or awaiting
        readback."""
        return (self.pool.n_active == 0 and self._admitting == 0
                and len(self.scheduler) == 0 and self._inflight is None)

    def cancel(self, req_id: str) -> bool:
        """Cancel a queued or decoding request (honored within one
        horizon); False when the id is unknown."""
        for st in self._slots:
            if st is not None and st.req.id == req_id:
                st.req.cancel()
                return True
        return self.scheduler.cancel(req_id)

    def preempt_all(self) -> int:
        """Cancel every live and queued request; returns how many."""
        n = 0
        for st in self._slots:
            if st is not None and not st.req.cancelled:
                st.req.cancel()
                n += 1
        return n + self.scheduler.cancel_all()

    # -- retirement ----------------------------------------------------------

    def _store_result(self, req: Request, tokens: list[int]) -> None:
        stream = np.concatenate([req.prompt, np.asarray(tokens, np.int32)])
        with self._results_lock:
            self._results[req.id] = stream
            while len(self._results) > RESULTS_CAP:
                self._results.pop(next(iter(self._results)))

    def _retire(self, slot: int, status: RequestStatus, now: float,
                error: str | None = None, *, deactivate: bool = False
                ) -> None:
        """Free a slot and move its request to a terminal status;
        ``deactivate`` also clears the slot's device active bit (a FINISHED
        slot was already deactivated in-program)."""
        st = self._slots[slot]
        req = st.req
        req.status = status
        req.error = error
        self._store_result(req, st.tokens)
        if status is RequestStatus.FINISHED:
            decode_s = now - (st.t_first_token or now)
            self.metrics.record_finished(len(st.tokens), decode_s)
            if st.t_first_token is not None and req.arrival_time is not None:
                req.timing = {"ttft_s": st.t_first_token - req.arrival_time,
                              "decode_s": decode_s}
        else:
            self.metrics.record_outcome(status)
        self.pool.release(slot)
        self._slots[slot] = None
        if deactivate:
            self._dactive = self._deact_fn(self._dactive, slot)
        if req.done is not None:
            req.done.set()

    def _retire_unadmitted(self, req: Request, status: RequestStatus,
                           error: str | None = None) -> None:
        req.status = status
        req.error = error
        self.metrics.record_outcome(status)
        if req.done is not None:
            req.done.set()

    def fail_all(self, error: str) -> None:
        """Fail every live and queued request (slot freed, ``done`` set)."""
        now = time.perf_counter()
        self._inflight = None
        for slot, st in enumerate(self._slots):
            if st is not None:
                self._retire(slot, RequestStatus.FAILED, now, error=error)
        while (req := self.scheduler.pop()) is not None:
            self._retire_unadmitted(req, RequestStatus.FAILED, error)

    def _sweep_lifecycle(self, now: float) -> None:
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            if st.req.cancelled:
                self._retire(slot, RequestStatus.CANCELLED, now,
                             deactivate=True)
            elif st.req.expired(now):
                self._retire(slot, RequestStatus.EXPIRED, now,
                             deactivate=True)

    # -- admission -----------------------------------------------------------

    def _state(self):
        return (self.pool.operand(), self._logits, self._dpos, self._dactive,
                self._dbudget, self._deos)

    def _paged_ensure_blocks(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s block coverage to ``n_tokens`` rows (clamped to
        Tpad) with fresh private blocks; a no-op when covered."""
        n_tokens = min(int(n_tokens), self.pool.tpad)
        need = self.pool.blocks_needed(n_tokens)
        have = int(np.count_nonzero(self.pool.table(slot)))
        if need > have:
            self.pool.alloc_slot_blocks(slot, n_tokens, start=have)

    def _admissible(self, req: Request) -> bool:
        """Paged admission gate: the request's blocks fit the free heap."""
        return self.pool.can_admit(len(req.prompt) + req.max_new)

    def _prefill_into_slot(self, seq: np.ndarray, slot: int, budget: int,
                           eos_tok: int) -> None:
        """Land ``seq`` in ``slot`` and seat the slot's device state: the
        prompt is prefilled at batch 1 into the slab the pool hands out,
        one dispatch for a bucket-sized prompt, one per chunk beyond the
        largest bucket, and the pool lands the slab in the slot's rows.
        Paged: the slot's blocks (every row it can write) are allocated
        first."""
        n = int(len(seq))
        if self._paged:
            self._paged_ensure_blocks(slot, n + budget)
        slab = self.pool.prefill_slab(slot)
        if n and n <= self._max_bucket:
            pad = np.zeros((1, self._bucket_for(n)), np.int64)
            pad[0, :n] = seq
            slab, lg = self._prefill_fn(self.params, slab, self._upload(pad),
                                        n - 1)
            self.prefill_dispatches += 1
        else:
            # empty prompt: decode starts from uniform logits over a zeroed
            # slab
            lg = torch.zeros((1, self.cfg.vocab_size), dtype=torch.float32,
                             device=self.device)
            for t0, ln, b in (self._chunk_schedule(n) if n else ()):
                pad = np.zeros((1, b), np.int64)
                pad[0, :ln] = seq[t0:t0 + ln]
                slab, lg = self._chunk_fn(self.params, slab,
                                          self._upload(pad), t0, ln - 1)
                self.prefill_dispatches += 1
        self.pool.land(slot, slab)
        self._insert_fn(*self._state(), lg, slot, n, budget, eos_tok)

    def _seat(self, req: Request, slot: int, prefill_s: float) -> None:
        """Host bookkeeping that makes an admitted request a live slot
        (the sampling seed is drawn here, in admission order)."""
        self._slot_seeds[slot] = int(
            torch.randint(0, 1 << 31, (1,), generator=self._rng))
        self._slots[slot] = _SlotState(req, self.pool.generation(slot))
        req.status = RequestStatus.RUNNING
        self.metrics.record_prefill(prefill_s)
        if req.arrival_time is not None:
            self.metrics.record_admitted(time.perf_counter() - req.arrival_time)

    def _admit(self, now: float) -> None:
        """Pop queued requests into free slots, in order, one prefill each.
        A failure mid-admission requeues the popped request (it is never
        dropped between pop and seating)."""
        admissible = self._admissible if self._paged else None
        while self.pool.n_free and len(self.scheduler):
            self._admitting += 1
            try:
                req = self.scheduler.pop(admissible=admissible)
                if req is None:
                    return
                if req.cancelled:
                    self._retire_unadmitted(req, RequestStatus.CANCELLED)
                    continue
                if req.expired(now):
                    self._retire_unadmitted(req, RequestStatus.EXPIRED)
                    continue
                slot = self.pool.acquire()
                try:
                    t0 = time.perf_counter()
                    eos_tok = (_NO_EOS if req.eos_token is None
                               else int(req.eos_token))
                    self._prefill_into_slot(req.prompt, slot, req.max_new,
                                            eos_tok)
                    self._seat(req, slot, time.perf_counter() - t0)
                except BaseException:
                    self.pool.release(slot)
                    self.scheduler.requeue(req)
                    raise
            finally:
                self._admitting -= 1

    # -- paged parity probe ------------------------------------------------------

    @torch.no_grad()
    def _probe_paged_parity(self, block_size: int) -> bool:
        """One-time probe gating the paged layout (the reference's
        ``_probe_paged_parity``, engine.py:3640): does the paged decode step
        reproduce the slab step's logits bitwise? Both legs run batch 2
        over the same prefilled rows, the paged one through SHUFFLED tables
        with one block ALIASED by both rows, for 3 greedy steps. Runs on
        scratch state before the pool exists. The probe's cache is at least
        one block long (the reference's is 32 rows, which refuses a block
        size above 32)."""
        total = int(min(self.max_total, max(32, block_size)))
        n = min(8, total - 4)
        if n < 1:
            return False
        dev = self.device
        seq = ((1 + np.arange(n)) % self.cfg.vocab_size)[None]
        tmp = self._init_caches(1, total, dev)
        _, lg = self._do_prefill(self.params, tmp,
                                 torch.from_numpy(seq).to(dev))
        kv, _ = _kv_planes(tmp)
        tpad = kv.shape[3]
        if tpad % block_size:
            return False
        bps = tpad // block_size
        # slab leg: the prefilled slab in both rows of a 2-slot cache
        slab = self._init_caches(2, total, dev)
        for s in (0, 1):
            kv_map(lambda c, t: c[:, :, s:s + 1].copy_(t), slab, tmp)
        # paged leg: the same rows through shuffled tables, rows 0 and 1
        # sharing one block
        tables = (np.random.default_rng(0).permutation(2 * bps) + 1).reshape(
            2, bps).astype(np.int32)
        tables[1, 0] = tables[0, 0]
        blocks = kv_map(lambda t: torch.zeros(
            (t.shape[0], 2, 2 * bps + 1, block_size, t.shape[4]),
            dtype=t.dtype, device=dev), tmp)
        dtab = torch.from_numpy(tables).to(dev)
        for s in (0, 1):
            paged_slot_scatter(blocks, dtab[s], tmp)
        paged = {"blocks": blocks, "tables": dtab}
        slg = plg = torch.cat([lg, lg])
        pos = torch.full((2,), n, dtype=torch.int32, device=dev)
        for _ in range(3):
            slg, _ = self._fwd1(self.params, slab,
                                slg.argmax(-1).to(torch.int32), pos)
            plg, _ = self._fwd1(self.params, paged,
                                plg.argmax(-1).to(torch.int32), pos)
            pos = pos + 1
            if not torch.equal(slg, plg):
                return False
        return True

    # -- decode ----------------------------------------------------------------

    def _readback(self, toks: torch.Tensor):
        """Start the token block's copy to host memory without blocking;
        returns (host tensor, event or None)."""
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _dispatch(self) -> _Inflight | None:
        """Dispatch one K-substep horizon for every occupied slot; returns
        the in-flight record without waiting for its tokens."""
        if not any(st is not None for st in self._slots):
            return None
        # greedy steps draw nothing: no seed upload
        seeds = (None if self.temperature == 0
                 else self._upload(self._slot_seeds.copy()))
        t_call = time.perf_counter()
        # the caches are updated in place
        (_, self._logits, self._dpos, self._dactive, self._dbudget,
         toks) = self._step_fn(
            self.params, self.pool.operand(), self._logits, self._dpos,
            self._dactive, self._dbudget, self._deos, seeds,
        )
        host, event = self._readback(toks)
        snaps = [(s, st) for s, st in enumerate(self._slots)
                 if st is not None]
        self.metrics.record_step(len(snaps), len(self.scheduler))
        return _Inflight(host, event, snaps, t_call)

    def _process(self, horizon: _Inflight) -> None:
        """Wait for a horizon's token block and do the host bookkeeping:
        append tokens (replaying the device's EOS/budget stopping rule),
        stamp first tokens, retire finished slots. Blocks of slots retired
        or re-acquired since dispatch are dropped."""
        t_sync = time.perf_counter()
        if horizon.event is not None:
            horizon.event.synchronize()
        toks_host = horizon.toks.numpy()
        now = time.perf_counter()
        self.metrics.record_readback(
            sync_wait_s=now - t_sync,
            overlap_s=max(0.0, t_sync - horizon.t_dispatch),
        )
        for slot, st in horizon.snaps:
            if (self._slots[slot] is not st
                    or st.gen != self.pool.generation(slot)):
                continue  # retired/reused since dispatch: tokens dead
            req = st.req
            finished = False
            for k in range(toks_host.shape[1]):
                tok = int(toks_host[slot, k])
                if st.t_first_token is None:
                    st.t_first_token = now
                    if req.arrival_time is not None:
                        self.metrics.record_first_token(
                            now - req.arrival_time)
                st.tokens.append(tok)
                if tok == req.eos_token or len(st.tokens) >= req.max_new:
                    finished = True
                    break  # the device mask froze this slot here too
            if finished:
                self._retire(slot, RequestStatus.FINISHED, now)

    @torch.no_grad()
    def step(self) -> bool:
        """One horizon boundary: sweep, admit, dispatch the next horizon,
        then read back and process the previous one. Returns False when
        there was nothing to do."""
        now = time.perf_counter()
        self._sweep_lifecycle(now)
        self._admit(now)
        prev, self._inflight = self._inflight, self._dispatch()
        if prev is not None:
            self._process(prev)
        return prev is not None or self._inflight is not None

    def run(self) -> dict[str, np.ndarray]:
        """Step until every queued/active request is terminal."""
        while not self.idle:
            self.step()
        return self.results
