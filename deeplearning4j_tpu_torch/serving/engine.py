"""Continuous-batching decode engine — pipelined, multi-step hot path (port
of ``deeplearning4j_tpu/serving/engine.py``), on one device or tensor
parallel over a device mesh.

The engine owns ``n_slots`` KV-cache slots (one pooled allocation, see
:mod:`cache_pool`) and batches DECODE STEPS, ``decode_horizon`` (K) of them
per dispatch. Every :meth:`ServingEngine.step`:

1. retires cancelled / deadline-expired slots;
2. admits queued requests into free slots: the prompt is right-padded to a
   power-of-two bucket (up to ``prefill_max_bucket``) and prefilled straight
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
reference's pure jitted programs they update the pooled cache, the prefix
region and the slot state IN PLACE, in stream order behind any in-flight
horizon.

Greedy determinism: at ``temperature=0`` the step program takes the argmax
of the same ``_top_k_filter``ed logits ``transformer_generate`` uses, so
streams equal each request decoded alone wherever the two paths' logits
agree bitwise (on the CPU, and on the card except where the library's
matmul reduces a batch of 1 and of n_slots in different orders).

Sampled decoding is the reference's key stream (:mod:`..ops.threefry`):
the engine's master key is ``key(rng_seed)``; each slot gets ``key, sub =
split(key)``'s ``sub`` in admission order (split at seating; with
piggyback, for every admission when its plan executes, so a deferred
seating keeps the blocking order), and token i of a slot is
``categorical(fold_in(slot_key, position), filtered / temperature)``,
drawn by the threefry draw kernel. A stream is a pure function of (slot
key, position): it does not depend on batch composition, K, deferral or
crash replay, and it is the reference engine's stream for the same seed
and admission order wherever the two frameworks' logits agree.

Sampling surface (``sampling_surface=True``, the reference's): per-request
temperature, top-k, top-p, stop sequences, logit bias, logprobs and a
``response_format`` grammar (a regex or a JSON schema compiled to a
token-level DFA, :mod:`.grammar`). Every decode dispatch then runs the
masked step: the grammar mask of each slot's FSM state, the logit bias,
the logprob source, the per-slot top-k, temperature and top-p, and the
draw, each behind a ``where`` at its neutral value, with the FSM advanced
in-program off the chosen token. A stage no live slot uses this horizon
(the host knows every slot's settings) is skipped, which gives the same
bits as the ``where``. Logprobs ride the one token readback as a packed
int32 aux block; stop sequences are matched on the host at readback. The
surface is gated by a construction-time probe (``masked_parity="auto"``):
the masked step with every stage computed on neutral settings must equal
the base step bitwise, greedy and sampled, with the FSM held at 0, or the
engine logs ``masked_parity_probe_failed`` and serves without it. Under
``approx_top_k`` the surface stays off (``sampling_surface_disabled``),
as in the reference. Requests that use the surface are rejected at submit
by an engine without it.

int8 serving needs nothing of the engine: a quantized params tree
(``quantize_decode_params``) and ``decode_int8`` make the pooled cache the
int8 ``{"kv", "scale"}`` dict, which every program here takes leafwise.

Block-paged KV (``paged=True``): the pool is a ``PagedKVPool`` of fixed-size
blocks with per-slot int32 tables. Admission allocates ``ceil((prompt +
max_new) / block_size)`` blocks (a request waits in the queue while they do
not fit, after cached prefixes were handed back). In both layouts a prompt
is prefilled at batch 1 into a slab the pool hands out and the pool then
lands it: the slab pool hands out the slot's own rows, the paged pool a
scratch slab it scatters into the slot's blocks. The paged decode step
writes through the tables and runs the paged decode kernel on the pool.
The pool uploads its device copy of the tables whenever they changed,
between horizons, never inside one. Paging is gated, as in the reference,
by a one-time probe (``paged_parity="auto"``): three decode steps over
shuffled tables with an aliased block must give logits bitwise equal to
the slab step's, or the engine logs ``paged_parity_probe_failed`` and
serves from slabs. An exception in the probe propagates.

Prefix cache (``prefix_cache=True``, :mod:`prefix_cache`): a radix tree
over segments of cached prompt rows — in slab mode a region with the
pool's slab layout, in paged mode refcounted pool blocks (full blocks
aliased off the donor slot, a partial tail block copied). A FULL hit (the
whole prompt cached with its last-row logits) admits by copy and runs no
prefill program. A PARTIAL hit reuses the rows below ``L``, the match
rounded down to the hit grain, and chunk-computes the rest. The hit path
reproduces the miss path BY CONSTRUCTION: the grain is the largest prefill
bucket B (and a whole number of blocks when paged), so ``L`` is a multiple
of B; a prompt longer than B is computed in the windows [0, B), [B, 2B),
... of ``_chunk_schedule`` whether or not a prefix was cached, and a
partial hit reads only rows of segments whose donor prompt took those
windows (``Segment.partial_ok``). Its rows below ``L`` therefore came from
the same chunk program over the same tokens and windows as the miss path's
rows, and its windows from ``L`` on are the miss path's own windows. Rows
past a window's end hold another prompt's rows; the chunk and decode
attentions mask them to exact zeros. Short prompts keep the single flash
prefill (kernel #1) with the cache on or off, and their segments serve
full hits only. The construction-time probe (``_probe_prefix_parity``)
checks this bitwise — KV rows and logits of a miss against a hit on a
segment from a prompt that diverges after ``L`` — and when it fails every
lookup is a miss.

Supervision (``faults``, a :class:`~.faults.FaultInjector`): the engine
checks the "prefill" site once per admission and the "step" site before
each horizon's dispatch. A ``TransientFault`` retries with capped
exponential backoff (``max_retries``, ``retry_backoff_s``,
``max_backoff_s``); one that persists, or a ``PermanentFault``,
quarantines the request it names (FAILED, slot freed) and any other
escalates to ``EngineCrash``. :meth:`recover` then rebuilds every
device-side object — the pool, the prefix region, the slot state, the
paged tables — and replays each live slot from its host record: STEPWISE
(re-prefill the prompt through the admission path, then teacher-force the
recorded tokens through the decode step, exact by construction) or
CHUNKED (one pass over prompt + tokens; ``chunked_replay="auto"`` probes
it bitwise against stepwise once and falls back). The un-synced horizon
and its event are dropped, deferred piggyback admissions are requeued in
order with their keys, and :meth:`run` recovers up to ``max_restarts``
times.

Piggyback (``piggyback=True``): an admission whose uncached suffix exceeds
one bucket is deferred. Its chunks run under a per-horizon token budget
(``prefill_budget``, default 2x the largest bucket), enqueued after each
horizon's decode dispatch and token copy, so the copy never waits on
them; the slot is seated after its last chunk and decodes from the next
horizon on. The chunk programs, windows and scratch slab are the blocking
path's, so streams are byte-identical by construction. (The reference
fuses the last budgeted chunk into the decode dispatch and probes the
fused program; eager PyTorch has no such fusion, so the port runs the
chunk program itself and has nothing to probe.)

Streaming (``Request.stream``, a ``queue.Queue``): each token is put on
the request's queue when its horizon is read back (with a stop matcher,
only what the matcher releases; the hold-back is released before the end),
then ``None`` as the end-of-stream sentinel on every terminal path, after
the terminal status is set. The tokens are on the host once a horizon is
read back, so streaming adds no device sync; replay after a crash does
not stream a token twice (the replayed tokens already streamed).

Batched LoRA (``lora_bank``, :func:`~..models.transformer.init_lora_bank`):
the bank rides in ``params["lora"]`` (cast once with the weights) and each
slot carries an adapter index, a host mirror uploaded per dispatch, so one
step serves every mix of adapters. The deltas lie outside attention (the q
delta before RoPE, the MLP delta before the gelu), so LoRA decode runs the
decode kernels and prefill the flash kernel. Row 0 is the zero adapter,
whose rows select the base activations: a dispatch where every live slot
holds adapter 0 skips the bank (the same bits). A construction-time probe
(``lora_parity="auto"``, the reference's ``_probe_lora_zero``) checks that
adapter 0 through the bank gives the bank-free model's logits bitwise
over prefill and three greedy steps, or logs
``lora_parity_probe_failed`` and serves without the bank. Prompts with
adapter != 0 neither read nor feed the prefix cache (their KV depends on
the adapter) and give no affinity hint.

Tenancy (``tenancy``, a :class:`~.tenancy.TenantRegistry`): the default
scheduler gets the registry (weighted DRR within a priority class, quotas
at submit); admission holds each tenant under its ``max_slots`` (live and
deferred slots plus this round's plans); outcomes, tokens and rejections
are labelled by tenant, and each tenant's p99-TPOT objective is declared to
the metrics.

Batched admission (``batch_admission="auto"``, the reference's): the
misses of one admission round that pad to the same bucket are prefilled by
ONE program (``build_batch_prefill_program``: a batch of nb rows, nb the
group size rounded up to a power of two, pad rows repeating row 0, so
kernel #1 runs at BH = heads x nb), and the partial hits that share a
(suffix bucket, cached length) by one chunk program over their gathered
segments (``build_batch_hit_program``). Only groups of two or more batch;
the rest run serially in admission order, and seating (hence the key
split) stays in admission order. Each row lands at its slot in place. A
probe (``_probe_batch_parity``) gates every geometry (kind, bucket,
padded rows) once, at its first use: the batched program must give the
serial path's device state bitwise (KV rows, logits, positions, budgets),
or groups of that geometry stay serial. The reference probes one
geometry; the port probes each, since a library may pick its matmul by
the row count. Paged engines stay serial, as in the reference.

Adaptive horizon (``adaptive_horizon=True``): while the scheduler holds
requests, horizons are dispatched at K = 1 (the next admission boundary
one substep away); the configured K returns when the queue drains.
Deferred piggyback admissions hold a slot already and are not queue
pressure. The stopping rule is per substep, so streams do not depend on
K; ``decode_horizon_current`` is the K of the last dispatch.

Embeddings (``embedders``, name -> an object with
``get_word_vector(word)``): an :class:`~.scheduler.EmbeddingRequest` rides
the queue with generation and is served on the host at the admission
boundary (no slot, no device dispatch; admissible with every slot taken),
with its metrics, trace instant and log line.

Persisted probe verdicts (``probe_cache``, a path or a
:class:`~.probe_cache.ProbeCache`, only when given: the reference's
``DL4J_TPU_PROBE_CACHE`` default is not read, since its test suite points
it at one file for its own engines): every parity probe goes through
``_probe_verdict``, keyed by the probe, the model config, the stack
(torch, CUDA, device name, kernel sources) and the probe's geometry;
``probes_run`` and ``probes_from_cache`` name which probes ran and which
were read.

Observability (the reference's): ``tracer`` (a disabled
:class:`~..obs.trace.Tracer` by default: one attribute check a call)
records the request lifecycle on the engine, scheduler and slot tracks;
``flight`` (a :class:`~..obs.flight.FlightRecorder`, on by default: one
``deque.append`` an admission and a horizon) keeps the recent events for
a postmortem; ``attribution`` prices each program family
(``_attr``/``_flush_attr``) from its dispatch call to the horizon readback
that proves it complete, a host-clock upper bound with no sync of its
own, in ``metrics.record_program``; ``profile`` (a
:class:`~..obs.profiler.ProfileTrigger`) brackets every ``step()`` that
has work (an idle server loop's polls are no engine steps). Probes and
recovery replay count toward none of it. Log lines are
:func:`~..obs.logs.log_event` records with the reference's event names.

Sanitizers (development mode, ``serve --sanitize``; the reference's):
``attach_sanitizer`` takes a ``SyncSanitizer``, whose thread-local phase
the engine stamps (sweep, admit, dispatch, process, piggyback), which it
tells of each horizon it processes and whose alias tripwire checks each
dispatch's host key words at the readback; every dispatch adds its shape
key to ``program_keys`` (one set-add) for ``CompileCountGuard``; the
results lock comes from ``wrap_lock``. Each hook is one ``None`` check
when nothing is installed.

The KV wire and live migration (the reference's; frames in
:mod:`.disagg`): a ``KVExportRequest`` prefills a prompt into a slot held
for the export (kernel #1 or the chunk windows, the admission programs a
monolithic engine runs) and copies the segment and its logits row to the
host before the slot is freed; a ``KVIngestRequest`` (slotless) lands a
decoded segment in the prefix cache (``build_seg_import_program`` in slab
mode, fresh private blocks through ``paged_slot_scatter`` paged), so the
follow-up generate full-hits with no prefill program. A segment shorter
than the hit grain (the largest prefill bucket) is not seatable, and an
export serves adapter 0 only. ``export_sessions`` parks every live slot
as a frame with its generation state (after processing the in-flight
horizon), and a ``KVSessionRequest`` seats one mid-generation, its key
words installed verbatim (the master key is not split), so the stream
continues byte for byte. The wire is gated by ``_probe_disagg_parity`` through
``_probe_verdict`` ("disagg_wire"): a segment moved through real frame
bytes must seat bitwise the direct prefill's state. The export is a
``prefill`` span (``prefix="export"``) and the seat a ``kv_ingest`` span
on the scheduler track; migrations leave ``migrate_out``/``migrate_in``
on the slot tracks and in the flight recorder.

Exact tensor parallelism (``tp``, ``tp_parity``, ``tp_devices``; the
reference's exact-TP serving): ``tp`` > 1 resolves a model-axis
:class:`~..parallel.mesh.Mesh` before anything is built (the first ``tp``
cards unless ``tp_devices`` names them; a device may repeat), places the
params with ``serving_tp_shardings`` (each column projection split over the
ranks, each row projection whole) and shards the pool, the prefix region
and every scratch slab on the packed KV's head-major minor dim. One
process drives every rank, so every host-side feature above runs once and
every program of the engine runs sharded: the step and masked step (the
grammar, bias, top-k/p and the draw on the gathered logits), the bucketed,
batched and chunked admissions, piggyback chunks, prefix hits, crash
replay, and the wire's export, ingest and session seat (a TP slab is whole
again before it is framed, so a TP engine's frame is the single-device
engine's, and either seats the other's). No kernel runs under TP: as in
the reference the decode and the prefill are dense (a TP engine turns
``decode_kernel`` and ``use_flash`` off; the threefry draw still runs on
the gathered logits). The bar is the reference's: TP=N streams
byte-identical to TP=1 of the same dense config. It is gated by
``_probe_tp_parity`` (``tp_parity="auto"``, through ``_probe_verdict``:
every prompt bucket's prefill and chunk window and the decode at the
engine's batch, dense against sharded); on a decline, or a geometry the
layout refuses (tp not dividing the heads), the engine logs
``tp_parity_probe_failed`` and serves at tp 1 with the caller's config,
kernels included; ``True`` trusts the layout, ``False`` serves at tp 1.
The probe key of every probe carries ``tp``, and ``serve_tp_degree``
exports it.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import defaultdict, deque

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.sanitizers import (
    note_access,
    wrap_lock,
)
from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _chunk_builder,
    _decode_builder,
    _kv_planes,
    _stable_top_k,
    _top_k_filter,
    kv_leaves,
    kv_map,
    paged_slot_gather,
    paged_slot_scatter,
    params_to,
    place_serving_tp_params,
    serving_tp_cache_sharding,
    shard_cache,
    unshard_cache,
)
from deeplearning4j_tpu_torch.obs.flight import FlightRecorder
from deeplearning4j_tpu_torch.obs.logs import log_event
from deeplearning4j_tpu_torch.obs.profiler import ProfileTrigger
from deeplearning4j_tpu_torch.obs.trace import (
    ENGINE_TRACK,
    SCHEDULER_TRACK,
    Tracer,
    new_span_id,
    slot_track,
)
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.parallel.mesh import model_parallel_mesh
from deeplearning4j_tpu_torch.serving.cache_pool import KVSlotPool, PagedKVPool
from deeplearning4j_tpu_torch.serving.disagg import (
    WireError,
    decode_segment,
    encode_segment,
    model_config_hash,
    slab_to_blocks,
)
from deeplearning4j_tpu_torch.serving.faults import (
    EngineCrash,
    FaultInjector,
    PermanentFault,
    TransientFault,
)
from deeplearning4j_tpu_torch.serving.grammar import (
    MAX_LOGIT_BIAS,
    MAX_TOP_LOGPROBS,
    GrammarCache,
    GrammarError,
    GrammarTable,
    StopMatcher,
    default_token_bytes,
    parse_response_format,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache, Segment
from deeplearning4j_tpu_torch.serving.probe_cache import ProbeCache, probe_key
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionError,
    Backpressure,
    Request,
    RequestScheduler,
    RequestStatus,
)
from deeplearning4j_tpu_torch.serving.tenancy import QuotaExceeded

#: device EOS id for requests without one (never equals a sampled token)
_NO_EOS = -1
#: default largest power-of-two prompt bucket; longer prompts are chunked
PREFILL_MAX_BUCKET = 128
#: finished streams kept for ``results`` / ``pop_result`` (oldest evicted)
RESULTS_CAP = 1024
#: request kinds that take no KV slot
_SLOTLESS = ("embedding", "kv_ingest")

_log = logging.getLogger(__name__)


# -- program factories ----------------------------------------------------------

def build_step_program(fwd1, horizon: int, temperature: float,
                       top_k: int | None, device):
    """K fused decode substeps. The carry — caches (updated in place),
    pending logits, positions, active mask, remaining budget — stays on the
    device; a slot that emits its EOS or spends its budget stops advancing
    for the rest of the horizon. Sampled tokens are
    ``categorical(fold_in(key_s, pos_s), filtered / temperature)`` with the
    slots' (S, 2) key words ``keys``; ``adapters`` the slots' (S,) LoRA
    rows (None: no bank, or adapter 0 everywhere)."""
    # a device scalar: a true division (CUDA multiplies by the reciprocal
    # of a host number), as the reference's and the masked step's
    temp = torch.full((), float(temperature), dtype=torch.float32,  # lint: sync-ok a Python number
                      device=device)

    def step(params, caches, logits, pos, active, budget, eos, keys,
             adapters=None):
        toks_all = []
        for _ in range(horizon):
            filt = _top_k_filter(logits, top_k)
            if temperature == 0:
                toks = filt.argmax(dim=-1).to(torch.int32)
            else:
                toks = threefry.categorical(filt / temp, keys, pos)
            # inactive slots decode token 0 at their frozen position; the
            # row they write stays in their own slab (paged: their blocks,
            # or the re-zeroed sentinel) and the next admission rewrites
            # the whole slab
            toks = torch.where(active, toks, 0)
            logits, caches = fwd1(params, caches, toks, pos, adapters)
            pos = torch.where(active, pos + 1, pos)
            budget = torch.where(active, budget - 1, budget)
            active = active & (toks != eos) & (budget > 0)
            toks_all.append(toks)
        return caches, logits, pos, active, budget, torch.stack(toks_all, 1)

    return step


@dataclasses.dataclass(frozen=True)
class SurfaceUse:
    """Which masked-step stages some live slot uses this horizon (the host
    knows every slot's settings). A stage left out is one whose ``where``
    would return its input bitwise; the parity probe runs them all."""

    mask: bool = True
    bias: bool = True
    top_k: bool = True
    top_p: bool = True
    sample: bool = True
    logprobs: bool = True


def _dyn_top_k_filter(logits, top_ks):
    """Per-slot top-k with a k vector (the reference's, engine.py:439): the
    kth largest value as the ascending sort's entry V - k, the threshold
    ``_top_k_filter`` takes, so the rows are bitwise its rows. k 0 is the
    no-filter sentinel, folded out."""
    vs = logits.shape[-1]
    srt = torch.sort(logits, dim=-1).values
    idx = (vs - top_ks.long()).clamp(0, vs - 1)
    kth = srt.gather(1, idx[:, None])
    filt = logits.masked_fill(logits < kth, float("-inf"))
    return torch.where((top_ks > 0)[:, None], filt, logits)


def _top_p_filter(scaled, top_ps):
    """Per-slot nucleus filter on the temperature-scaled logits (the
    reference's, engine.py:455): keep the smallest descending-probability
    prefix whose mass reaches top_p (the crossing token kept). p 1 is the
    no-filter sentinel, folded out."""
    srt = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    cut = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
    out = scaled.masked_fill(scaled < cut, float("-inf"))
    return torch.where((top_ps < 1.0)[:, None], out, scaled)


def _masked_draw(logits, pos, active, gstate, keys, temps, top_ks, top_ps,
                 bias_idx, bias_val, mask_words, n_logprobs: int,
                 use: SurfaceUse):
    """One masked substep's draw, in the reference's order (engine.py:472):
    grammar mask, logit bias, the logprob source, per-slot top-k,
    temperature, top-p, then greedy or sampled. Every control sits behind a
    ``where`` at its neutral value (state 0, no bias rows, k 0, p 1, the
    engine's temperature), so a slot that uses none of them draws the base
    step's token. Greedy slots still feed their row to the draw (the
    kernel draws every row) and ``where(temps > 0)`` picks.

    Returns ``(toks, aux)``: with ``use.logprobs`` aux is the packed int32
    row ``[tok, bits(chosen logprob), top ids..., bits(top logprobs)...]``
    (ties to the lower id, as ``lax.top_k``), else ``toks[:, None]``."""
    vs = logits.shape[-1]
    base = logits
    if use.mask:
        # each slot's packed row for its FSM state, 32 tokens a word; row
        # 0 is the all-permitted sentinel and gstate > 0 folds it out
        rows = mask_words[gstate.long()]
        shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
        bits = (rows[:, :, None] >> shifts) & 1
        allowed = bits.reshape(rows.shape[0], -1)[:, :vs] != 0
        base = base.masked_fill((gstate > 0)[:, None] & ~allowed,
                                float("-inf"))
    if use.bias:
        # idx < 0 are padding; the has_bias fold keeps -0.0 logits (base +
        # 0.0 would make them +0.0)
        has_bias = (bias_idx >= 0).any(dim=-1, keepdim=True)
        idx = bias_idx.clamp(0, vs - 1).long()
        val = torch.where(bias_idx >= 0, bias_val, 0.0)
        delta = torch.zeros_like(base).scatter_add_(1, idx, val)
        base = torch.where(has_bias, base + delta, base)
    # the logprob source: the masked and biased distribution, before the
    # sampler's shaping
    lp = torch.log_softmax(base, dim=-1) if use.logprobs else None
    filt = _dyn_top_k_filter(base, top_ks) if use.top_k else base
    toks = filt.argmax(dim=-1).to(torch.int32)
    if use.sample:
        safe_t = torch.where(temps > 0, temps, 1.0)
        scaled = filt / safe_t[:, None]
        final = _top_p_filter(scaled, top_ps) if use.top_p else scaled
        sampled = threefry.categorical(final.contiguous(), keys, pos)
        toks = torch.where(temps > 0, sampled, toks)
    toks = torch.where(active, toks, 0)
    if not use.logprobs:
        return toks, toks[:, None]
    lp_cho = lp.gather(1, toks[:, None].long())
    tv, ti = _stable_top_k(lp, n_logprobs)
    aux = torch.cat([toks[:, None], lp_cho.view(torch.int32),
                     ti.to(torch.int32), tv.contiguous().view(torch.int32)],
                    dim=1)
    return toks, aux


def build_masked_step_program(fwd1, horizon: int, n_logprobs: int):
    """The grammar-constrained, per-request-sampling variant of
    ``build_step_program`` (the reference's, engine.py:537): the same K
    substeps with each slot's FSM state ``gstate`` threaded through them.
    Each substep masks before the draw and advances the state off the
    chosen token in-program (``trans_tab`` holds 0 for a disallowed
    transition; inactive and unconstrained slots hold their state), so a
    horizon of K > 1 stays constrained with no host round trip. Returns the
    packed aux block (slots, K, A) in place of the token block; [:, :, 0]
    is the tokens."""

    def mstep(params, caches, logits, pos, active, budget, eos, gstate,
              keys, temps, top_ks, top_ps, bias_idx, bias_val, mask_words,
              trans_tab, use: SurfaceUse, adapters=None):
        aux_all = []
        for _ in range(horizon):
            toks, aux = _masked_draw(logits, pos, active, gstate, keys,
                                     temps, top_ks, top_ps, bias_idx,
                                     bias_val, mask_words, n_logprobs, use)
            if use.mask:
                nxt = trans_tab[gstate.long(), toks.long()]
                gstate = torch.where(active & (gstate > 0), nxt, gstate)
            logits, caches = fwd1(params, caches, toks, pos, adapters)
            pos = torch.where(active, pos + 1, pos)
            budget = torch.where(active, budget - 1, budget)
            active = active & (toks != eos) & (budget > 0)
            aux_all.append(aux)
        return (caches, logits, pos, active, budget, gstate,
                torch.stack(aux_all, 1))

    return mstep


def build_gstate_set_program():
    """Seat one slot's grammar state (admission; by ``fill_``, no host
    sync)."""

    def gstate_set(gstate, slot: int, val: int):
        gstate[slot].fill_(val)
        return gstate

    return gstate_set


def build_replay_program(fwd1):
    """Teacher-forced decode step for stepwise crash recovery: feed the
    RECORDED tokens (no sampling) and keep the pending-logits rows of slots
    whose record is exhausted — those rows must stay what the slot's last
    real step produced."""

    def rstep(params, caches, logits, toks, pos, replaying, adapters=None):
        new_logits, caches = fwd1(params, caches, toks, pos, adapters)
        return caches, torch.where(replaying[:, None], new_logits, logits)

    return rstep


def build_deact_program():
    """Clear one slot's active bit (retirement between horizons; by
    ``fill_``, no host sync)."""

    def deact(active, slot: int):
        active[slot].fill_(False)
        return active

    return deact


def build_insert_program():
    """Seat a slot's device state after its rows hold the prompt: pending
    logits row, position, active bit, budget and EOS id. The host scalars
    go in by ``fill_`` (a kernel argument): an item assignment would copy
    them from pageable memory, a host sync."""

    def insert(caches, logits, pos, active, budget, eos, lg, slot: int,
               pos0: int, max_new: int, eos_tok: int):
        logits[slot] = lg[0]
        pos[slot].fill_(pos0)
        active[slot].fill_(True)
        budget[slot].fill_(max_new)
        eos[slot].fill_(eos_tok)
        return caches, logits, pos, active, budget, eos

    return insert


def build_hit_insert_program():
    """FULL-hit admission in slab mode: copy a segment's whole slab from
    the region into the slot's rows, land the segment's stored last-row
    logits and seat the slot's state — no prompt row computed."""
    insert = build_insert_program()

    def hit(caches, logits, pos, active, budget, eos, region, seg_lg,
            seg: int, slot: int, pos0: int, max_new: int, eos_tok: int):
        kv_map(lambda c, r: c[:, :, slot].copy_(r[:, :, seg]), caches,
               region)
        return insert(caches, logits, pos, active, budget, eos, seg_lg,
                      slot, pos0, max_new, eos_tok)

    return hit


def build_seg_fetch_program():
    """Segment fetch: one region slot's slab as a batch-1 slab, copied into
    ``out`` (a slot's rows) or, without it, into a new scratch slab."""

    def fetch(region, seg: int, out=None):
        if out is None:
            return kv_map(lambda r: r[:, :, seg:seg + 1].clone(), region)
        kv_map(lambda o, r: o.copy_(r[:, :, seg:seg + 1]), out, region)
        return out

    return fetch


def build_seg_store_program():
    """Segment store (insert-on-completion): copy a pool slot's slab into
    the region at the segment's index."""

    def store(region, caches, seg: int, slot: int):
        kv_map(lambda r, c: r[:, :, seg].copy_(c[:, :, slot]), region,
               caches)
        return region

    return store


def build_logit_row_program():
    """The (1, V) pending-logits row of one slot, copied at insert time so
    a later FULL hit replays the exact prefill logits."""
    return lambda lg, slot: lg[slot:slot + 1].clone()


def build_seg_import_program():
    """Wire-segment import (the reference's, engine.py:716): land a batch-1
    slab that arrived over the KV wire in the region at the segment's
    index, the segment store with the pool slot replaced by the wire
    slab."""

    def imp(region, slab, seg: int):
        kv_map(lambda r, t: r[:, :, seg].copy_(t[:, :, 0]), region, slab)
        return region

    return imp


def build_prefill_program(do_prefill):
    """Admission for one prompt bucket: prefill the padded prompt into a
    batch-1 slab (written in place); returns the (1, V) logits at
    ``last_idx``, the true last prompt row (the padded rows are causally
    invisible to it); ``adapter`` a (1,) LoRA row or None."""

    def prefill(params, slab, prompt, last_idx: int, adapter=None):
        _, lg = do_prefill(params, slab, prompt, last_idx=last_idx,
                           adapter=adapter)
        return slab, lg

    return prefill


def build_chunk_program(fwd_chunk):
    """One ``forward_chunk`` pass over a bucket of prompt rows at offset
    ``pos0`` into a batch-1 slab (written in place); returns the (1, V)
    logits at ``last_idx``."""

    def chunk(params, slab, toks, pos0: int, last_idx: int, adapter=None):
        lg, slab = fwd_chunk(params, slab, toks, pos0, last_idx=last_idx,
                             adapter=adapter)
        return slab, lg

    return chunk


def _land_rows(caches, logits, pos, active, budget, eos, tmp, lg, slots,
               pos0, max_new, eos_toks):
    """Land the first ``len(slots)`` rows of a batch's scratch slab and
    logits at their slots and seat each slot's state, in place (pad rows
    past them are dropped: each slot is written once)."""
    n = slots.shape[0]
    kv_map(lambda c, t: c.index_copy_(2, slots.to(c.device), t[:, :, :n]),
           caches, tmp)
    logits.index_copy_(0, slots, lg[:n])
    pos.index_copy_(0, slots, pos0)
    active.index_fill_(0, slots, True)
    budget.index_copy_(0, slots, max_new)
    eos.index_copy_(0, slots, eos_toks)


def build_batch_prefill_program(do_prefill, init_caches, max_total: int):
    """BATCHED admission prefill (the reference's, engine.py:743): the
    (nb, bucket) padded prompts of one group prefilled by one program into
    an nb-row scratch slab (kernel #1 at BH = heads x nb, a vector
    ``last_idx``; the head product row by row, at the batch-1 path's M 1),
    then each real row's slab, logits row and state landed at its slot. ``slots``, ``pos0``, ``max_new``, ``eos_toks`` are (n,)
    for the n <= nb real rows; ``adapters`` (nb,) LoRA rows or None."""

    def bprefill(params, caches, logits, pos, active, budget, eos, prompts,
                 last_idx, slots, pos0, max_new, eos_toks, adapters=None):
        tmp = init_caches(prompts.shape[0], max_total, prompts.device)
        _, lg = do_prefill(params, tmp, prompts, last_idx=last_idx,
                           adapter=adapters, rowwise_head=True)
        _land_rows(caches, logits, pos, active, budget, eos, tmp, lg, slots,
                   pos0, max_new, eos_toks)

    return bprefill


def build_batch_hit_program(fwd_chunk):
    """BATCHED partial-hit admission (the reference's, engine.py:781) for
    requests sharing a cached length ``p0`` and a one-window suffix
    bucket: one gather of each row's segment slab from the region, one
    ``forward_chunk`` at ``p0`` over every suffix (vector ``last_idx``),
    and each real row landed at its slot."""

    def bhit(params, caches, logits, pos, active, budget, eos, region,
             seg_idx, toks, p0: int, last_idx, slots, posf, max_new,
             eos_toks, adapters=None):
        tmp = kv_map(lambda r: r.index_select(2, seg_idx.to(r.device)),
                     region)
        lg, tmp = fwd_chunk(params, tmp, toks, p0, last_idx=last_idx,
                            adapter=adapters, rowwise_head=True)
        _land_rows(caches, logits, pos, active, budget, eos, tmp, lg, slots,
                   posf, max_new, eos_toks)

    return bhit


class _SlotState:
    """Host-side record for one occupied slot: what replay rebuilds it
    from."""

    __slots__ = ("req", "tokens", "t_first_token", "gen", "key_data", "segs",
                 "gkey", "gstate0", "stop_matcher", "lp_out")

    def __init__(self, req: Request, gen: int, key_data: threefry.Key):
        self.req = req
        self.tokens: list[int] = []
        self.t_first_token: float | None = None
        self.gen = gen  # pool generation at admission (reuse detection)
        # the slot's sampling key (re-seated by replay)
        self.key_data = key_data
        # prefix-cache segments this request pins (the one its admission
        # read and the ones its prompt inserted), unpinned at retirement
        self.segs: list[Segment] = []
        # sampling-surface state: the seated grammar's key and absolute
        # start state (recovery re-walks the table over the tokens), the
        # stop matcher and the logprob records
        self.gkey: str | None = None
        self.gstate0 = 0
        self.stop_matcher: StopMatcher | None = None
        self.lp_out: list | None = None


class _AdmitPlan:
    """One admission: the popped request, its acquired slot and its
    prefix-cache class (``kind`` miss/partial/full, ``seg`` the pinned
    source segment, ``matched`` the reused rows)."""

    __slots__ = ("req", "slot", "kind", "seg", "matched", "handled",
                 "prefill_s", "t_pf")

    def __init__(self, req: Request, slot: int):
        self.req = req
        self.slot = slot
        self.kind = "miss"
        self.seg: Segment | None = None
        self.matched = 0
        # seated, retired or deferred: a failed round does not requeue it
        # (recover() requeues the deferred ones)
        self.handled = False
        self.prefill_s = 0.0
        self.t_pf = 0.0  # its prefill's start (the tracer's span)


class _PendingPrefill:
    """A deferred (piggyback) admission: its plan, the chunk windows still
    to run, the batch-1 scratch slab they write and the last chunk's (1, V)
    logits."""

    __slots__ = ("plan", "chunks", "slab", "lg", "t_start")

    def __init__(self, plan: _AdmitPlan, chunks, slab, t_start: float):
        self.plan = plan
        self.chunks = chunks
        self.slab = slab
        self.lg = None
        self.t_start = t_start


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


def _as_tensor(arr) -> torch.Tensor:
    """A decoded wire leaf (a numpy array, or a torch tensor for bf16) as
    a CPU tensor."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.array(arr))


def _max_bucket(prefill_max_bucket: int, max_len: int, tpad: int) -> int:
    """The largest power-of-two prompt bucket: at most
    ``prefill_max_bucket``, the positional table and the slab rows."""
    limit = min(int(prefill_max_bucket), max_len, tpad)
    mb = 1
    while mb * 2 <= limit:
        mb *= 2
    return mb


def _pow2(n: int) -> int:
    """The smallest power of two >= n: a batched group's padded rows."""
    nb = 1
    while nb < n:
        nb *= 2
    return nb


def _eos_of(req: Request) -> int:
    return _NO_EOS if req.eos_token is None else int(req.eos_token)  # lint: sync-ok host int


class ServingEngine:
    """Fixed-shape pipelined continuous-batching decode loop.

    ``params`` is the float params tree (any device; moved to the engine's
    device and cast once to the compute dtype). The engine runs on
    ``device`` — ``cuda`` unless the caller passes ``device="cpu"``.
    Sampling settings are engine-wide; ``temperature=0`` decodes greedily;
    ``rng_seed`` seeds the master key. ``approx_top_k`` is the reference's
    flag, accepted and ignored by the sampler: off the TPU its threshold is
    the exact one, which the port computes either way (``_top_k_filter``);
    as in the reference it keeps the sampling surface off.
    ``sampling_surface`` arms the per-request surface (``grammar_states``
    DFA table rows, ``grammar_cache`` a compile-cache directory or a
    :class:`GrammarCache`) behind the ``masked_parity`` probe ("auto";
    True trusts it, False leaves the surface off).
    ``decode_horizon`` (K) decode steps are fused into one dispatch.
    Prompts are padded to power-of-two buckets up to
    ``prefill_max_bucket`` and chunked beyond it. ``paged`` stores the KV
    cache in ``block_size``-row blocks (default 8; a size that does not
    divide Tpad disables paging) once the parity probe passes;
    ``paged_parity=True`` trusts the layout without the probe.

    ``prefix_cache`` caches prompt rows (``prefix_cache_tokens``, default
    one slab per slot); ``prefix_affinity_tokens`` makes the default
    scheduler admit same-prefix requests together. ``faults``,
    ``max_retries``, ``retry_backoff_s``, ``max_backoff_s`` and
    ``chunked_replay`` set supervision and replay; ``piggyback`` and
    ``prefill_budget`` the deferred prefill (see the module doc).

    ``lora_bank`` (an :func:`init_lora_bank` bank) serves batched LoRA
    behind the ``lora_parity`` probe ("auto"; True trusts it, False serves
    without the bank); ``tenancy`` (a :class:`TenantRegistry`) serves
    tenants (see the module doc; a caller's own ``scheduler`` should carry
    the same registry).

    ``batch_admission`` ("auto" behind its probe, True, False) coalesces
    same-bucket admissions; ``adaptive_horizon`` drops K to 1 while
    requests wait; ``embedders`` serves embedding lookups; ``probe_cache``
    persists probe verdicts; ``metrics`` (a :class:`ServingMetrics`) and
    ``results_cap`` (finished streams kept) as in the reference;
    ``tracer``, ``flight``, ``attribution`` and ``profile`` are the
    observability hooks; ``tp``, ``tp_parity`` ("auto", True, False) and
    ``tp_devices`` (the mesh's devices, by default the first ``tp`` cards)
    serve tensor-parallel (see the module doc).
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
        adaptive_horizon: bool = False,
        prefill_max_bucket: int = PREFILL_MAX_BUCKET,
        chunked_replay: bool | str = "auto",
        batch_admission: bool | str = "auto",
        prefix_cache: bool = False,
        prefix_cache_tokens: int | None = None,
        prefix_affinity_tokens: int = 0,
        scheduler: RequestScheduler | None = None,
        metrics: ServingMetrics | None = None,
        rng_seed: int = 0,
        faults: FaultInjector | None = None,
        max_retries: int = 3,
        retry_backoff_s: float = 0.01,
        max_backoff_s: float = 0.25,
        results_cap: int = RESULTS_CAP,
        tracer: Tracer | None = None,
        flight: FlightRecorder | None = None,
        attribution: bool = True,
        profile: ProfileTrigger | None = None,
        probe_cache: str | ProbeCache | None = None,
        embedders=None,
        device=None,
        paged: bool = False,
        block_size: int | None = None,
        paged_parity: bool | str = "auto",
        piggyback: bool = False,
        prefill_budget: int | None = None,
        sampling_surface: bool = False,
        masked_parity: bool | str = "auto",
        grammar_states: int = 256,
        grammar_cache: str | GrammarCache | None = None,
        lora_bank=None,
        lora_parity: bool | str = "auto",
        tenancy=None,
        tp: int = 1,
        tp_parity: bool | str = "auto",
        tp_devices=None,
    ):
        if device is None and tp_devices is not None and int(tp) > 1:
            device = tp_devices[0]  # the mesh's first device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_total = int(min(max_total or cfg.max_len, cfg.max_len))
        self.temperature = temperature
        self.top_k = top_k
        self.decode_horizon = max(1, int(decode_horizon))
        self.adaptive_horizon = bool(adaptive_horizon)
        self.decode_horizon_current = self.decode_horizon
        if chunked_replay not in ("auto", True, False):
            raise ValueError(f'chunked_replay is "auto", True or False, got '
                             f'{chunked_replay!r}')
        if batch_admission not in ("auto", True, False):
            raise ValueError(f'batch_admission is "auto", True or False, '
                             f'got {batch_admission!r}')
        self.chunked_replay = chunked_replay
        self.batch_admission = batch_admission
        self.results_cap = int(results_cap)
        # attribution is armed at the END of construction (probes never
        # count); _attr_suspend re-suspends it for runtime probes and
        # recovery replay
        self._attr_enabled = False
        self._attr_suspend = 0
        self._pending_attr: list[tuple[str, float]] = []
        # on by default: a postmortem must exist before the incident
        self.flight = flight if flight is not None else FlightRecorder()
        # off by default: every record call is one attribute check
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.profile = profile
        self.embedders = dict(embedders or {})
        self._probe_cache = (
            probe_cache if isinstance(probe_cache, ProbeCache)
            else ProbeCache(probe_cache) if probe_cache else None)
        #: which probes dispatched on this engine and which were read
        self.probes_run: list[str] = []
        self.probes_from_cache: list[str] = []
        self._steps = 0
        #: the attached SyncSanitizer (``attach_sanitizer``), or None
        self._san = None
        #: every dispatched program's shape key by family (one set-add a
        #: dispatch), for ``CompileCountGuard``
        self.program_keys: defaultdict[str, set] = defaultdict(set)
        self.faults = faults
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_backoff_s = max_backoff_s

        cfg = self._init_tp(cfg, params, tp, tp_parity, tp_devices,
                            prefill_max_bucket)
        fwd1, init_caches, do_prefill, cast_params = _decode_builder(
            cfg, self.tp_mesh)
        self._fwd1, self._init_caches = fwd1, init_caches
        self._do_prefill = do_prefill
        if lora_parity not in ("auto", True, False):
            raise ValueError(f'lora_parity is "auto", True or False, got '
                             f'{lora_parity!r}')
        self.n_adapters = 0
        if lora_bank is not None and lora_parity is not False:
            # the bank rides in params, cast with the weights
            params = dict(params)
            params["lora"] = lora_bank
            self.n_adapters = int(lora_bank["a_q"].shape[1])
        # one-time weight cast: every step reads the compute-dtype weights
        # (int8 leaves and their scales stay as they are); under TP after
        # the split, so each rank casts its own part
        self.params = cast_params(
            params_to(params, self.device) if self.tp_mesh is None
            else place_serving_tp_params(self.tp_mesh, params, cfg))
        self.tenancy = tenancy

        if paged_parity not in ("auto", True):
            raise ValueError(f'paged_parity is "auto" or True, got '
                             f'{paged_parity!r}')
        self._paged = False
        self._block_size = int(block_size or 8)
        if paged:
            tpad = kv_leaves(init_caches(
                1, self.max_total, torch.device("meta")))[0].shape[3]
            if self._block_size > tpad or tpad % self._block_size:
                log_event(_log, "paged_disabled_bad_block_size",
                          level=logging.WARNING,
                          block_size=self._block_size, tpad=tpad)
            elif (paged_parity is True or self._probe_verdict(
                    "paged_parity",
                    lambda: self._probe_paged_parity(self._block_size),
                    block_size=self._block_size, n_slots=n_slots,
                    max_total=self.max_total, tpad=tpad, tp=self.tp)):
                self._paged = True
            else:
                log_event(_log, "paged_parity_probe_failed",
                          level=logging.WARNING,
                          block_size=self._block_size)
        if self._paged:
            self.pool = PagedKVPool(cfg, n_slots, self.max_total,
                                    self.device, block_size=self._block_size,
                                    tp_mesh=self.tp_mesh)
        else:
            self.pool = KVSlotPool(cfg, n_slots, self.max_total, self.device,
                                   tp_mesh=self.tp_mesh)
        # NOT `scheduler or ...`: an empty scheduler is falsy (__len__)
        self.scheduler = scheduler if scheduler is not None else (
            RequestScheduler(max_total_tokens=self.max_total,
                             prefix_affinity_tokens=prefix_affinity_tokens,
                             tenancy=tenancy)
        )
        if self.scheduler.max_total_tokens is None:
            self.scheduler.max_total_tokens = self.max_total
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.metrics.decode_horizon = self.decode_horizon
        self.metrics.device = self.device
        if self.n_adapters and lora_parity is not True:
            if not self._probe_verdict(
                    "lora_zero", self._probe_lora_zero,
                    n_adapters=self.n_adapters, tp=self.tp,
                    max_total=self.max_total):
                log_event(_log, "lora_parity_probe_failed",
                          level=logging.WARNING, n_adapters=self.n_adapters)
                self.params = {k: v for k, v in self.params.items()
                               if k != "lora"}
                self.n_adapters = 0
        # the slots' LoRA rows: a host mirror, uploaded per dispatch
        self._slot_adapters = np.zeros((n_slots,), np.int32)

        # power-of-two prompt buckets: the largest respects the positional
        # table and the slab row count
        self._max_bucket = _max_bucket(prefill_max_bucket, cfg.max_len,
                                       self.pool.tpad)
        self._min_bucket = min(8, self._max_bucket)

        # the step program of the configured K (and, with the adaptive
        # horizon, of K 1: _step_fn_for)
        self._step_fn = build_step_program(
            fwd1, self.decode_horizon, temperature, top_k, self.device)
        self._step_fns: dict[int, object] = {}
        self._replay_fn = build_replay_program(fwd1)
        self._prefill_fn = build_prefill_program(do_prefill)
        fwd_chunk = _chunk_builder(cfg, self.tp_mesh)
        self._chunk_fn = build_chunk_program(fwd_chunk)
        self._batch_prefill_fn = build_batch_prefill_program(
            do_prefill, init_caches, self.max_total)
        self._batch_hit_fn = build_batch_hit_program(fwd_chunk)
        self._insert_fn = build_insert_program()
        self._deact_fn = build_deact_program()
        self._hit_insert_fn = build_hit_insert_program()
        self._seg_fetch_fn = build_seg_fetch_program()
        self._seg_store_fn = build_seg_store_program()
        self._logit_row_fn = build_logit_row_program()
        self._seg_import_fn = build_seg_import_program()
        #: request kinds served where the admission loop pops them
        self._host_served = {"embedding": self._serve_embedding,
                             "kv_ingest": self._serve_kv_ingest,
                             "kv_export": self._serve_kv_export,
                             "kv_session": self._serve_kv_session}
        #: the model's identity on the KV wire (see .disagg)
        self.config_hash = model_config_hash(cfg)

        # per-slot decode state, DEVICE-resident
        self._reset_device_state()
        # the master key; each admission splits a slot key off it, in
        # admission order (host-side; snapshotted per dispatch)
        self._key = threefry.key(rng_seed)
        self._slot_keys: list[threefry.Key] = [(0, 0)] * n_slots
        # piggyback engines split every plan's key when it executes, so a
        # seating deferred across horizons keeps the blocking order; a
        # requeued admission keeps its key
        self._presplit_keys: dict[str, threefry.Key] = {}

        self._slots: list[_SlotState | None] = [None] * n_slots
        self._inflight: _Inflight | None = None
        self._results_lock = wrap_lock(threading.Lock(), "engine.results")
        self._results: dict[str, np.ndarray] = {}  # guarded-by: _results_lock
        self._admitting = 0
        #: programs that computed prompt rows (bucketed prefills + chunks);
        #: probes do not count
        self.prefill_dispatches = 0
        self.last_recover_mode: str | None = None
        self._chunked_ok: bool | None = None  # replay probe memo
        self._prefix_ok_memo: bool | None = None  # hit-path probe memo
        self._disagg_ok_memo: bool | None = None  # wire seat-path memo
        #: the batch probe's verdict by (kind, bucket, padded rows)
        self.batch_verdicts: dict[tuple[str, int, int], bool] = {}
        #: where the prefix probe's two paths first differ (or None)
        self.prefix_probe_detail: str | None = None

        # partial hits reuse rows below a multiple of the largest bucket
        # (and of the block size when paged): see the module doc
        self._hit_grain = (max(self._max_bucket, self._block_size)
                           if self._paged else self._max_bucket)
        self.prefix_cache: PrefixCache | None = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                self.pool,
                (prefix_cache_tokens if prefix_cache_tokens is not None
                 else n_slots * self.pool.tpad),
                on_evict=self._on_prefix_evict,
                # branch-point segments shorter than the grain never serve
                min_seg_len=self._hit_grain,
            )

        self._piggyback = bool(piggyback)
        self.prefill_budget = max(1, int(
            prefill_budget if prefill_budget is not None
            else 2 * self._max_bucket))
        self._pending: deque[_PendingPrefill] = deque()
        self._pb_did_work = False
        self._register_gauges(piggyback)
        self._init_surface(sampling_surface, masked_parity, grammar_states,
                           grammar_cache, approx_top_k)
        # arm attribution last: everything dispatched above was a probe
        self._attr_enabled = bool(attribution)

    # -- per-program-family attribution ------------------------------------

    def _attr(self, family: str, t0: float | None = None) -> None:
        """Mark one dispatched program for attribution: ``(family, its
        dispatch stamp)`` joins the pending list, priced by
        ``_flush_attr`` at the next horizon readback that proves it
        complete (stream order). One check and one append; never a sync."""
        if self._attr_enabled and not self._attr_suspend:
            self._pending_attr.append(
                (family, t0 if t0 is not None else time.perf_counter()))

    def _flush_attr(self, t_horizon: float, now: float) -> None:
        """Attribute every pending program dispatched no later than the
        horizon just read back (``t_horizon`` its dispatch stamp): each
        gets ``now - t0``, dispatch call to proven complete, an upper bound
        that includes the host work it overlapped. The entries are in time
        order (one engine thread), so this is a prefix flush."""
        n = 0
        for family, t0 in self._pending_attr:
            if t0 > t_horizon:
                break
            self.metrics.record_program(family, now - t0)
            n += 1
        if n:
            del self._pending_attr[:n]

    # -- persisted probe verdicts ------------------------------------------

    def _probe_verdict(self, name: str, compute, **geometry) -> bool:
        """Gate one parity probe through the verdict cache (when
        configured): a verdict persisted for the same (probe, config,
        stack, geometry) skips the probe's dispatches; a fresh verdict is
        computed and persisted. ``probes_run`` / ``probes_from_cache``
        record which way each probe went."""
        key = None
        if self._probe_cache is not None:
            key = probe_key(name, self.cfg.to_json(), device=self.device,
                            **geometry)
            v = self._probe_cache.get(key)
            if v is not None:
                self.probes_from_cache.append(name)
                log_event(_log, "parity_probe_cached", probe=name, ok=v)
                return v
        v = bool(compute())
        self.probes_run.append(name)
        if self._probe_cache is not None:
            self._probe_cache.put(key, v)
        return v

    def _init_tp(self, cfg: TransformerConfig, params, tp: int, tp_parity,
                 tp_devices, prefill_max_bucket: int) -> TransformerConfig:
        """Resolve tensor parallelism before anything is built (the
        reference's, engine.py:1171-1203): ``tp`` > 1 builds the mesh
        (``tp_devices``, by default the first ``tp`` cards; ``ValueError``
        when fewer are visible) and, unless ``tp_parity`` is True, gates it
        with ``_probe_tp_parity`` through ``_probe_verdict``; on a decline
        the engine logs ``tp_parity_probe_failed`` and serves at tp 1.
        ``tp_parity=False`` serves at tp 1 outright. Returns the config the
        engine runs: the dense decode and prefill under TP (no kernel runs
        under TP; the probe's single-device side is the same dense
        program), and the caller's own config at tp 1, so a fallback
        engine runs the kernels again."""
        if tp_parity not in ("auto", True, False):
            raise ValueError(f'tp_parity is "auto", True or False, got '
                             f'{tp_parity!r}')
        self.tp = max(1, int(tp))
        self.tp_mesh = None
        #: where the TP probe's two programs first differ (or None)
        self.tp_probe_detail: str | None = None
        if self.tp == 1 or tp_parity is False:
            self.tp = 1
            return cfg
        dense = dataclasses.replace(cfg, decode_kernel=False, use_flash=False)
        mesh = model_parallel_mesh(self.tp, tp_devices)
        self.device = mesh.devices[0]
        if tp_parity is True or self._probe_verdict(
                "tp_parity",
                lambda: self._probe_tp_parity(dense, params, mesh,
                                              prefill_max_bucket),
                tp=self.tp, n_slots=self.n_slots, max_total=self.max_total,
                max_bucket=int(prefill_max_bucket)):
            self.tp_mesh = mesh
            self.cfg = dense
            return dense
        log_event(_log, "tp_parity_probe_failed", level=logging.WARNING,
                  tp=self.tp, detail=self.tp_probe_detail)
        self.tp = 1
        return cfg

    def _init_surface(self, requested: bool, masked_parity, grammar_states,
                      grammar_cache, approx_top_k: bool) -> None:
        """The sampling surface's host mirrors (written at seating,
        snapshotted per dispatch, re-seated at recovery; ``_slot_gstate``
        holds each slot's seat state, the live state is the device's
        ``_dgstate``), then the probe that arms it."""
        n = self.n_slots
        self._surface = False
        self._gtable: GrammarTable | None = None
        self.grammar_cache: GrammarCache | None = None
        self._n_logprobs = min(MAX_TOP_LOGPROBS, self.cfg.vocab_size)
        self._masked_fn = build_masked_step_program(
            self._fwd1, self.decode_horizon, self._n_logprobs)
        self._masked_fns: dict[int, object] = {}
        self._gstate_set_fn = build_gstate_set_program()
        # device copies of the grammar table, uploaded when the host
        # table's version moves (seats happen between horizons)
        self._gtab_version = -1
        self._dmask_tab = self._dtrans_tab = None
        self._slot_gstate = np.zeros((n,), np.int32)
        self._slot_temps = np.full((n,), self.temperature, np.float32)
        self._slot_topks = np.full((n,), int(self.top_k or 0), np.int32)
        self._slot_topps = np.ones((n,), np.float32)
        self._slot_bias_idx = np.full((n, MAX_LOGIT_BIAS), -1, np.int32)
        self._slot_bias_val = np.zeros((n, MAX_LOGIT_BIAS), np.float32)
        if not requested or masked_parity is False:
            return
        if approx_top_k:
            # the reference's rule: approx_max_k has no per-slot k form
            # with the same ties, so surface requests are rejected
            log_event(_log, "sampling_surface_disabled",
                      level=logging.WARNING, reason="approx_top_k")
            return
        self._gtable = GrammarTable(max(2, int(grammar_states)),
                                    self.cfg.vocab_size)
        if masked_parity is not True and not self._probe_verdict(
                "masked_parity", self._probe_masked_parity,
                n_slots=self.n_slots, max_total=self.max_total,
                max_bucket=self._max_bucket, tp=self.tp, paged=self._paged,
                piggyback=self._piggyback, temperature=self.temperature,
                top_k=self.top_k, horizon=self.decode_horizon,
                grammar_states=self._gtable.capacity,
                n_logprobs=self._n_logprobs):
            self._gtable = None
            log_event(_log, "masked_parity_probe_failed",
                      level=logging.WARNING,
                      fallback="sampling surface disabled")
            return
        self._surface = True
        self._token_bytes = default_token_bytes(self.cfg.vocab_size)
        self.grammar_cache = (grammar_cache
                              if isinstance(grammar_cache, GrammarCache)
                              else GrammarCache(grammar_cache))
        self.metrics.registry.gauge(
            "serve_grammar_table_rows",
            "Grammar DFA table rows in use (incl. the unconstrained "
            "sentinel row).").set_function(lambda: self._gtable.rows_used)

    def _register_gauges(self, piggyback: bool) -> None:
        reg = self.metrics.registry
        reg.gauge("serve_queue_depth", "Queued requests.").set_function(
            lambda: len(self.scheduler))
        reg.gauge("serve_kv_slots",
                  "KV slot pool size (decode batch width).").set_function(
            lambda: self.n_slots)
        reg.gauge("serve_decode_horizon_current",
                  "Decode substeps fused into the next horizon dispatch "
                  "(shrinks to 1 under adaptive_horizon while the queue is "
                  "non-empty).").set_function(
            lambda: self.decode_horizon_current)
        reg.gauge("serve_tp_degree",
                  "Tensor-parallel width of the serving programs (1 = "
                  "single device; a failed parity probe falls back to 1)."
                  ).set_function(lambda: self.tp)
        reg.gauge("serve_lora_adapters",
                  "Rows in the batched-LoRA adapter bank (0 = base only; "
                  "row 0 is always the zero adapter).").set_function(
            lambda: self.n_adapters)
        if self.tenancy is not None:
            reg.gauge("serve_tenants", "Configured tenants in the registry."
                      ).set_function(lambda: len(self.tenancy))
            # per-tenant SLOs: every render derives
            # serve_tenant_slo_burn{tenant} from the observed p99s
            for tid in self.tenancy.tenant_ids():
                t = self.tenancy.get(tid)
                if t.slo_p99_tpot_s is not None:
                    self.metrics.set_tenant_slo(tid, t.slo_p99_tpot_s)
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
                      "KV blocks held by slot tables or cached segments."
                      ).set_function(lambda: self.pool.n_blocks_in_use)
            reg.gauge("serve_kv_block_size",
                      "Rows per KV block (paged layout granule)."
                      ).set_function(lambda: self.pool.block_size)
        if piggyback:
            reg.gauge("serve_prefill_budget_tokens",
                      "Chunk tokens the piggyback scheduler may spend per "
                      "decode horizon (--prefill-budget).").set_function(
                lambda: self.prefill_budget)
            reg.gauge("serve_prefill_pending",
                      "Admissions whose prefill is deferred across "
                      "horizons (holding a slot, not yet seated)."
                      ).set_function(lambda: len(self._pending))
        pc = self.prefix_cache
        if pc is not None:
            reg.gauge("serve_prefix_segments", "Cached prefix segments."
                      ).set_function(lambda: pc.n_segments)
            reg.gauge("serve_prefix_segments_pinned",
                      "Segments pinned by in-flight requests (not "
                      "evictable).").set_function(lambda: pc.n_pinned)
            reg.gauge("serve_prefix_tokens_cached",
                      "Prompt tokens held in cached segments."
                      ).set_function(lambda: pc.tokens_cached)
            reg.gauge("serve_prefix_capacity_tokens",
                      "Prefix-cache capacity in tokens.").set_function(
                lambda: pc.capacity_tokens)
            reg.gauge("serve_prefix_region_bytes",
                      "Device bytes of the prefix-cache segments."
                      ).set_function(lambda: pc.nbytes())

    def _on_prefix_evict(self, seg: Segment) -> None:
        self.metrics.record_prefix_eviction()
        self.tracer.instant(ENGINE_TRACK, "prefix_evict", length=seg.length)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, pinned and non-blocking on
        CUDA (a pageable upload would wait for every horizon queued ahead
        of it)."""
        return upload(arr, self.device)

    def _reset_device_state(self) -> None:
        """Fresh per-slot device state: pending logits, positions, active
        bits, budgets, EOS ids and grammar states."""
        n, dev = self.n_slots, self.device
        self._logits = torch.zeros((n, self.cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
        self._dpos = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._dactive = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._dbudget = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._deos = torch.full((n,), _NO_EOS, dtype=torch.int32,
                                device=dev)
        self._dgstate = torch.zeros((n,), dtype=torch.int32, device=dev)

    # -- buckets -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        """Smallest power-of-two bucket >= n (n <= max bucket)."""
        b = self._min_bucket
        while b < n:
            b *= 2
        return b

    def _chunk_schedule(self, n: int, start: int = 0
                        ) -> list[tuple[int, int, int]]:
        """(offset, real_len, bucket) chunks covering a prompt's rows
        start..n-1 through the bucket sizes. Every write window [offset,
        offset+bucket) fits Tpad: when a padded tail would spill, the
        remainder is cut into exact power-of-two pieces plus one minimal
        padded tail. ``start`` > 0 is a partial hit's suffix: the caller
        aligns it to the hit grain, so its windows are the ones the same
        prompt's schedule from 0 takes from ``start`` on."""
        if start % self._min_bucket:
            raise AssertionError(
                f"chunk start {start} not {self._min_bucket}-aligned")
        tpad = self.pool.tpad
        sched, t0, rem = [], start, n - start
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
        """Queue a request; raises ``Backpressure`` (``QuotaExceeded`` when
        its tenant's bucket is dry) or ``AdmissionError``. Rejections are
        labelled by tenant and reason in the metrics."""
        if req.adapter >= max(1, self.n_adapters):
            raise AdmissionError(
                f"request {req.id}: adapter {req.adapter} outside the "
                f"loaded bank ({self.n_adapters} adapters)")
        if len(req.prompt) and int(req.prompt.max()) >= self.cfg.vocab_size:
            raise AdmissionError(
                f"request {req.id}: token id outside the vocabulary "
                f"({self.cfg.vocab_size})")
        if len(req.prompt) and int(req.prompt.min()) < 0:
            raise AdmissionError(f"request {req.id}: negative token id")
        if req.uses_sampling_surface:
            self._check_surface_request(req)
        try:
            rid = self.scheduler.submit(req)
        except Backpressure as e:
            reason = ("quota" if isinstance(e, QuotaExceeded)
                      else "backpressure")
            self.metrics.record_backpressure()
            self.metrics.record_rejection(reason, tenant=req.tenant_id)
            self.tracer.instant(SCHEDULER_TRACK, "backpressure",
                                req_id=req.id)
            log_event(_log, "request_rejected", level=logging.DEBUG,
                      req_id=req.id, reason=reason,
                      tenant=req.tenant_id or None)
            raise
        self.tracer.instant(SCHEDULER_TRACK, "submit", req_id=rid)
        log_event(_log, "request_submitted", level=logging.DEBUG,
                  req_id=rid, prompt_len=len(req.prompt),
                  max_new=req.max_new, tenant=req.tenant_id or None,
                  trace_id=req.trace_id or None)
        return rid

    def _check_surface_request(self, req: Request) -> None:
        """Submit-time checks of a request that uses the sampling surface;
        compiles (or finds) its grammar."""
        if not self._surface:
            raise AdmissionError(
                f"request {req.id}: sampling-surface fields (temperature/"
                f"top_k/top_p/stop/logit_bias/logprobs/response_format) "
                f"need an engine built with sampling_surface=True")
        if req.response_format is None:
            return
        if req.eos_token is None:
            raise AdmissionError(
                f"request {req.id}: response_format requires eos_token "
                f"(grammars terminate by permitting EOS in accepting "
                f"states)")
        kind, spec = parse_response_format(req.response_format)
        try:
            cg, how = self.grammar_cache.get_or_compile(
                kind, spec, self._token_bytes, req.eos_token,
                max_states=self._gtable.capacity - 1)
        except GrammarError as e:
            self.metrics.record_grammar_compile("error")
            raise AdmissionError(f"request {req.id}: {e}") from None
        self.metrics.record_grammar_compile(how)
        req._grammar = cg

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
        """No request queued, mid-admission, deferred, decoding or
        awaiting readback (a deferred admission holds its slot)."""
        return (self.pool.n_active == 0 and self._admitting == 0
                and len(self.scheduler) == 0 and self._inflight is None)

    @property
    def hit_grain(self) -> int:
        """The shortest prompt whose KV a full hit reuses: the largest
        prefill bucket (and block size when paged). A wire segment
        shorter than this is declined as not seatable."""
        return self._hit_grain

    def cancel(self, req_id: str) -> bool:
        """Cancel a queued, deferred or decoding request (honored within
        one horizon); False when the id is unknown."""
        for st in self._slots:
            if st is not None and st.req.id == req_id:
                st.req.cancel()
                return True
        for rec in self._pending:
            if rec.plan.req.id == req_id:
                rec.plan.req.cancel()
                return True
        return self.scheduler.cancel(req_id)

    def preempt_all(self) -> int:
        """Cancel every live, deferred and queued request; returns how
        many."""
        n = 0
        reqs = [st.req for st in self._slots if st is not None]
        reqs += [rec.plan.req for rec in self._pending]
        for req in reqs:
            if not req.cancelled:
                req.cancel()
                n += 1
        return n + self.scheduler.cancel_all()

    # -- retirement ----------------------------------------------------------

    def _store_result(self, req: Request, tokens: list[int]) -> None:
        stream = np.concatenate([req.prompt, np.asarray(tokens, np.int32)])  # lint: sync-ok host token list
        with self._results_lock:
            note_access("engine.results", write=True)
            self._results[req.id] = stream
            while len(self._results) > self.results_cap:
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
            self.metrics.record_finished(len(st.tokens), decode_s,
                                         tenant=req.tenant_id)
            if st.t_first_token is not None and req.arrival_time is not None:
                req.timing = {"ttft_s": st.t_first_token - req.arrival_time,
                              "decode_s": decode_s}
        else:
            self.metrics.record_outcome(status, tenant=req.tenant_id)
        self.pool.release(slot)
        if self.prefix_cache is not None:
            for seg in st.segs:
                self.prefix_cache.unpin(seg)
        st.segs = []
        if self._surface:
            if st.stop_matcher is not None and req.stream is not None:
                # release the hold-back before the end-of-stream sentinel
                # (empty when a stop match consumed it)
                for t in st.stop_matcher.flush():
                    req.stream.put(t)
            self._clear_surface(slot, st)
        self._slots[slot] = None
        self._slot_adapters[slot] = 0
        if deactivate:
            self._dactive = self._deact_fn(self._dactive, slot)
        self.tracer.instant(slot_track(slot), status.value, ts=now,
                            req_id=req.id, n_tokens=len(st.tokens))
        log_event(_log, "request_retired", req_id=req.id, slot=slot,
                  status=status.value, n_tokens=len(st.tokens), error=error,
                  tenant=req.tenant_id or None,
                  trace_id=req.trace_id or None)
        if req.stream is not None:
            req.stream.put(None)  # end-of-stream sentinel
        if req.done is not None:
            req.done.set()

    def _retire_unadmitted(self, req: Request, status: RequestStatus,
                           error: str | None = None) -> None:
        self._presplit_keys.pop(req.id, None)
        req.status = status
        req.error = error
        self.metrics.record_outcome(status, tenant=req.tenant_id)
        self.tracer.instant(SCHEDULER_TRACK, status.value, req_id=req.id)
        log_event(_log, "request_retired", req_id=req.id, slot=None,
                  status=status.value, n_tokens=0, error=error,
                  tenant=req.tenant_id or None,
                  trace_id=req.trace_id or None)
        if req.stream is not None:
            req.stream.put(None)  # end-of-stream sentinel
        if req.done is not None:
            req.done.set()

    def _serve_embedding(self, req, now: float) -> None:
        """Serve an :class:`~.scheduler.EmbeddingRequest` on the host at
        the admission boundary (the reference's, engine.py:2556): no KV
        slot and no device dispatch, a table lookup, with the request's
        whole lifecycle (scheduler pop, per-tenant metrics, trace, log,
        ``done``)."""
        t0 = time.perf_counter()
        emb = self.embedders.get(req.model)
        if emb is None:
            req.status = RequestStatus.FAILED
            req.error = (f"unknown embedding model {req.model!r} "
                         f"(loaded: {sorted(self.embedders) or 'none'})")
            self.metrics.record_outcome(RequestStatus.FAILED)
        else:
            vectors = {}
            for w in req.words:
                v = emb.get_word_vector(w)
                vectors[w] = None if v is None else np.asarray(v)
            req.result = vectors
            req.status = RequestStatus.FINISHED
            self.metrics.record_embedding(
                req.model, len(req.words), time.perf_counter() - t0,
                tenant=req.tenant_id)
        self.tracer.instant(SCHEDULER_TRACK, "embedding", req_id=req.id,
                            model=req.model, n_words=len(req.words))
        log_event(_log, "request_retired", req_id=req.id, slot=None,
                  status=req.status.value, n_tokens=0, error=req.error,
                  tenant=req.tenant_id or None, kind="embedding")
        if req.done is not None:
            req.done.set()

    # -- the KV wire ---------------------------------------------------------
    #
    # A PREFILL replica serves KVExportRequests: the prompt is prefilled
    # into a slot held for the export through the same admission programs
    # a monolithic admission runs (which makes the transfer byte-exact by
    # construction), the segment and the pending logits row are copied to
    # the host, and the slot is released without decoding. A DECODE
    # replica serves KVIngestRequests: the decoded slab is checked against
    # its own cache geometry and landed in the prefix cache (a region copy
    # in slab mode, private blocks paged), so the follow-up generate
    # full-hits with no prefill program. Both sides are gated by the
    # disagg probe (``_disagg_ok``), and every ingest decline is soft.

    def _slot_to_host(self, slot: int):
        """(cache leaves, (1, V) logits row) of one slot, copied to host
        memory before the caller frees the slot (the programs here write
        the pool in place: the next admission would overwrite the rows).
        The leaves are batch-1 slabs in key order, ``kv`` then ``scale``
        for int8: the reference's ``jax.tree.leaves`` order."""
        if self._paged:
            slab = paged_slot_gather(self.pool.caches,
                                     self.pool.table_row(slot))
        else:
            slab = self.pool.slab(slot)
        # copy=True: on the CPU ``to`` would return the pool's own rows;
        # a TP slab is whole again first (rank order is head order, so the
        # frame is the single-device frame)
        leaves = [t.to("cpu", copy=True)
                  for t in kv_leaves(unshard_cache(slab))]
        return leaves, self._logit_row_fn(self._logits, slot).to("cpu")

    def _wire_layout(self, leaves) -> dict:
        """The wire fields of a segment's host leaves: block-list leaves
        and the block size when paged."""
        if self._paged:
            return {"leaves": slab_to_blocks(leaves, self._block_size),
                    "layout": "paged", "block_size": self._block_size}
        return {"leaves": leaves, "layout": "slab", "block_size": 0}

    def _trace_ctx(self, req) -> dict:
        """Span fields joining the request's trace (a fresh span id, the
        upstream span as parent), or none when untraced."""
        if not (self.tracer.enabled and req.trace_id):
            return {}
        tctx = {"trace_id": req.trace_id, "span_id": new_span_id()}
        if req.parent_span_id:
            tctx["parent_span_id"] = req.parent_span_id
        return tctx

    def _serve_kv_export(self, req, now: float) -> None:
        """Serve a :class:`~.scheduler.KVExportRequest` (the reference's,
        engine.py:2609): ``req.result`` gets the segment's host leaves,
        logits row and layout, ready for :func:`~.disagg.encode_segment`
        (framing happens on the HTTP thread)."""
        t0 = time.perf_counter()
        seq = np.asarray(req.prompt, np.int32)
        n = int(len(seq))
        if not self._disagg_ok():
            self._retire_unadmitted(
                req, RequestStatus.FAILED,
                "disagg wire parity probe failed on this backend")
            return
        if n + 1 > self.max_total or n > self.pool.tpad:
            self._retire_unadmitted(
                req, RequestStatus.FAILED,
                f"prompt of {n} tokens cannot be exported "
                f"(max_total={self.max_total}, tpad={self.pool.tpad})")
            return
        slot = self.pool.acquire()
        try:
            self._prefill_seq_into_slot(seq, slot, 1, _NO_EOS)
            leaves, lg = self._slot_to_host(slot)
        except BaseException:
            # a crash must not drop the popped request
            self.pool.release(slot)
            self.scheduler.requeue(req)
            raise
        # the slot was a staging area: clear the active bit the insert set
        self._dactive = self._deact_fn(self._dactive, slot)
        self.pool.release(slot)
        req.result = {"config_hash": self.config_hash, "tokens": seq,
                      "logits": lg, **self._wire_layout(leaves)}
        req.status = RequestStatus.FINISHED
        nbytes = (sum(t.numel() * t.element_size() for t in leaves)
                  + lg.numel() * lg.element_size())
        self.metrics.record_kv_export(n, nbytes, time.perf_counter() - t0,
                                      tenant=req.tenant_id)
        # an admission span named "prefill" (prefix "export"), so the
        # merged fleet trace chains dispatch -> export -> transfer ->
        # ingest; its id rides the result for the transfer span's parent
        tctx = self._trace_ctx(req)
        if tctx:
            req.result["span_id"] = tctx["span_id"]
        self.tracer.span(SCHEDULER_TRACK, "prefill", t0,
                         time.perf_counter() - t0, req_id=req.id,
                         prompt_len=n, prefix="export", nbytes=nbytes,
                         **tctx)
        log_event(_log, "request_retired", req_id=req.id, slot=None,
                  status=req.status.value, n_tokens=n, error=None,
                  tenant=req.tenant_id or None, kind="kv_export")
        if req.done is not None:
            req.done.set()

    def _serve_kv_ingest(self, req, now: float) -> None:
        """Seat a wire segment (``req.segment``, a
        :func:`~.disagg.decode_segment` dict) in the prefix cache so the
        follow-up generate full-hits (the reference's, engine.py:2700).
        Slotless and soft: a decline reports ``{"stored": False,
        "reason"}``."""
        t0 = time.perf_counter()
        seg_data = req.segment
        tokens = np.asarray(seg_data["tokens"], np.int32)
        n = int(len(tokens))
        reason = None
        if self.prefix_cache is None:
            reason = "no prefix cache on this replica"
        elif seg_data.get("config_hash") != self.config_hash:
            reason = "model config hash mismatch"
        elif n < self._hit_grain or n > self.pool.tpad:
            reason = (f"segment of {n} tokens not seatable "
                      f"(grain={self._hit_grain}, tpad={self.pool.tpad})")
        elif not (self._prefix_reuse_ok() and self._disagg_ok()):
            reason = "parity probes reject wire seating on this backend"
        stored = False
        if reason is None:
            try:
                slab, lg = self._wire_slab(seg_data)
            except WireError as e:
                reason = str(e)
            else:
                stored, reason = self._seat_wire_segment(tokens, slab, lg)
        req.result = {"stored": stored, "reason": reason, "n_tokens": n}
        req.status = RequestStatus.FINISHED
        self.metrics.record_kv_ingest(
            n, int(seg_data.get("nbytes", 0)), time.perf_counter() - t0,
            stored=stored, tenant=req.tenant_id)
        self.tracer.span(SCHEDULER_TRACK, "kv_ingest", t0,
                         time.perf_counter() - t0, req_id=req.id,
                         n_tokens=n, stored=stored, **self._trace_ctx(req))
        log_event(_log, "request_retired", req_id=req.id, slot=None,
                  status=req.status.value, n_tokens=n,
                  error=None if stored else reason,
                  tenant=req.tenant_id or None, kind="kv_ingest")
        if req.done is not None:
            req.done.set()

    def _wire_slab(self, seg_data: dict):
        """A decoded frame's slab and logits row checked against this
        engine's cache geometry and uploaded: (the batch-1 caches operand,
        the (1, V) f32 logits on the device). ``WireError`` (400) on any
        disagreement: after the hash check, a corrupt or hand-made
        frame."""
        specs = kv_leaves(unshard_cache(self._init_caches(
            1, self.max_total, torch.device("meta"))))
        leaves = seg_data["leaves"]
        if len(leaves) != len(specs):
            raise WireError(f"frame has {len(leaves)} cache leaves, engine "
                            f"expects {len(specs)}")
        up = []
        for i, (arr, spec) in enumerate(zip(leaves, specs)):
            t = _as_tensor(arr)
            if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
                raise WireError(f"leaf {i} is {t.dtype}{tuple(t.shape)}, "
                                f"engine expects "
                                f"{spec.dtype}{tuple(spec.shape)}")
            up.append(t.to(self.device))
        lg = _as_tensor(seg_data["logits"])
        if (tuple(lg.shape) != (1, self.cfg.vocab_size)
                or lg.dtype != torch.float32):
            raise WireError(f"logits are {lg.dtype}{tuple(lg.shape)}, "
                            f"engine expects float32(1, "
                            f"{self.cfg.vocab_size})")
        slab = {"kv": up[0], "scale": up[1]} if len(up) == 2 else up[0]
        if self.tp_mesh is not None:
            slab = shard_cache(self.tp_mesh, slab,
                               serving_tp_cache_sharding(self.tp_mesh,
                                                         self.cfg))
        return slab, lg.to(self.device)

    def _seat_wire_segment(self, tokens: np.ndarray, slab, lg
                           ) -> tuple[bool, str | None]:
        """Insert ``tokens`` in the prefix cache and back every new segment
        with the wire slab's rows; ``(stored, reason)``, ``stored`` when
        the whole prompt is seated with its logits row (a full hit)."""
        cache = self.prefix_cache
        n = int(len(tokens))
        seg, matched = cache.lookup(tokens)
        if seg is not None and matched == n and seg.logits is not None:
            return True, "already cached"
        segs = cache.insert(tokens)
        if not segs:
            return False, "cache declined (all segments pinned)"
        stored = False
        for seg in segs:
            if self._paged:
                if not self._back_paged_wire_segment(seg, slab):
                    # blocks lost to admission pressure: un-cache rather
                    # than leave a segment without rows
                    cache.drop(seg)
                    continue
            else:
                self._seg_import_fn(cache.region, slab, seg.slot)
            if seg.length == n:
                seg.logits = lg
                stored = True
            # the donor's rows came from the chunk windows iff its prompt
            # exceeds one bucket, on the prefill replica as here
            seg.partial_ok = n > self._max_bucket
            self.metrics.record_prefix_insert()
            self.tracer.instant(ENGINE_TRACK, "prefix_insert", source="wire",
                                length=seg.length)
            cache.unpin(seg)
        return stored, None if stored else "segment backing failed"

    def _back_paged_wire_segment(self, seg: Segment, slab) -> bool:
        """Back one paged wire segment with fresh private blocks holding
        the slab's rows (no donor slot to alias); False when the blocks do
        not fit."""
        need = self.pool.blocks_needed(seg.length)
        try:
            ids = self.pool.alloc_blocks(need)
        except RuntimeError:
            return False
        paged_slot_scatter(self.pool.caches, self._block_row(ids), slab)
        seg.block_ids = ids
        return True

    def _serve_kv_session(self, req, now: float) -> None:
        """Seat a live migrated session (a
        :class:`~.scheduler.KVSessionRequest`, the reference's
        engine.py:2849) in a fresh slot mid-generation: the wire slab
        covers rows [0, prompt + generated), seated at that position with
        the remaining budget (the full-hit insert of the sequence so far),
        and the decode loop continues the stream. The session's key words
        are installed verbatim and this engine's master key is not split:
        the slot continues the source's stream, and this engine's own
        admissions keep their keys. Declines are soft (``result["seated"]
        is False``)."""
        t0 = time.perf_counter()
        seg_data = req.segment
        n0 = int(len(req.prompt))
        g = len(req.gen_tokens)
        m = n0 + g
        budget = int(req.max_new) - g
        kd = [int(w) for w in np.asarray(
            () if req.key_data is None else req.key_data).reshape(-1)]
        reason = None
        if seg_data.get("config_hash") != self.config_hash:
            reason = "model config hash mismatch"
        elif not self._disagg_ok():
            reason = "disagg wire parity probe failed on this backend"
        elif int(len(seg_data["tokens"])) != m:
            reason = (f"frame covers {len(seg_data['tokens'])} tokens, "
                      f"session claims prompt {n0} + generated {g}")
        elif n0 + int(req.max_new) > self.max_total or m > self.pool.tpad:
            reason = (f"session of {m} tokens / budget {req.max_new} does "
                      f"not fit (max_total={self.max_total}, "
                      f"tpad={self.pool.tpad})")
        elif budget < 1:
            reason = "session has no remaining budget"
        elif len(kd) != 2 or not all(0 <= w <= 0xFFFFFFFF for w in kd):
            reason = f"sampling key has {len(kd)} words, engine uses 2"
        if reason is None:
            try:
                slab, lg = self._wire_slab(seg_data)
            except WireError as e:
                reason = str(e)
        if reason is not None:
            req.result = {"seated": False, "reason": reason}
            self.metrics.record_migration_in(
                g, time.perf_counter() - t0, seated=False,
                tenant=req.tenant_id)
            self.flight.record("migrate_declined", req_id=req.id,
                               reason=reason)
            self._retire_unadmitted(req, RequestStatus.FAILED, reason)
            return
        slot = self.pool.acquire()
        try:
            if self._paged:
                self._paged_ensure_blocks(slot, m + budget)
            self.pool.write_slab(slot, slab)
            self._insert_fn(*self._state(), lg, slot, m, budget,
                            _eos_of(req))
        except BaseException:
            self.pool.release(slot)
            self.scheduler.requeue(req)
            raise
        key = (kd[0], kd[1])
        self._slot_keys[slot] = key
        self._slot_adapters[slot] = req.adapter
        st = _SlotState(req, self.pool.generation(slot), key)
        st.tokens = list(req.gen_tokens)
        st.t_first_token = now if g else None
        if self._surface:
            self._seat_surface(slot, st, req)
        self._slots[slot] = st
        req.status = RequestStatus.RUNNING
        req.result = {"seated": True, "n_tokens": m}
        self.metrics.record_migration_in(g, time.perf_counter() - t0,
                                         seated=True, tenant=req.tenant_id)
        self.tracer.span(slot_track(slot), "migrate_in", t0,
                         time.perf_counter() - t0, req_id=req.id,
                         n_tokens=m, **self._trace_ctx(req))
        self.flight.record("migrate_seated", req_id=req.id, slot=slot,
                           n_generated=g, budget=budget,
                           tenant=req.tenant_id or None)
        log_event(_log, "session_seated", req_id=req.id, slot=slot,
                  prompt_len=n0, n_generated=g, budget=budget,
                  tenant=req.tenant_id or None)

    # -- live session migration ---------------------------------------------
    #
    # The server can export each live slot as a KV frame with its
    # generation state (tokens so far, budget, key words) and re-seat it on
    # another replica mid-generation. The exported rows [0, prompt +
    # generated) are what a replay of prompt + tokens rebuilds, the pending
    # logits row is the next token's input, and fold_in(key, position)
    # needs only the key words and the position: the continuation is the
    # same stream, greedy and sampled.

    def export_sessions(self) -> list[dict]:
        """Snapshot every live slot for migration and free it with no
        terminal status (the request stays RUNNING, parked, until
        :meth:`complete_migrated` or :meth:`fail_migrated` settles it).
        Engine-loop thread only. The in-flight horizon is processed first,
        so tokens so far and the logits row agree. A slot whose snapshot
        fails stays live; slots using the sampling surface stay local."""
        if self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            self._process(inflight)
        now = time.perf_counter()
        out: list[dict] = []
        for slot, st in enumerate(self._slots):
            if st is None or st.req.kind not in ("generate", "kv_session"):
                continue
            req = st.req
            if req.cancelled or req.expired(now):
                continue  # the lifecycle sweep owns these
            if req.uses_sampling_surface:
                # grammar state, stop hold-back and bias rows do not
                # travel on the wire: these drain locally
                continue
            t0 = time.perf_counter()
            try:
                leaves, lg = self._slot_to_host(slot)
            except Exception as e:  # keep exporting the others
                self.flight.record("migrate_export_failed", req_id=req.id,
                                   slot=slot, error=str(e))
                continue
            out.append({
                "req": req,
                "n_streamed": len(st.tokens),
                "config_hash": self.config_hash,
                "tokens": np.concatenate(
                    [req.prompt, np.asarray(st.tokens, np.int32)]),
                "logits": lg,
                **self._wire_layout(leaves),
                "gen": {
                    "n_prompt": int(len(req.prompt)),
                    "tokens": [int(t) for t in st.tokens],
                    "max_new": int(req.max_new),
                    "eos_token": (None if req.eos_token is None
                                  else int(req.eos_token)),
                    "adapter": int(req.adapter),
                    "key_data": [int(w) for w in st.key_data],
                    "req_id": req.id,
                },
            })
            # park: free the slot with no terminal status
            self.pool.release(slot)
            if self.prefix_cache is not None:
                for seg in st.segs:
                    self.prefix_cache.unpin(seg)
            st.segs = []
            if self._surface:
                self._clear_surface(slot, st)
            self._slots[slot] = None
            self._slot_adapters[slot] = 0
            self._dactive = self._deact_fn(self._dactive, slot)
            self.metrics.record_migration_out(
                len(st.tokens), time.perf_counter() - t0,
                tenant=req.tenant_id)
            self.tracer.instant(slot_track(slot), "migrate_out",
                                req_id=req.id, n_tokens=len(st.tokens))
            self.flight.record("migrate_out", req_id=req.id, slot=slot,
                               n_generated=len(st.tokens),
                               tenant=req.tenant_id or None)
            log_event(_log, "session_exported", req_id=req.id, slot=slot,
                      n_generated=len(st.tokens),
                      tenant=req.tenant_id or None)
        return out

    def complete_migrated(self, req: Request, tokens,
                          n_streamed: int = 0) -> None:
        """Settle a parked request with the destination's finished stream
        (prompt + every generated token). Any thread may call it: the slot
        is long freed."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        new = [int(t) for t in toks[len(req.prompt):]]
        req.status = RequestStatus.FINISHED
        req.error = None
        self._store_result(req, new)
        self.metrics.record_migration_settled(ok=True, tenant=req.tenant_id)
        self.flight.record("migrate_settled", req_id=req.id, ok=True,
                           n_generated=len(new))
        log_event(_log, "request_retired", req_id=req.id, slot=None,
                  status=req.status.value, n_tokens=len(new), error=None,
                  tenant=req.tenant_id or None, kind="migrated")
        if req.stream is not None:
            for t in new[int(n_streamed):]:
                req.stream.put(t)
            req.stream.put(None)  # end-of-stream sentinel
        if req.done is not None:
            req.done.set()

    def fail_migrated(self, req: Request, error: str, partial=None) -> None:
        """Settle a parked request whose migration did not land: CANCELLED
        with the tokens generated before the export (the drain's preempt
        outcome)."""
        req.status = RequestStatus.CANCELLED
        req.error = error
        self._store_result(req, [int(t) for t in (partial or ())])
        self.metrics.record_migration_settled(ok=False, tenant=req.tenant_id)
        self.flight.record("migrate_settled", req_id=req.id, ok=False,
                           error=error)
        log_event(_log, "request_retired", req_id=req.id, slot=None,
                  status=req.status.value, n_tokens=0, error=error,
                  tenant=req.tenant_id or None, kind="migrated")
        if req.stream is not None:
            req.stream.put(None)  # end-of-stream sentinel
        if req.done is not None:
            req.done.set()

    def _drop_pending(self, rec: _PendingPrefill, status: RequestStatus,
                      error: str | None = None) -> None:
        """Release a deferred admission's slot and pinned segment and
        retire its request without seating it."""
        pl = rec.plan
        if pl.seg is not None and self.prefix_cache is not None:
            self.prefix_cache.unpin(pl.seg)
            pl.seg = None
        self.pool.release(pl.slot)
        self._retire_unadmitted(pl.req, status, error)

    def fail_all(self, error: str) -> None:
        """Fail every live, deferred and queued request (slot freed,
        ``done`` set). Device state is left as it is: nothing will be
        dispatched to it again."""
        now = time.perf_counter()
        self._inflight = None
        while self._pending:
            self._drop_pending(self._pending.popleft(), RequestStatus.FAILED,
                               error)
        for slot, st in enumerate(self._slots):
            if st is not None:
                self._retire(slot, RequestStatus.FAILED, now, error=error)
        while (req := self.scheduler.pop()) is not None:
            self._retire_unadmitted(req, RequestStatus.FAILED, error)

    def _slot_of(self, req_id: str | None) -> int | None:
        if req_id is None:
            return None
        for slot, st in enumerate(self._slots):
            if st is not None and st.req.id == req_id:
                return slot
        return None

    # lint: hot-path
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
        # a deferred admission holds a slot too: sweep it on the same
        # cadence
        if self._pending:
            kept: deque[_PendingPrefill] = deque()
            for rec in self._pending:
                req = rec.plan.req
                if req.cancelled or req.expired(now):
                    self._drop_pending(rec, RequestStatus.CANCELLED
                                       if req.cancelled
                                       else RequestStatus.EXPIRED)
                else:
                    kept.append(rec)
            self._pending = kept

    # -- admission: rows -------------------------------------------------------

    def _state(self):
        return (self.pool.operand(), self._logits, self._dpos, self._dactive,
                self._dbudget, self._deos)

    def _adapter_row(self, adapter: int):
        """A (1,) LoRA row operand for a batch-1 program; None for adapter
        0 (its rows select the base activations: the same bits)."""
        if not adapter:
            return None
        return self._upload(np.array([adapter], np.int32))

    def _compute_rows(self, slab, seq: np.ndarray, start: int = 0,
                      adapter: int = 0):
        """Compute rows [start, n) of ``seq`` into the batch-1 ``slab``
        (written in place; rows below ``start`` must hold the prefix) and
        return the (1, V) logits of its last row. A whole prompt of at most
        one bucket takes one bucketed prefill (kernel #1 when ``use_flash``);
        anything else the chunk windows of ``_chunk_schedule`` — a prompt
        longer than a bucket takes the same windows from 0 as from a
        grain-aligned ``start``. An empty prompt gives uniform logits.
        ``adapter`` is the LoRA row the rows are computed with."""
        n = int(len(seq))
        ad = self._adapter_row(adapter)
        if start == 0 and 0 < n <= self._max_bucket:
            b = self._bucket_for(n)
            pad = np.zeros((1, b), np.int64)
            pad[0, :n] = seq
            fam = "paged_prefill" if self._paged else "prefill"
            self.program_keys[fam].add(b)
            self._attr(fam)
            slab, lg = self._prefill_fn(self.params, slab, self._upload(pad),
                                        n - 1, ad)
            self.prefill_dispatches += 1
            return lg
        lg = torch.zeros((1, self.cfg.vocab_size), dtype=torch.float32,
                         device=self.device)
        for t0, ln, b in (self._chunk_schedule(n, start) if n else ()):
            pad = np.zeros((1, b), np.int64)
            pad[0, :ln] = seq[t0:t0 + ln]
            self.program_keys["chunk"].add(b)
            self._attr("chunk")
            slab, lg = self._chunk_fn(self.params, slab, self._upload(pad),
                                      t0, ln - 1, ad)
            self.prefill_dispatches += 1
        return lg

    def _paged_ensure_blocks(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s block coverage to ``n_tokens`` rows (clamped to
        Tpad) with fresh private blocks; a no-op when covered (aliased
        prefix entries stay)."""
        n_tokens = min(int(n_tokens), self.pool.tpad)  # lint: sync-ok host int
        need = self.pool.blocks_needed(n_tokens)
        have = int(np.count_nonzero(self.pool.table(slot)))
        if need > have:
            self.pool.alloc_slot_blocks(slot, n_tokens, start=have)

    def _prefill_seq_into_slot(self, seq: np.ndarray, slot: int, budget: int,
                               eos_tok: int, adapter: int = 0) -> None:
        """The miss path: land ``seq`` (a prompt, or prompt + replayed
        tokens) in ``slot`` and seat the slot's device state at position
        ``len(seq)`` with ``budget`` tokens left. The rows are computed at
        batch 1 into the slab the pool hands out and the pool lands it.
        Paged: the slot's blocks (every row it can write) come first."""
        if self._paged:
            self._paged_ensure_blocks(slot, len(seq) + budget)
        slab = self.pool.prefill_slab(slot)
        lg = self._compute_rows(slab, seq, adapter=adapter)
        self.pool.land(slot, slab)
        self._insert_fn(*self._state(), lg, slot, int(len(seq)), budget,
                        eos_tok)

    def _check_prefill_faults(self, req: Request) -> bool:
        """The admission fault boundary, one check per admission, under
        transient-retry supervision. False when the request is poisoned
        (the caller fails it); ``EngineCrash`` propagates."""
        if self.faults is None:
            return True
        attempt, backoff = 0, self.retry_backoff_s
        while True:
            try:
                self.faults.check("prefill", req_id=req.id)
                return True
            except TransientFault as e:
                self.metrics.record_retry()
                attempt += 1
                if attempt > self.max_retries:
                    req.error = (f"transient prefill fault persisted past "
                                 f"{self.max_retries} retries: {e}")
                    return False
                time.sleep(backoff)
                backoff = min(backoff * 2, self.max_backoff_s)
            except PermanentFault as e:
                req.error = str(e)
                return False

    # -- admission: prefix cache -----------------------------------------------

    def _prefix_reuse_ok(self) -> bool:
        if self.prefix_cache is None:
            return False
        if self._prefix_ok_memo is None:
            self._prefix_ok_memo = self._probe_verdict(
                "prefix_reuse", self._probe_prefix_parity,
                n_slots=self.n_slots, max_total=self.max_total,
                min_bucket=self._min_bucket, tpad=self.pool.tpad,
                tp=self.tp, hit_grain=self._hit_grain)
            log_event(_log, "prefix_parity_probe",
                      level=(logging.INFO if self._prefix_ok_memo
                             else logging.WARNING),
                      ok=self._prefix_ok_memo,
                      detail=self.prefix_probe_detail)
            self.tracer.instant(ENGINE_TRACK, "prefix_parity_probe",
                                ok=self._prefix_ok_memo)
        return self._prefix_ok_memo

    def _batch_admission_ok(self, kind: str, bucket: int, nb: int) -> bool:
        """Batched admission's gate for one program geometry: ``kind``
        ("miss" or "hit"), the bucket and the padded row count. Off in
        paged engines (their admissions land through the pool's tables
        one slot at a time, as in the reference) and with
        ``batch_admission=False``; True trusts the programs; "auto" asks
        the probe once for each geometry, since a library may pick its
        matmul by the row count and so round one geometry and not
        another."""
        if self._paged or self.batch_admission is False:
            return False
        if self.batch_admission is True:
            return True
        key = (kind, bucket, nb)
        if key not in self.batch_verdicts:
            ok = self._probe_verdict(
                "batch_admission",
                lambda: self._probe_batch_parity(kind, bucket, nb),
                n_slots=self.n_slots, max_total=self.max_total,
                tpad=self.pool.tpad, hit_grain=self._hit_grain, tp=self.tp,
                kind=kind, bucket=bucket, rows=nb)
            self.batch_verdicts[key] = ok
            log_event(_log, "batch_parity_probe", ok=ok, kind=kind,
                      bucket=bucket, rows=nb)
            self.tracer.instant(ENGINE_TRACK, "batch_parity_probe", ok=ok)
        return self.batch_verdicts[key]

    def _classify_plan(self, pl: _AdmitPlan) -> None:
        """Prefix-cache lookup for one admission. A FULL hit (the whole
        prompt cached with its logits) admits by copy; a PARTIAL hit reuses
        the rows below the match rounded down to the hit grain, from a
        segment whose rows the chunk windows computed, and chunk-computes
        the rest. The source segment is pinned until retirement."""
        cache = self.prefix_cache
        n = len(pl.req.prompt)
        # an adapter != 0 prompt's rows depend on the adapter: segments
        # are the base model's only
        if (cache is None or n == 0 or pl.req.adapter != 0
                or not self._prefix_reuse_ok()):
            return
        seg, m = cache.lookup(pl.req.prompt)
        if seg is None:
            self.metrics.record_prefix_lookup("miss", 0)
            return
        if m == n and seg.logits is not None:
            pl.kind, pl.seg, pl.matched = "full", seg, n
        else:
            L = min(m, n - 1)
            L -= L % self._hit_grain
            if L <= 0 or not seg.partial_ok:
                self.metrics.record_prefix_lookup("miss", 0)
                return
            pl.kind, pl.seg, pl.matched = "partial", seg, L
        cache.pin(seg)
        self.metrics.record_prefix_lookup(
            "hit_full" if pl.kind == "full" else "hit_partial", pl.matched)
        self.tracer.instant(slot_track(pl.slot), "prefix_hit",
                            req_id=pl.req.id, kind=pl.kind,
                            cached_tokens=pl.matched, prompt_len=n)

    def _block_row(self, block_ids) -> torch.Tensor:
        """A sentinel-padded (bps,) table row naming ``block_ids``, on the
        device."""
        row = np.zeros((self.pool.blocks_per_slot,), np.int32)
        row[:len(block_ids)] = block_ids
        return self._upload(row)

    def _paged_seg_slab(self, seg: Segment):
        """A cached segment's blocks gathered into a new batch-1 scratch
        slab (rows past its blocks come back zero)."""
        return paged_slot_gather(self.pool.caches,
                                 self._block_row(seg.block_ids))

    def _alias_hit_blocks(self, pl: _AdmitPlan, covered: int) -> None:
        """Share the segment's FULL blocks over rows [0, covered) into the
        slot's table (a refcount bump), then cover the rest of the slot's
        writable rows with private blocks: rows the slot writes land only
        in its own blocks."""
        full = covered // self.pool.block_size
        if full:
            self.pool.alias_into_slot(pl.slot, pl.seg.block_ids[:full])
        self._paged_ensure_blocks(pl.slot,
                                  len(pl.req.prompt) + pl.req.max_new)

    def _admit_full_hit(self, pl: _AdmitPlan) -> None:
        """Admission by copy: the segment's rows and stored logits; no
        prefill program. Paged: the full blocks are aliased, the partial
        tail block is copied into the slot's first private block and the
        rest of its private blocks are zeroed (as a miss lands them)."""
        req, n = pl.req, len(pl.req.prompt)
        if self._paged:
            self._alias_hit_blocks(pl, n)
            full, tail = divmod(n, self.pool.block_size)
            row = self.pool.table(pl.slot)
            if tail:
                self.pool.copy_block(pl.seg.block_ids[full], int(row[full]))  # lint: sync-ok host block table
            self.pool.zero_blocks(row[full + (tail > 0):])
            self._insert_fn(*self._state(), pl.seg.logits, pl.slot, n,
                            req.max_new, _eos_of(req))
            return
        self._hit_insert_fn(*self._state(), self.prefix_cache.region,
                            pl.seg.logits, pl.seg.slot, pl.slot, n,
                            req.max_new, _eos_of(req))

    def _admit_partial_hit(self, pl: _AdmitPlan) -> None:
        """The segment's rows below ``matched``, then the suffix windows:
        in slab mode on the slot's own rows, paged on a gathered scratch
        slab whose rows from ``matched`` on land in the slot's private
        blocks (the matched rows by aliasing)."""
        req, n, L = pl.req, len(pl.req.prompt), pl.matched
        if self._paged:
            self._alias_hit_blocks(pl, L)
            slab = self._paged_seg_slab(pl.seg)
        else:
            slab = self._seg_fetch_fn(self.prefix_cache.region, pl.seg.slot,
                                      out=self.pool.slab(pl.slot))
        lg = self._compute_rows(slab, req.prompt, start=L)
        self.pool.land(pl.slot, slab, start=L)
        self._insert_fn(*self._state(), lg, pl.slot, n, req.max_new,
                        _eos_of(req))

    def _maybe_insert_prefix(self, pl: _AdmitPlan) -> None:
        """Insert-on-completion: cache the seated prompt's rows as a new
        segment (plus at most one branch-point segment), before any decode
        step touches the slot, with the (1, V) logits row when the segment
        spans the whole prompt. The creating request pins them until
        retirement."""
        cache = self.prefix_cache
        n = len(pl.req.prompt)
        if (cache is None or pl.kind == "full" or n < self._min_bucket
                or pl.req.adapter != 0 or not self._prefix_reuse_ok()):
            return
        for seg in cache.insert(pl.req.prompt):
            if self._paged:
                if not self._paged_store_segment(seg, pl.slot):
                    # the tail block did not fit: un-cache rather than
                    # leave a segment without rows
                    cache.drop(seg)
                    continue
            else:
                self._seg_store_fn(cache.region, self.pool.caches, seg.slot,
                                   pl.slot)
            if seg.length == n:
                seg.logits = self._logit_row_fn(self._logits, pl.slot)
            # the donor's rows came from the chunk windows iff its prompt
            # exceeds one bucket (see the module doc)
            seg.partial_ok = n > self._max_bucket
            self._slots[pl.slot].segs.append(seg)
            self.metrics.record_prefix_insert()
            self.tracer.instant(ENGINE_TRACK, "prefix_insert",
                                req_id=pl.req.id, length=seg.length)

    def _paged_store_segment(self, seg: Segment, slot: int) -> bool:
        """Back a new segment with block references off the donor slot:
        incref its full blocks below the segment's length (the donor writes
        only later rows) and copy the partial tail block, if any, into a
        cache-owned block. False, with no reference taken, when that block
        cannot be allocated."""
        bs = self.pool.block_size
        row = self.pool.table(slot)
        full, tail = divmod(seg.length, bs)
        try:
            tail_ids = self.pool.alloc_blocks(1) if tail else []
        except RuntimeError:
            return False
        ids = [int(b) for b in row[:full]]  # lint: sync-ok host block table
        self.pool.incref(ids)
        if tail:  # the reference's build_block_copy_program
            self.pool.copy_block(int(row[full]), tail_ids[0])  # lint: sync-ok host block table
        seg.block_ids = ids + tail_ids
        return True

    # -- admission -------------------------------------------------------------

    # lint: hot-path
    def _seat(self, pl: _AdmitPlan) -> None:
        """Host bookkeeping that makes an executed plan a live slot (the
        sampling key is split here, in admission order, unless piggyback
        split it when the plan executed)."""
        req, slot = pl.req, pl.slot
        kd = self._presplit_keys.pop(req.id, None)
        if kd is None:
            kd = self._split_key()
        self._slot_keys[slot] = kd
        self._slot_adapters[slot] = req.adapter
        st = _SlotState(req, self.pool.generation(slot), kd)
        if pl.seg is not None:
            st.segs.append(pl.seg)
        if self._surface:
            self._seat_surface(slot, st, req)
        self._slots[slot] = st
        pl.handled = True
        req.status = RequestStatus.RUNNING
        self.metrics.record_prefill(pl.prefill_s)
        delay = (time.perf_counter() - req.arrival_time
                 if req.arrival_time is not None else None)
        if delay is not None:
            self.metrics.record_admitted(delay, tenant=req.tenant_id)
            self.tracer.span(SCHEDULER_TRACK, "queued", req.arrival_time,
                             delay, req_id=req.id)
        # the admission span joins the caller's trace when the request
        # carries one (its parent the upstream span)
        self.tracer.span(slot_track(slot), "prefill", pl.t_pf, pl.prefill_s,
                         req_id=req.id, prompt_len=len(req.prompt),
                         prefix=pl.kind, cached_tokens=pl.matched,
                         **self._trace_ctx(req))
        self.flight.record("admit", req_id=req.id, slot=slot,
                           prompt_len=len(req.prompt), prefix=pl.kind,
                           tenant=req.tenant_id or None,
                           trace_id=req.trace_id or None)
        log_event(_log, "request_admitted", req_id=req.id, slot=slot,
                  prompt_len=len(req.prompt), queue_delay_s=delay,
                  prefill_s=round(pl.prefill_s, 6), prefix=pl.kind,
                  cached_tokens=pl.matched, tenant=req.tenant_id or None,
                  adapter=req.adapter or None,
                  trace_id=req.trace_id or None)

    def _split_key(self) -> threefry.Key:
        """``self._key, sub = split(self._key)``; returns ``sub``."""
        self._key, sub = threefry.split(self._key)
        return sub

    def _sampler_rows(self, slot: int, req: Request) -> None:
        """A slot's sampler mirrors from its request (the engine's values
        where it sets none)."""
        self._slot_temps[slot] = (req.temperature if req.temperature
                                  is not None else self.temperature)
        self._slot_topks[slot] = (req.top_k if req.top_k is not None
                                  else int(self.top_k or 0))
        self._slot_topps[slot] = req.top_p if req.top_p is not None else 1.0
        self._slot_bias_idx[slot] = -1
        self._slot_bias_val[slot] = 0.0
        for j, (ti, tv) in enumerate(sorted((req.logit_bias or {}).items())):
            self._slot_bias_idx[slot, j] = ti
            self._slot_bias_val[slot, j] = tv

    def _seat_surface(self, slot: int, st: _SlotState, req: Request) -> None:
        """Seat a slot's sampling-surface rows: the sampler mirrors, the
        compiled grammar in the combined table and the device FSM state.
        A grammar that cannot be seated now (table rows pinned by live
        requests) cancels the request, and the slot never decodes
        unconstrained: its active bit is cleared at once."""
        self._sampler_rows(slot, req)
        start = 0
        if req._grammar is not None:
            try:
                start = self._gtable.seat(req._grammar)
                st.gkey = req._grammar.key
            except GrammarError as e:
                req.error = str(e)
                req.cancel()
                self._dactive = self._deact_fn(self._dactive, slot)
                log_event(_log, "grammar_seat_failed", level=logging.WARNING,
                          req_id=req.id, error=str(e))
        st.gstate0 = int(start)  # lint: sync-ok host int
        self._slot_gstate[slot] = start
        self._dgstate = self._gstate_set_fn(self._dgstate, slot, int(start))  # lint: sync-ok host int
        st.stop_matcher = StopMatcher(req.stop) if req.stop else None
        st.lp_out = [] if req.logprobs else None

    def _clear_surface(self, slot: int, st: _SlotState) -> None:
        """Retirement's inverse of ``_seat_surface``: release the grammar
        and reset the mirrors to the engine's values. The device FSM row is
        left: an inactive slot's state is inert (its tokens are forced to
        0, its advance gated on active) and the next seat rewrites it."""
        if st.gkey is not None:
            self._gtable.release(st.gkey)
            st.gkey = None
        self._slot_gstate[slot] = 0
        self._slot_temps[slot] = self.temperature
        self._slot_topks[slot] = int(self.top_k or 0)
        self._slot_topps[slot] = 1.0
        self._slot_bias_idx[slot] = -1
        self._slot_bias_val[slot] = 0.0
        if st.lp_out is not None:
            st.req.logprobs_out = st.lp_out

    def _reseat_surface(self, slot: int, st: _SlotState) -> None:
        """Recovery's re-seat of a live slot's surface state: the sampler
        mirrors from the request, the FSM state re-walked from the seat
        state over the recorded tokens, the stop matcher rebuilt by
        pushing them again (a live record holds no completed match)."""
        self._sampler_rows(slot, st.req)
        g = int(st.gstate0)
        for t in st.tokens:
            g = self._gtable.advance(g, int(t))
        self._slot_gstate[slot] = g
        if st.stop_matcher is not None:
            st.stop_matcher = StopMatcher(st.req.stop)
            for t in st.tokens:
                st.stop_matcher.push(int(t))

    def _grammar_device_tables(self):
        """Device copies of the combined mask and transition tables, made
        again exactly when the host table's version moved (seats and
        evictions happen between horizons, so a dispatch never races
        this). The copies are of snapshots: the host table changes in
        place."""
        gt = self._gtable
        if self._gtab_version != gt.version:
            self._dmask_tab = self._upload(gt.mask_words.view(np.int32).copy())
            self._dtrans_tab = self._upload(gt.trans.copy())
            self._gtab_version = gt.version
        return self._dmask_tab, self._dtrans_tab

    def _admissible_fn(self):
        """The admission gate: an embedding lookup or a KV ingest always
        passes (it takes no slot); any other needs a free slot; paged, its blocks,
        beyond those this round already promised, fit the free heap —
        after handing cached prefix blocks back (live traffic outranks
        cached prefixes); with tenancy, its tenant holds fewer than
        ``max_slots`` slots (live and deferred ones plus this round's
        plans). Returns (gate, the promised-blocks counter, the per-tenant
        slot counts)."""
        reserved = [0]
        used: dict[str, int] = {}
        if self.tenancy is not None:
            held = [st.req for st in self._slots if st is not None]
            held += [rec.plan.req for rec in self._pending]
            for r in held:
                used[r.tenant_id] = used.get(r.tenant_id, 0) + 1

        def admissible(r: Request) -> bool:
            if r.kind in _SLOTLESS:
                return True
            if not self.pool.n_free:
                return False
            if self._paged:
                need = self.pool.blocks_needed(len(r.prompt) + r.max_new)
                while need + reserved[0] > self.pool.n_free_blocks:
                    if (self.prefix_cache is None
                            or not self.prefix_cache.reclaim()):
                        return False
            if self.tenancy is not None:
                t = self.tenancy.get(r.tenant_id)
                if (t is not None and t.max_slots is not None
                        and used.get(r.tenant_id, 0) >= t.max_slots):
                    return False
            return True

        return admissible, reserved, used

    # lint: hot-path
    def _admit(self, now: float) -> None:
        """Pop queued requests into free slots (with prefix affinity, the
        previous prompt as hint), classify each against the prefix cache,
        then execute. A failure mid-round requeues every plan not yet
        seated, in order, with its slot and segment pin released: no popped
        request is dropped."""
        if not len(self.scheduler):
            return
        if not (self.pool.n_free
                or any(self.scheduler.has_kind(k) for k in _SLOTLESS)):
            return
        self._admitting += 1
        plans: list[_AdmitPlan] = []
        admissible, reserved, used = self._admissible_fn()
        try:
            hint = None
            while len(self.scheduler):
                req = self.scheduler.pop(affinity_hint=hint,
                                         admissible=admissible)
                if req is None:
                    break
                if req.cancelled:
                    self._retire_unadmitted(req, RequestStatus.CANCELLED)
                    continue
                if req.expired(now):
                    self._retire_unadmitted(req, RequestStatus.EXPIRED)
                    continue
                serve = self._host_served.get(req.kind)
                if serve is not None:
                    # served where it pops: a wire seat lands before any
                    # decode admits, an export holds its slot only while
                    # it prefills, a migrated session seats at once
                    serve(req, now)
                    continue
                plans.append(_AdmitPlan(req, self.pool.acquire()))
                used[req.tenant_id] = used.get(req.tenant_id, 0) + 1
                if self._paged:
                    reserved[0] += self.pool.blocks_needed(
                        len(req.prompt) + req.max_new)
                # affinity helps adapter-0 traffic only (no other adapter
                # reuses cached segments)
                hint = req.prompt if req.adapter == 0 else None
            if not plans:
                return
            for pl in plans:
                self._classify_plan(pl)
            self._execute_plans(plans)
        except BaseException:
            undone = [pl for pl in reversed(plans) if not pl.handled]
            for pl in undone:
                if pl.seg is not None:
                    self.prefix_cache.unpin(pl.seg)
                    pl.seg = None
                self.pool.release(pl.slot)
                self.scheduler.requeue(pl.req)
            # a plan that executed set its slot's active bit
            for pl in undone:
                self._dactive = self._deact_fn(self._dactive, pl.slot)
            raise
        finally:
            self._admitting -= 1

    # lint: hot-path
    def _execute_plans(self, plans: list[_AdmitPlan]) -> None:
        # the fault boundary first, in admission order
        live: list[_AdmitPlan] = []
        for pl in plans:
            if self._check_prefill_faults(pl.req):
                live.append(pl)
                continue
            if pl.seg is not None:
                self.prefix_cache.unpin(pl.seg)
                pl.seg = None
            self.pool.release(pl.slot)
            pl.handled = True
            self._retire_unadmitted(pl.req, RequestStatus.FAILED,
                                    pl.req.error)
        deferred: set[int] = set()
        if self._piggyback:
            # every plan's key now, in admission order: the blocking
            # engine's seating order
            for pl in live:
                if pl.req.id not in self._presplit_keys:
                    self._presplit_keys[pl.req.id] = self._split_key()
            # defer only prompts whose uncached suffix exceeds one bucket:
            # whatever the blocking path serves in one prefill stays there
            for pl in live:
                cached = pl.matched if pl.kind == "partial" else 0
                if (pl.kind != "full"
                        and len(pl.req.prompt) - cached > self._max_bucket):
                    self._enqueue_piggyback(pl)
                    deferred.add(id(pl))
        occupied = any(st is not None for st in self._slots)
        t_exec = time.perf_counter()
        batched = self._run_batched_groups(
            [pl for pl in live if id(pl) not in deferred])
        # the serial remainder, in admission order
        for pl in live:
            if id(pl) in deferred or id(pl) in batched:
                continue
            t0 = time.perf_counter()
            if pl.kind == "full":
                self._admit_full_hit(pl)
            elif pl.kind == "partial":
                self._admit_partial_hit(pl)
            else:
                self._prefill_seq_into_slot(pl.req.prompt, pl.slot,
                                            pl.req.max_new, _eos_of(pl.req),
                                            pl.req.adapter)
            pl.t_pf, pl.prefill_s = t0, time.perf_counter() - t0
        # admission prefill run while slots decode is the stall piggyback
        # bounds; measured with it on and off
        if occupied:
            self.metrics.record_decode_stall(time.perf_counter() - t_exec)
        # seat in admission order (the key order), then cache prefixes
        for pl in live:
            if id(pl) not in deferred:
                self._seat(pl)
        for pl in live:
            if id(pl) not in deferred:
                self._maybe_insert_prefix(pl)

    # -- batched admission -------------------------------------------------------

    def _run_batched_groups(self, plans: list[_AdmitPlan]) -> set[int]:
        """Coalesce what can share a dispatch (the reference's grouping,
        engine.py:4441): misses of at most one bucket keyed by their
        bucket, partial hits whose suffix is one window keyed by (bucket,
        cached length). Groups of two or more run batched, buckets in
        ascending order; returns the ids of the plans they admitted."""
        batched: set[int] = set()
        if len(plans) < 2 or self._paged or self.batch_admission is False:
            return batched
        miss: dict[int, list[_AdmitPlan]] = {}
        hit: dict[tuple[int, int], list[_AdmitPlan]] = {}
        for pl in plans:
            n = len(pl.req.prompt)
            if pl.kind == "miss" and 0 < n <= self._max_bucket:
                miss.setdefault(self._bucket_for(n), []).append(pl)
            elif pl.kind == "partial":
                sfx = n - pl.matched
                if sfx <= self._max_bucket:
                    b = self._bucket_for(sfx)
                    if pl.matched + b <= self.pool.tpad:
                        hit.setdefault((b, pl.matched), []).append(pl)
        groups = ([("miss", self._batch_prefill_group, (b,), g)
                   for b, g in sorted(miss.items())]
                  + [("hit", self._batch_hit_group, key, g)
                     for key, g in sorted(hit.items())])
        for kind, fn, key, group in groups:
            if len(group) < 2 or not self._batch_admission_ok(
                    kind, key[0], _pow2(len(group))):
                continue
            t0 = time.perf_counter()
            fn(*key, group)
            dt = (time.perf_counter() - t0) / len(group)
            for pl in group:
                pl.t_pf, pl.prefill_s = t0, dt
                batched.add(id(pl))
        return batched

    def _group_rows(self, group: list[_AdmitPlan]):
        """The group's rows padded to a power of two (pad rows repeat the
        first plan: kernel #1 and the products run at a few shapes) and
        its real rows' slots, positions, budgets, EOS ids and LoRA rows."""
        rows = group + [group[0]] * (_pow2(len(group)) - len(group))
        adapters = np.array([pl.req.adapter for pl in rows], np.int32)
        up = self._upload
        return (rows,
                up(np.array([pl.slot for pl in group], np.int64)),
                up(np.array([len(pl.req.prompt) for pl in group], np.int32)),
                up(np.array([pl.req.max_new for pl in group], np.int32)),
                up(np.array([_eos_of(pl.req) for pl in group], np.int32)),
                up(adapters) if adapters.any() else None)

    def _batch_prefill_group(self, bucket: int,
                             group: list[_AdmitPlan]) -> None:
        """One program admits every miss in ``group`` (all padding to
        ``bucket``)."""
        rows, slots, pos0, max_new, eos, adapters = self._group_rows(group)
        prompts = np.zeros((len(rows), bucket), np.int64)
        for r, pl in enumerate(rows):
            prompts[r, :len(pl.req.prompt)] = pl.req.prompt
        last_idx = np.array([len(pl.req.prompt) - 1 for pl in rows],
                            np.int64)
        self.prefill_dispatches += 1
        self.program_keys["batch_prefill"].add((bucket, len(rows)))
        self._attr("batch_prefill")
        self._batch_prefill_fn(self.params, *self._state(),
                               self._upload(prompts), self._upload(last_idx),
                               slots, pos0, max_new, eos, adapters)
        self.metrics.record_batched_admissions(len(group))

    def _batch_hit_group(self, bucket: int, L: int,
                         group: list[_AdmitPlan]) -> None:
        """One program admits every partial hit in ``group`` (cached
        length ``L``, a one-window suffix padding to ``bucket``)."""
        rows, slots, pos0, max_new, eos, adapters = self._group_rows(group)
        toks = np.zeros((len(rows), bucket), np.int64)
        for r, pl in enumerate(rows):
            toks[r, :len(pl.req.prompt) - L] = pl.req.prompt[L:]
        seg_idx = np.array([pl.seg.slot for pl in rows], np.int64)
        last_idx = np.array([len(pl.req.prompt) - L - 1 for pl in rows],
                            np.int64)
        self.prefill_dispatches += 1
        self.program_keys["batch_hit"].add((bucket, len(rows)))
        self._attr("batch_hit")
        self._batch_hit_fn(self.params, *self._state(),
                           self.prefix_cache.region, self._upload(seg_idx),
                           self._upload(toks), L, self._upload(last_idx),
                           slots, pos0, max_new, eos, adapters)
        self.metrics.record_batched_admissions(len(group))

    # -- piggyback -------------------------------------------------------------

    def _enqueue_piggyback(self, pl: _AdmitPlan) -> None:
        """Defer an admission: its scratch slab (the segment's rows for a
        partial hit), its chunk windows and, paged, its private blocks.
        The cached prefix is aliased only at completion: an unseated slot's
        frozen-position decode writes must never reach a shared block."""
        req = pl.req
        L = pl.matched if pl.kind == "partial" else 0
        if self._paged:
            self.pool.alloc_slot_blocks(
                pl.slot, min(len(req.prompt) + req.max_new, self.pool.tpad),
                start=L // self.pool.block_size)
            slab = (self._paged_seg_slab(pl.seg) if pl.kind == "partial"
                    else self._init_caches(1, self.max_total, self.device))
        elif pl.kind == "partial":
            slab = self._seg_fetch_fn(self.prefix_cache.region, pl.seg.slot)
        else:
            slab = self._init_caches(1, self.max_total, self.device)
        rec = _PendingPrefill(
            pl, deque(self._chunk_schedule(len(req.prompt), start=L)), slab,
            time.perf_counter())
        self._pending.append(rec)
        pl.handled = True
        self.flight.record("piggyback", phase="defer", req_id=req.id,
                           slot=pl.slot, suffix_tokens=len(req.prompt) - L,
                           n_chunks=len(rec.chunks))
        self.tracer.instant(slot_track(pl.slot), "piggyback_defer",
                            req_id=req.id, suffix_tokens=len(req.prompt) - L)
        log_event(_log, "piggyback_defer", req_id=req.id, slot=pl.slot,
                  prompt_len=len(req.prompt), cached_tokens=L,
                  n_chunks=len(rec.chunks), tenant=req.tenant_id or None)

    def _run_pending_chunk(self, rec: _PendingPrefill) -> int:
        """Run the head chunk of ``rec``; returns its real tokens."""
        t0, ln, b = rec.chunks[0]
        pad = np.zeros((1, b), np.int64)
        pad[0, :ln] = rec.plan.req.prompt[t0:t0 + ln]
        self.program_keys["chunk"].add(b)
        self._attr("chunk")
        rec.slab, rec.lg = self._chunk_fn(
            self.params, rec.slab, self._upload(pad), t0, ln - 1,
            self._adapter_row(rec.plan.req.adapter))
        rec.chunks.popleft()
        self.prefill_dispatches += 1
        self.metrics.record_prefill_chunk(ln)
        self.flight.record("piggyback", phase="chunk", req_id=rec.plan.req.id,
                           slot=rec.plan.slot, chunk_tokens=ln, fused=False,
                           remaining=len(rec.chunks))
        return ln

    def _complete_pending(self, rec: _PendingPrefill) -> None:
        """Every chunk ran: land the scratch slab, seat the slot and cache
        the prefix — from here the admission is a blocking one's."""
        pl = rec.plan
        req = pl.req
        start = 0
        if self._paged and pl.kind == "partial":
            # the matched rows by aliasing; the slab lands from there on
            start = pl.matched
            self.pool.alias_into_slot(
                pl.slot, pl.seg.block_ids[:start // self.pool.block_size])
        self.pool.write_slab(pl.slot, rec.slab, start=start)
        self._insert_fn(*self._state(), rec.lg, pl.slot, len(req.prompt),
                        req.max_new, _eos_of(req))
        pl.t_pf = rec.t_start
        pl.prefill_s = time.perf_counter() - rec.t_start
        self._seat(pl)
        self._maybe_insert_prefix(pl)
        self.flight.record("piggyback", phase="seated", req_id=req.id,
                           slot=pl.slot, prefill_s=round(pl.prefill_s, 6))

    def _advance_piggyback(self, decoding: bool) -> None:
        """Spend up to ``prefill_budget`` chunk tokens on the deferred FIFO,
        oldest first, seating each admission whose last chunk ran. The
        first chunk runs even over budget, so the oldest deferred admission
        advances each horizon. ``decoding``: a horizon was just dispatched,
        and the next one waits behind these chunks."""
        spent = 0
        t_wall = time.perf_counter()
        while self._pending and spent < self.prefill_budget:
            rec = self._pending[0]
            self._pb_did_work = True
            spent += self._run_pending_chunk(rec)
            if not rec.chunks:
                self._complete_pending(rec)
                self._pending.popleft()
        if decoding and spent:
            self.metrics.record_decode_stall(time.perf_counter() - t_wall)

    # -- parity probes -----------------------------------------------------------

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
        tpad = kv_leaves(tmp)[0].shape[3]
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
            dtype=t.dtype, device=t.device), tmp)
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

    @torch.no_grad()
    def _probe_tp_parity(self, cfg: TransformerConfig, params, mesh,
                         prefill_max_bucket: int) -> bool:
        """One-time probe gating tensor-parallel serving (the reference's
        ``_probe_tp_parity``, engine.py:3540): do the SHARDED programs
        give, bitwise, the single-device logits on scratch state, at the
        shapes the engine runs? A library picks its product by the row
        count and the output width, so the probe runs every prompt bucket
        (the bucketed prefill at batch 1 and, behind it where the slab
        has room, a chunk window of the bucket's rows, as chunked and
        partial-hit admissions run), then three greedy decode steps at
        the engine's batch (``n_slots`` rows) over the engine's slab rows.
        The batched admission programs are held to these serial ones by
        their own probe, on the same engine. The exact-TP layout keeps
        every reduction's order, so this passes where each rank's products
        are the matching columns of the whole product; bitwise logits make
        greedy and sampled streams identical. A geometry the layout
        refuses (tp not dividing the heads) or any error declines."""
        total = self.max_total
        dev = mesh.devices[0]
        rows = self.n_slots
        init_meta = _decode_builder(cfg)[1]
        tpad = kv_leaves(init_meta(1, total, torch.device("meta")))[
            0].shape[3]
        mb = _max_bucket(prefill_max_bucket, cfg.max_len, tpad)
        buckets = [b for b in (2 ** j for j in range(3, 31)) if b <= mb]
        buckets = buckets or [mb]
        n_dec = min(mb, total - 4)
        if n_dec < 1:
            return False
        seq = torch.from_numpy(
            ((1 + np.arange(2 * mb)) % cfg.vocab_size)[None]).to(dev)

        def stream(tp_mesh):
            fwd1, init_caches, do_prefill, cast_params = _decode_builder(
                cfg, tp_mesh)
            fwd_chunk = _chunk_builder(cfg, tp_mesh)
            p = cast_params(
                params_to(params, dev) if tp_mesh is None
                else place_serving_tp_params(tp_mesh, params, cfg))
            out = []
            for b in buckets:
                caches, lg = do_prefill(p, init_caches(1, total, dev),
                                        seq[:, :b])
                out.append((f"the prefill of {b} rows", lg))
                if 2 * b <= tpad:
                    lg, _ = fwd_chunk(p, caches, seq[:, b:2 * b], b,
                                      last_idx=b - 1)
                    out.append((f"a chunk of {b} rows at {b}", lg))
            caches, lg = do_prefill(p, init_caches(1, total, dev),
                                    seq[:, :n_dec])
            caches = kv_map(lambda c: c.repeat(1, 1, rows, 1, 1), caches)
            lg = lg.repeat(rows, 1)
            pos = torch.full((rows,), n_dec, dtype=torch.int32, device=dev)
            for j in range(3):
                lg, caches = fwd1(p, caches, lg.argmax(-1).to(torch.int32),
                                  pos)
                pos = pos + 1
                out.append((f"decode step {j + 1} at {rows} rows", lg))
            return out

        try:
            ref = stream(None)
            got = stream(mesh)
        except Exception as e:
            # conservative, as the reference: a geometry or device that
            # cannot run the probe serves at tp 1 unless tp_parity=True
            log_event(_log, "tp_parity_probe_error", level=logging.WARNING,
                      error=repr(e))
            self.tp_probe_detail = f"error: {e!r}"
            return False
        for (where, a), (_, b) in zip(ref, got):
            if not torch.equal(a, b):
                d = (a - b).abs().max().item()
                self.tp_probe_detail = (f"logits differ first at {where}; "
                                        f"max |d| {d:.3e}")
                return False
        self.tp_probe_detail = None
        return True

    @torch.no_grad()
    def _probe_lora_zero(self) -> bool:
        """One-time probe gating batched LoRA (the reference's
        ``_probe_lora_zero``, engine.py:3594): with the bank riding in
        params, does adapter 0 reproduce the bank-free model bitwise
        through prefill and three greedy decode steps? The forward selects
        the base activations for adapter-0 rows (never ``+ 0.0``, which
        could flip -0.0 bits), so this should pass on any device; the probe
        shows it on this one. Bitwise logits make greedy and sampled
        adapter-0 streams the base model's."""
        total = int(min(self.max_total, 32))
        n = min(8, total - 4)
        if n < 1:
            return False
        dev = self.device
        prompt = torch.from_numpy(
            ((1 + np.arange(n)) % self.cfg.vocab_size)[None]).to(dev)
        base = {k: v for k, v in self.params.items() if k != "lora"}
        ad = torch.zeros((1,), dtype=torch.int32, device=dev)

        def stream(p):
            caches = self._init_caches(1, total, dev)
            caches, lg = self._do_prefill(p, caches, prompt, adapter=ad)
            out = [lg]
            pos = torch.full((1,), n, dtype=torch.int32, device=dev)
            for _ in range(3):
                lg, caches = self._fwd1(p, caches,
                                        lg.argmax(-1).to(torch.int32), pos,
                                        ad)
                pos = pos + 1
                out.append(lg)
            return out

        return all(torch.equal(a, b)
                   for a, b in zip(stream(base), stream(self.params)))

    @torch.no_grad()
    def _probe_masked_parity(self) -> bool:
        """One-time probe gating the sampling surface (the reference's
        ``_probe_masked_parity``, engine.py:3323): does the masked step,
        every stage computed on neutral settings (FSM state 0, no bias
        rows, the engine's top-k and temperature, p 1, logprobs gathered),
        reproduce the base step bitwise — every decode-state leaf, the
        caches and the tokens — with the FSM held at 0? Both run K
        substeps from the same scratch state, sampled with the same keys
        (greedy engines draw too, and pick the argmax)."""
        n, vs, dev = self.n_slots, self.cfg.vocab_size, self.device

        def state():
            if self._paged:
                caches = {"blocks": kv_map(torch.zeros_like,
                                           self.pool.caches),
                          "tables": torch.zeros(
                              (n, self.pool.blocks_per_slot),
                              dtype=torch.int32, device=dev)}
            else:
                caches = self._init_caches(n, self.max_total, dev)
            lg = torch.arange(n * vs, dtype=torch.float32,
                              device=dev).reshape(n, vs) % 7.0
            return (caches, lg,
                    torch.arange(n, dtype=torch.int32, device=dev) % 3,
                    torch.ones((n,), dtype=torch.bool, device=dev),
                    torch.full((n,), 5, dtype=torch.int32, device=dev),
                    torch.full((n,), _NO_EOS, dtype=torch.int32,
                               device=dev))

        keys = threefry.device_keys(
            np.arange(2 * n).reshape(n, 2), dev)
        out_a = self._step_fn(self.params, *state(), keys)
        out_b = self._masked_fn(  # lint: prng-ok the probe draws both sides from one key
            self.params, *state(),
            torch.zeros((n,), dtype=torch.int32, device=dev), keys,
            torch.full((n,), self.temperature, dtype=torch.float32,
                       device=dev),
            torch.full((n,), int(self.top_k or 0), dtype=torch.int32,
                       device=dev),
            torch.ones((n,), dtype=torch.float32, device=dev),
            torch.full((n, MAX_LOGIT_BIAS), -1, dtype=torch.int32,
                       device=dev),
            torch.zeros((n, MAX_LOGIT_BIAS), dtype=torch.float32,
                        device=dev),
            *self._grammar_device_tables(), SurfaceUse())
        return (all(torch.equal(a, b) for a, b in zip(
                    kv_leaves(out_a[0]), kv_leaves(out_b[0])))
                and all(torch.equal(a, b)
                        for a, b in zip(out_a[1:5], out_b[1:5]))
                and torch.equal(out_a[5], out_b[6][:, :, 0])
                and not bool(out_b[5].any()))

    @torch.no_grad()
    def _probe_prefix_parity(self) -> bool:
        """One-time probe gating hit-path reuse (the reference's
        ``_probe_prefix_parity``, engine.py:3188): are a cached prefix's
        rows plus the chunk-computed suffix bitwise the miss path — KV rows
        AND logits? The miss path computes a ``G + 3``-token prompt (``G``
        the hit grain; fewer rows when ``max_total`` is shorter, and
        nothing to compare when no prompt can pass ``G``) into a zeroed
        slab; the segment is stored from a
        donor prompt sharing the first ``G`` tokens and diverging after
        them (so the hit reads another prompt's rows past ``G``, as a real
        branch hit does); the hit path fetches it and computes rows [G,
        G + 3). On a mismatch ``prefix_probe_detail`` names the first leaf,
        layer and row that differ and the largest difference."""
        G = self._hit_grain
        n = min(G + 3, self.max_total)
        if n <= G:
            # no prompt is longer than the grain: every hit is a full
            # hit, a copy of the same prompt's rows, and nothing computes
            return True
        disp = self.prefill_dispatches
        self._attr_suspend += 1  # probes count toward no attribution
        try:
            vs = self.cfg.vocab_size
            seq = ((1 + np.arange(n)) % vs).astype(np.int32)
            donor = seq.copy()
            donor[G:] = (seq[G:] + 1) % vs

            def scratch():
                return self._init_caches(1, self.max_total, self.device)

            miss = scratch()
            lg_a = self._compute_rows(miss, seq)
            dslab = scratch()
            self._compute_rows(dslab, donor)
            region = self.pool.alloc_region(1)
            self._seg_store_fn(region, dslab, 0, 0)
            hit = self._seg_fetch_fn(region, 0)
            lg_c = self._compute_rows(hit, seq, start=G)
            names = ("rows", "scales")
            for name, a, c in zip(names, _kv_planes(unshard_cache(miss)),
                                  _kv_planes(unshard_cache(hit))):
                if a is None:
                    continue
                a, c = a[:, :, 0, :n], c[:, :, 0, :n]
                if not torch.equal(a, c):
                    bad = (a != c).nonzero()[0].tolist()
                    d = (a.float() - c.float()).abs().max().item()
                    self.prefix_probe_detail = (
                        f"KV {name} differ first at layer {bad[0]}, "
                        f"{'kv'[bad[1]]}, row {bad[2]}; max |d| {d:.3e}")
                    return False
            if not torch.equal(lg_a, lg_c):
                d = (lg_a - lg_c).abs().max().item()
                self.prefix_probe_detail = (f"logits differ; max |d| "
                                            f"{d:.3e}")
                return False
            self.prefix_probe_detail = None
            return True
        finally:
            self.prefill_dispatches = disp
            self._attr_suspend -= 1

    def _scratch_state(self, n: int):
        """A zeroed decode state of ``n`` slots (caches, logits, positions,
        active bits, budgets, EOS ids) for a probe."""
        dev = self.device
        return (self._init_caches(n, self.max_total, dev),
                torch.zeros((n, self.cfg.vocab_size), dtype=torch.float32,
                            device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.bool, device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.full((n,), _NO_EOS, dtype=torch.int32, device=dev))

    @torch.no_grad()
    def _probe_disagg_parity(self) -> bool:
        """One-time probe gating the KV wire (the reference's
        ``_probe_disagg_parity``, engine.py:3745): does a segment moved
        prefill -> host copy -> ``encode_segment``/``decode_segment``
        bytes -> upload -> region import -> zero-prefill hit insert give,
        bitwise, the direct prefill's device state (KV rows, logits,
        positions, budgets)? Paged engines also push the slab through the
        block scatter and gather that ingest and export use. On a refusal
        export and ingest decline and the fleet prefills locally."""
        n = min(self._min_bucket + 3, self.max_total - 1, self.pool.tpad)
        if n < 1:
            return False
        disp = self.prefill_dispatches
        self._attr_suspend += 1  # probes count toward no attribution
        try:
            seq = ((1 + np.arange(n)) % self.cfg.vocab_size).astype(np.int32)
            sa = self._scratch_state(1)
            lg = self._compute_rows(sa[0], seq)
            self._insert_fn(*sa, lg, 0, n, 1, _NO_EOS)
            # the export side: the slab and the logits row to the host
            leaves = [t.to("cpu", copy=True)
                      for t in kv_leaves(unshard_cache(sa[0]))]
            lg_host = self._logit_row_fn(sa[1], 0).to("cpu")
            frame = encode_segment(config_hash=self.config_hash, tokens=seq,
                                   logits=lg_host,
                                   **self._wire_layout(leaves))
            try:
                dec = decode_segment(frame, expect_hash=self.config_hash)
                slab, dlg = self._wire_slab(dec)
            except WireError:
                return False
            if self._paged:
                # land and fetch again through a scratch block store, as
                # ingest and export do (block 0 the sentinel)
                bs, bps = self._block_size, self.pool.tpad // self._block_size
                blocks = kv_map(lambda x: torch.zeros(
                    (x.shape[0], x.shape[1], bps + 1, bs, x.shape[4]),
                    dtype=x.dtype, device=x.device), sa[0])
                row = self._upload(np.arange(1, bps + 1, dtype=np.int32))
                paged_slot_scatter(blocks, row, slab)
                slab = paged_slot_gather(blocks, row)
            region = self.pool.alloc_region(1)
            self._seg_import_fn(region, slab, 0)
            # the decode side's seat: the ordinary zero-prefill full hit
            sc = self._scratch_state(1)
            self._hit_insert_fn(*sc, region, dlg, 0, 0, n, 1, _NO_EOS)
            return self._states_equal(sa, sc)
        finally:
            self.prefill_dispatches = disp
            self._attr_suspend -= 1

    def _disagg_ok(self) -> bool:
        if self._disagg_ok_memo is None:
            self._disagg_ok_memo = self._probe_verdict(
                "disagg_wire", self._probe_disagg_parity,
                n_slots=self.n_slots, max_total=self.max_total,
                min_bucket=self._min_bucket, tpad=self.pool.tpad,
                paged=self._paged, block_size=self._block_size, tp=self.tp)
            log_event(_log, "disagg_parity_probe",
                      level=(logging.INFO if self._disagg_ok_memo
                             else logging.WARNING),
                      ok=self._disagg_ok_memo)
            self.tracer.instant(ENGINE_TRACK, "disagg_parity_probe",
                                ok=self._disagg_ok_memo)
        return self._disagg_ok_memo

    @staticmethod
    def _states_equal(a, b) -> bool:
        """Two scratch states bitwise equal, every leaf."""
        return (all(torch.equal(x, y)
                    for x, y in zip(kv_leaves(a[0]), kv_leaves(b[0])))
                and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])))

    @torch.no_grad()
    def _probe_batch_parity(self, kind: str, bucket: int, nb: int) -> bool:
        """Probe gating one geometry of batched admission (the reference's
        ``_probe_batch_parity``, engine.py:3426, at every geometry the
        engine runs): do ``nb`` rows through the batched program give
        bitwise the device state (KV rows, logits rows, positions, active
        bits, budgets, EOS ids) that the serial path gives row by row?
        ``kind`` "miss": prompts of bucket ``bucket`` through the batched
        prefill against each one's bucketed prefill; "hit": suffixes of
        bucket ``bucket`` behind one cached prefix of the hit grain
        through the batched hit program against each one's chunk window.
        Runs on scratch state; a live engine's slots are untouched. A
        geometry no request can take (too long for the slots) is
        declined."""
        L = self._hit_grain if kind == "hit" else 0
        if (self.n_slots < 2 or bucket < 2 or L + bucket > self.max_total
                or L + bucket > self.pool.tpad):
            return False
        if kind == "hit" and (self.prefix_cache is None
                              or not self._prefix_reuse_ok()):
            return False
        disp = self.prefill_dispatches
        self._attr_suspend += 1  # probes count toward no attribution
        try:
            vs, up, dev = self.cfg.vocab_size, self._upload, self.device
            # nb suffixes of distinct lengths, all padding to ``bucket``
            lens = [max(bucket - r, bucket // 2 + 1, 1) for r in range(nb)]
            prefix = ((3 + np.arange(L)) % vs).astype(np.int32)
            seqs = [np.concatenate([prefix, ((1 + r + np.arange(n)) % vs)
                                    .astype(np.int32)])
                    for r, n in enumerate(lens)]
            region = None
            if kind == "hit":
                donor = self._init_caches(1, self.max_total, dev)
                self._compute_rows(donor, prefix)
                region = self.pool.alloc_region(1)
                self._seg_store_fn(region, donor, 0, 0)
            serial = self._scratch_state(nb)
            for slot, seq in enumerate(seqs):
                slab = (self._seg_fetch_fn(region, 0) if kind == "hit"
                        else self._init_caches(1, self.max_total, dev))
                lg = self._compute_rows(slab, seq, start=L)
                kv_map(lambda c, t: c[:, :, slot:slot + 1].copy_(t),
                       serial[0], slab)
                self._insert_fn(*serial, lg, slot, len(seq), 2 + slot,
                                _NO_EOS)
            toks = np.zeros((nb, bucket), np.int64)
            for r, seq in enumerate(seqs):
                toks[r, :len(seq) - L] = seq[L:]
            last = up(np.array([len(q) - L - 1 for q in seqs], np.int64))
            rows = (up(np.arange(nb, dtype=np.int64)),
                    up(np.array([len(q) for q in seqs], np.int32)),
                    up(2 + np.arange(nb, dtype=np.int32)),
                    up(np.full((nb,), _NO_EOS, np.int32)))
            batched = self._scratch_state(nb)
            if kind == "hit":
                self._batch_hit_fn(self.params, *batched, region,
                                   up(np.zeros((nb,), np.int64)), up(toks),
                                   L, last, *rows)
            else:
                self._batch_prefill_fn(self.params, *batched, up(toks), last,
                                       *rows)
            return self._states_equal(serial, batched)
        finally:
            self.prefill_dispatches = disp
            self._attr_suspend -= 1

    @torch.no_grad()
    def _probe_chunked_parity(self) -> bool:
        """One-time probe for ``chunked_replay="auto"`` (the reference's
        ``_probe_chunked_parity``, engine.py:5072): does one pass over a
        sequence reproduce, bitwise, the logits of a shorter pass plus
        teacher-forced decode steps? Runs on the abandoned pre-recovery
        state and leaves it zeroed."""
        length = int(min(self._max_bucket + 1, self.max_total))
        k = length - 2
        if k < 1:
            return False
        disp = self.prefill_dispatches
        self._attr_suspend += 1  # probes count toward no attribution
        try:
            seq = ((1 + np.arange(length)) % self.cfg.vocab_size).astype(
                np.int32)
            self.pool.reinit()
            self._reset_device_state()
            self._prefill_seq_into_slot(seq, 0, 1, _NO_EOS)
            la = self._logits[0].clone()
            self.pool.reinit()
            self._reset_device_state()
            # budget length - k: in paged mode the teacher-forced rows
            # must land in allocated blocks
            self._prefill_seq_into_slot(seq[:k], 0, max(1, length - k),
                                        _NO_EOS)
            pos = np.zeros((self.n_slots,), np.int32)
            replaying = np.zeros((self.n_slots,), bool)
            replaying[0] = True
            for j in range(k, length):
                toks = np.zeros((self.n_slots,), np.int32)
                toks[0] = seq[j]
                pos[0] = j
                _, self._logits = self._replay_fn(
                    self.params, self.pool.operand(), self._logits,
                    self._upload(toks), self._upload(pos.copy()),
                    self._upload(replaying.copy()))
            ok = torch.equal(la, self._logits[0])
            self.pool.reinit()
            self._reset_device_state()
            return ok
        finally:
            self.prefill_dispatches = disp
            self._attr_suspend -= 1

    def _use_chunked_replay(self) -> bool:
        if self.chunked_replay != "auto":
            return bool(self.chunked_replay)
        if self._chunked_ok is None:
            self._chunked_ok = self._probe_verdict(
                "chunked_replay", self._probe_chunked_parity,
                n_slots=self.n_slots, max_total=self.max_total,
                max_bucket=self._max_bucket, tp=self.tp, paged=self._paged)
            log_event(_log, "chunked_replay_probe", ok=self._chunked_ok)
        return self._chunked_ok

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

    # lint: hot-path
    def _dispatch(self) -> _Inflight | None:
        """Dispatch one K-substep horizon for every occupied slot under
        transient-retry supervision and start its token block's copy to the
        host; returns the in-flight record without waiting for its tokens.
        A persistent or permanent fault quarantines the request it names,
        any other escalates to ``EngineCrash``."""
        if not any(st is not None for st in self._slots):
            return None
        # adaptive horizon: while requests wait for a slot, the next
        # admission boundary is one substep away; the configured K again
        # once the queue drains (deferred admissions hold a slot already)
        k = (1 if self.adaptive_horizon and len(self.scheduler)
             else self.decode_horizon)
        self.decode_horizon_current = k
        attempt, backoff = 0, self.retry_backoff_s
        t_call = time.perf_counter()
        while True:
            try:
                if self.faults is not None:
                    self.faults.check("step")
                # inside the loop: a quarantine below rewrites a paged
                # table row and the slot's surface rows
                toks = self._run_step(k)
                break
            except TransientFault as e:
                self.metrics.record_retry()
                self.tracer.instant(ENGINE_TRACK, "retry", site="step",
                                    error=str(e))
                self.flight.record("fault", fault="transient", site="step",
                                   error=str(e), attempt=attempt + 1)
                attempt += 1
                if attempt <= self.max_retries:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, self.max_backoff_s)
                    continue
                slot = self._slot_of(e.req_id)
                if slot is None:
                    raise EngineCrash(
                        f"transient step fault persisted past "
                        f"{self.max_retries} retries: {e}") from e
                self._retire(slot, RequestStatus.FAILED, time.perf_counter(),
                             error=str(e), deactivate=True)
                if not any(st is not None for st in self._slots):
                    return None
                attempt, backoff = 0, self.retry_backoff_s
            except PermanentFault as e:
                self.flight.record("fault", fault="permanent", site="step",
                                   error=str(e))
                slot = self._slot_of(e.req_id)
                if slot is None:
                    raise EngineCrash(f"permanent step fault names no live "
                                      f"request: {e}") from e
                self._retire(slot, RequestStatus.FAILED, time.perf_counter(),
                             error=str(e), deactivate=True)
                if not any(st is not None for st in self._slots):
                    return None
            except EngineCrash as e:
                # the last flight event before the postmortem names it
                self.flight.record("fault", fault="crash", site="step",
                                   error=str(e))
                raise
        host, event = self._readback(toks)
        now = time.perf_counter()
        snaps = [(s, st) for s, st in enumerate(self._slots)
                 if st is not None]
        self.metrics.record_step(len(snaps), self.n_slots,
                                 len(self.scheduler))
        self.tracer.span(ENGINE_TRACK, "dispatch", t_call, now - t_call,
                         n_active=len(snaps))
        fam = "masked_step" if self._surface else "step"
        self._attr(("paged_" + fam) if self._paged else fam, t_call)
        if self.flight.enabled:
            self.flight.record(
                "dispatch", k=k, n_active=len(snaps),
                queue_depth=len(self.scheduler),
                **({"blocks_in_use": self.pool.n_blocks_in_use,
                    "blocks_free": self.pool.n_free_blocks}
                   if self._paged else {}))
        return _Inflight(host, event, snaps, t_call)

    def _surface_use(self) -> SurfaceUse:
        """The masked-step stages some live slot uses (from the host
        mirrors, which seats change only between horizons)."""
        live = [st for st in self._slots if st is not None]
        return SurfaceUse(
            mask=any(st.gkey is not None for st in live),
            bias=bool((self._slot_bias_idx >= 0).any()),
            top_k=bool((self._slot_topks > 0).any()),
            top_p=bool((self._slot_topps < 1.0).any()),
            sample=bool((self._slot_temps > 0).any()),
            logprobs=any(st.lp_out is not None for st in live))

    def _step_fn_for(self, k: int):
        """The step program of ``k`` substeps: the configured K's, or a
        K-1 program built once (the adaptive horizon)."""
        if k == self.decode_horizon:
            return self._step_fn
        if k not in self._step_fns:
            self._step_fns[k] = build_step_program(
                self._fwd1, k, self.temperature, self.top_k, self.device)
        return self._step_fns[k]

    def _masked_fn_for(self, k: int):
        """The masked step program of ``k`` substeps (as
        ``_step_fn_for``)."""
        if k == self.decode_horizon:
            return self._masked_fn
        if k not in self._masked_fns:
            self._masked_fns[k] = build_masked_step_program(
                self._fwd1, k, self._n_logprobs)
        return self._masked_fns[k]

    def _run_step(self, k: int) -> torch.Tensor:
        """Dispatch a ``k``-substep horizon's step program on the engine's
        state (the caches are updated in place): the base step, or the
        masked step when the surface is armed. Returns the (slots, k)
        token block, or the masked step's aux block."""
        adapters = self._adapter_operand()
        fam = "masked_step" if self._surface else "step"
        self.program_keys[("paged_" + fam) if self._paged else fam].add(k)
        if not self._surface:
            # greedy steps draw nothing: no key upload
            keys = None if self.temperature == 0 else self._key_words()
            (_, self._logits, self._dpos, self._dactive, self._dbudget,
             toks) = self._step_fn_for(k)(
                self.params, self.pool.operand(), self._logits, self._dpos,
                self._dactive, self._dbudget, self._deos, keys, adapters)
            return toks
        use = self._surface_use()
        (_, self._logits, self._dpos, self._dactive, self._dbudget,
         self._dgstate, aux) = self._masked_fn_for(k)(
            self.params, self.pool.operand(), self._logits, self._dpos,
            self._dactive, self._dbudget, self._deos, self._dgstate,
            *self._surface_operands(use), use, adapters)
        return aux

    def _key_words(self) -> torch.Tensor:
        """The slots' key words on the device; the host snapshot is what
        an attached sanitizer's alias tripwire tracks (checked at the
        horizon's readback)."""
        words = np.asarray(self._slot_keys, dtype=np.int64)  # lint: sync-ok host key list
        if self._san is not None:
            self._san.track("dispatch.slot_keys", words)
        return self._upload(words)

    def _adapter_operand(self):
        """The slots' (S,) LoRA rows on the device, or None when every
        slot holds adapter 0 (retired slots are reset to 0): those rows
        select the base activations, so skipping the bank gives the same
        bits."""
        if not self._slot_adapters.any():
            return None
        return self._upload(self._slot_adapters.copy())

    def _surface_operands(self, use: SurfaceUse) -> tuple:
        """The masked step's per-slot operands for ``use``: a stage left
        out gets None (nothing uploaded for it)."""
        up = self._upload
        keys = self._key_words() if use.sample else None
        mask_tab, trans_tab = (self._grammar_device_tables() if use.mask
                               else (None, None))
        return (keys,
                up(self._slot_temps.copy()) if use.sample else None,
                up(self._slot_topks.copy()) if use.top_k else None,
                up(self._slot_topps.copy()) if use.top_p else None,
                up(self._slot_bias_idx.copy()) if use.bias else None,
                up(self._slot_bias_val.copy()) if use.bias else None,
                mask_tab, trans_tab)

    # lint: hot-path
    def _process(self, horizon: _Inflight) -> None:
        """Wait for a horizon's token block and do the host bookkeeping:
        append tokens (replaying the device's EOS/budget stopping rule),
        stamp first tokens, retire finished slots. Blocks of slots retired
        or re-acquired since dispatch are dropped."""
        t_sync = time.perf_counter()
        if self._san is not None:
            self._san.note_horizon()
        if horizon.event is not None:
            horizon.event.synchronize()  # lint: sync-ok THE designated readback, 1/horizon
        toks_host = horizon.toks.numpy()  # lint: sync-ok the block is on the host (CPU: the readback)
        aux_host = None
        if toks_host.ndim == 3:
            # the masked step's aux block: [:, :, 0] the tokens, then the
            # bit patterns of the logprob rows (one readback all the same)
            aux_host = toks_host if toks_host.shape[2] > 1 else None
            toks_host = toks_host[:, :, 0]
        if self._san is not None:
            # the horizon that read the tracked buffers has completed:
            # verify nothing mutated them while it was in flight
            self._san.check("dispatch.slot_keys")
        now = time.perf_counter()
        self.metrics.record_readback(
            sync_wait_s=now - t_sync,
            overlap_s=max(0.0, t_sync - horizon.t_dispatch),
        )
        self.tracer.span(ENGINE_TRACK, "sync", t_sync, now - t_sync)
        # the readback proved every program dispatched up to this
        # horizon complete: price the pending attribution entries
        if self._pending_attr:
            self._flush_attr(horizon.t_dispatch, now)
        # a slot's decode span: dispatch to arrival, clipped at the next
        # horizon's dispatch (already made: pipelining), so one slot's
        # decode spans stay disjoint
        t_span_end = now
        if (self._inflight is not None
                and self._inflight.t_dispatch > horizon.t_dispatch):
            t_span_end = min(now, self._inflight.t_dispatch)
        for slot, st in horizon.snaps:
            if (self._slots[slot] is not st
                    or st.gen != self.pool.generation(slot)):
                continue  # retired/reused since dispatch: tokens dead
            req = st.req
            self.tracer.span(slot_track(slot), "decode", horizon.t_dispatch,
                             t_span_end - horizon.t_dispatch, req_id=req.id,
                             k=int(toks_host.shape[1]))  # lint: sync-ok host shape
            finished = False
            for k in range(toks_host.shape[1]):
                tok = int(toks_host[slot, k])  # lint: sync-ok host token block
                if st.t_first_token is None:
                    st.t_first_token = now
                    self.tracer.instant(slot_track(slot), "first_token",
                                        ts=now, req_id=req.id)
                    if req.arrival_time is not None:
                        self.metrics.record_first_token(
                            now - req.arrival_time)
                st.tokens.append(tok)
                if st.lp_out is not None and aux_host is not None:
                    st.lp_out.append(self._logprob_record(
                        aux_host[slot, k], tok, req.top_logprobs))
                if st.stop_matcher is None:
                    if req.stream is not None:
                        # the token is on the host with this horizon's one
                        # readback: streaming costs no device sync
                        req.stream.put(tok)
                else:
                    emitted, stripped = st.stop_matcher.push(tok)
                    if req.stream is not None:
                        for t in emitted:
                            req.stream.put(t)
                    if stripped:
                        # the matched stop sequence is not output: the
                        # device did not freeze the slot, so deactivate
                        del st.tokens[-stripped:]
                        if st.lp_out is not None:
                            del st.lp_out[-stripped:]
                        self.metrics.record_stop_hit()
                        self._retire(slot, RequestStatus.FINISHED, now,
                                     deactivate=True)
                        break
                if tok == req.eos_token or len(st.tokens) >= req.max_new:
                    finished = True
                    break  # the device mask froze this slot here too
            if finished:
                self._retire(slot, RequestStatus.FINISHED, now)

    def _logprob_record(self, row: np.ndarray, tok: int, n_top: int) -> dict:
        """One token's logprob record from its aux row: the chosen token's
        logprob and, with ``n_top``, the top alternatives."""
        nl = self._n_logprobs
        rec = {"token": tok, "logprob": float(row[1:2].view(np.float32)[0])}  # lint: sync-ok host aux row
        if n_top:
            ids = row[2:2 + nl][:n_top]
            vals = row[2 + nl:2 + 2 * nl].view(np.float32)[:n_top]
            rec["top_logprobs"] = [{"token": int(i), "logprob": float(v)}  # lint: sync-ok host aux row
                                   for i, v in zip(ids, vals)]
        return rec

    # lint: hot-path
    @torch.no_grad()
    def step(self) -> bool:
        """One horizon boundary: sweep, admit, dispatch the next horizon,
        read back and process the previous one, then run deferred prefill
        chunks. Returns False when
        there was nothing to do. Raises ``EngineCrash`` when the loop
        cannot go on (the caller recovers with :meth:`recover`)."""
        # the profiler brackets steps with work: an idle server loop's
        # polls are no engine steps
        prof = self.profile if self.profile is not None and (
            not self.idle or self._pending) else None
        if prof is not None:
            prof.step_start()
        now = time.perf_counter()
        try:
            self._set_phase("sweep")
            self._sweep_lifecycle(now)
            self._set_phase("admit")
            self._admit(now)
            self._pb_did_work = False
            self._set_phase("dispatch")
            prev, self._inflight = self._inflight, self._dispatch()
            if self._inflight is not None:
                self._steps += 1
            self._set_phase("process")
            if prev is not None:
                self._process(prev)
            # deferred prefills behind the new horizon: its token copy
            # does not wait on their chunks, and a failure here loses no
            # horizon
            if self._pending:
                self._set_phase("piggyback")
                self._advance_piggyback(decoding=self._inflight is not None)
        finally:
            self._set_phase(None)
            if prof is not None:
                prof.step_end()
        progressed = (prev is not None or self._inflight is not None
                      or self._pb_did_work)
        if self.tracer.enabled and progressed:
            t_end = time.perf_counter()
            self.tracer.span(ENGINE_TRACK, "step", now, t_end - now,
                             n=self._steps)
            self.tracer.counter(SCHEDULER_TRACK, "queue_depth",
                                len(self.scheduler), ts=t_end)
            self.tracer.counter(ENGINE_TRACK, "kv_slots_active",
                                self.pool.n_active, ts=t_end)
        return progressed

    def attach_sanitizer(self, san) -> None:
        """Attach an opt-in :class:`~..analysis.sanitizers.SyncSanitizer`:
        the engine stamps its phase (sweep/admit/dispatch/process/
        piggyback) onto the sanitizer's thread-local so syncs are
        attributed and budgeted, notes each horizon it processes, and
        registers each dispatch's host key words for the in-flight
        mutation check. Detach with ``attach_sanitizer(None)``."""
        self._san = san

    def _set_phase(self, phase: str | None) -> None:
        san = self._san
        if san is not None:
            san.set_phase(phase)

    def run(self, max_steps: int | None = None, *,
            max_restarts: int = 5) -> dict[str, np.ndarray]:
        """Step until every queued/active request is terminal, or until
        ``max_steps`` steps that did not crash have run, recovering from
        up to ``max_restarts`` crashes by replay before one propagates."""
        steps = 0
        restarts = 0
        while not self.idle:
            try:
                self.step()
            except EngineCrash:
                if restarts >= max_restarts:
                    raise
                restarts += 1
                self.recover()
                continue
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.results

    # -- crash recovery --------------------------------------------------------

    @torch.no_grad()
    def recover(self) -> int:
        """Rebuild the engine's device state by deterministic replay after a
        crash. The un-synced horizon (its pinned buffer and event) is
        dropped unread: its tokens were never recorded, so the replayed run
        makes them again. Deferred admissions go back to the queue front in
        order, keeping their keys. The pool, the prefix region and tree,
        the paged tables and the slot state are re-created zeroed; each
        live slot is rebuilt from its host record by chunked or stepwise
        replay (``chunked_replay``). Queued requests are untouched.
        Returns the number of slots replayed."""
        t_rec = time.perf_counter()
        self.metrics.record_restart()
        self.tracer.instant(ENGINE_TRACK, "crash", ts=t_rec)
        self.flight.record(
            "restart", n_live=sum(1 for st in self._slots if st is not None),
            queue_depth=len(self.scheduler),
            restarts=self.metrics.n_restarts)
        # the pending attribution entries lost their completion proof with
        # the abandoned state; replay is not serving time
        self._pending_attr.clear()
        self._attr_suspend += 1
        try:
            n = self._recover_inner()
        finally:
            self._attr_suspend -= 1
        now = time.perf_counter()
        self.tracer.span(ENGINE_TRACK, "recover", t_rec, now - t_rec,
                         mode=self.last_recover_mode, n_replayed=n)
        log_event(_log, "engine_recovered", mode=self.last_recover_mode,
                  n_replayed=n, restarts=self.metrics.n_restarts,
                  recover_s=round(now - t_rec, 6))
        return n

    def _recover_inner(self) -> int:
        self._inflight = None
        for rec in reversed(self._pending):
            pl = rec.plan
            if pl.seg is not None and self.prefix_cache is not None:
                self.prefix_cache.unpin(pl.seg)
                pl.seg = None
            self.pool.release(pl.slot)
            self.scheduler.requeue(pl.req)
        self._pending.clear()
        live = [(s, st) for s, st in enumerate(self._slots)
                if st is not None]
        chunked = bool(live) and self._use_chunked_replay()
        self.pool.reinit()
        self._reset_device_state()
        if self.prefix_cache is not None:
            # after pool.reinit: paged segments' block counts are gone
            self.prefix_cache.reinit()
            for _, st in live:
                st.segs = []
        self._slot_adapters[:] = 0
        for slot, st in live:
            self._slot_keys[slot] = st.key_data
            self._slot_adapters[slot] = st.req.adapter
            if self._surface:
                self._reseat_surface(slot, st)
        if self._surface:
            # the device tables shared the crash: upload them again
            self._gtab_version = -1
            self._dgstate = self._upload(self._slot_gstate.copy())
        self.last_recover_mode = (None if not live
                                  else "chunked" if chunked else "stepwise")
        if chunked:
            for slot, st in live:
                req = st.req
                seq = np.concatenate([req.prompt,
                                      np.asarray(st.tokens, np.int32)])
                self._prefill_seq_into_slot(
                    seq, slot, req.max_new - len(st.tokens), _eos_of(req),
                    req.adapter)
            return len(live)
        pos = np.zeros((self.n_slots,), np.int32)
        for slot, st in live:
            req = st.req
            self._prefill_seq_into_slot(req.prompt, slot, req.max_new,
                                        _eos_of(req), req.adapter)
            pos[slot] = len(req.prompt)
        adapters = self._adapter_operand()
        for j in range(max((len(st.tokens) for _, st in live), default=0)):
            toks = np.zeros((self.n_slots,), np.int32)
            replaying = np.zeros((self.n_slots,), bool)
            for slot, st in live:
                if j < len(st.tokens):
                    toks[slot] = st.tokens[j]
                    replaying[slot] = True
            _, self._logits = self._replay_fn(
                self.params, self.pool.operand(), self._logits,
                self._upload(toks), self._upload(pos.copy()),
                self._upload(replaying), adapters)
            pos += replaying
        # replay drove positions from the host: seat the device state on
        # the rebuilt trajectory
        active = np.zeros((self.n_slots,), bool)
        budget = np.zeros((self.n_slots,), np.int32)
        eos = np.full((self.n_slots,), _NO_EOS, np.int32)
        for slot, st in live:
            active[slot] = True
            budget[slot] = st.req.max_new - len(st.tokens)
            eos[slot] = _eos_of(st.req)
        self._dpos = self._upload(pos)
        self._dactive = self._upload(active)
        self._dbudget = self._upload(budget)
        self._deos = self._upload(eos)
        return len(live)


def run_request_trace(
    engine: ServingEngine,
    trace: list[tuple[float, Request]],
    *,
    time_scale: float = 1.0,
    max_restarts: int = 5,
) -> dict[str, np.ndarray]:
    """Replay an arrival trace against a live engine (the reference's
    ``run_request_trace``).

    ``trace`` holds (arrival offset in seconds, request) pairs; offsets are
    relative to the replay's start and scaled by ``time_scale`` (0 floods
    the engine with every request at once). The engine steps while it
    waits, as a serving loop would, so admissions interleave with decodes
    in flight. A submit refused with ``Backpressure`` is tried again on the
    next iteration (a step frees queue room), and an ``EngineCrash`` is
    recovered by replay up to ``max_restarts`` times before it propagates.
    Returns ``engine.results``."""
    order = sorted(range(len(trace)), key=lambda j: trace[j][0])
    t0 = time.perf_counter()
    i = 0
    pending: deque[Request] = deque()
    restarts = 0
    while i < len(order) or pending or not engine.idle:
        now = time.perf_counter() - t0
        while i < len(order) and trace[order[i]][0] * time_scale <= now:
            pending.append(trace[order[i]][1])
            i += 1
        while pending:
            try:
                engine.submit(pending[0])
            except Backpressure:
                break  # the queue is full: a step below frees room
            pending.popleft()
        try:
            progressed = engine.step()
        except EngineCrash:
            if restarts >= max_restarts:
                raise
            restarts += 1
            engine.recover()
            continue
        if not progressed and not pending and i < len(order):
            # an idle engine, the next arrival still ahead
            time.sleep(min(0.001, max(
                0.0, trace[order[i]][0] * time_scale - now)))
    return engine.results
