"""Serving latency/utilization metrics (the subset of
``deeplearning4j_tpu/serving/metrics.py`` that this slice's engine and
server use).

One recording API, two sinks: Prometheus instruments in a
:class:`~deeplearning4j_tpu_torch.obs.registry.MetricsRegistry` (what
``GET /metrics`` renders) and bounded reservoirs for ``summary()``'s
percentiles. The series:

- ``ttft`` — time to first token, from scheduler arrival to the host-visible
  first token (queueing and the pipelined readback lag count);
- ``tpot`` — time per output token after the first, per finished request;
- ``occupancy`` — active slots per dispatched horizon (the decode batch);
- ``queue_depth`` — queued requests, sampled per horizon;
- ``queue_delay`` — submit-to-admission wait;
- ``sync_wait`` / ``overlap`` — per readback, how long the host blocked on
  the token copy vs how long it worked while the horizon ran;
- prefix cache: lookups by outcome, tokens saved, inserts, evictions;
- supervision: transient-fault retries, replay restarts;
- piggyback: prefill chunks run for deferred admissions (and their
  tokens), and decode stall, the wall time occupied slots waited on
  admission prefill work (measured with piggyback on and off);
- ``phase_seconds``: every recorded second also attributed to one request
  phase, ``queue`` (submit to admission), ``prefill``, ``decode``
  (horizon dispatch to token-block arrival) and ``sync`` (the blocking
  slice of decode), as the labelled histogram ``serve_phase_seconds``.

Multi-tenant serving adds a ``tenant`` dimension: terminal outcomes,
generated tokens and rejections get the tenant-labelled families
``serve_tenant_requests_total``, ``serve_tenant_tokens_total`` and
``serve_rejections_total``, per-tenant TPOT and queue-delay reservoirs feed
a ``tenants`` block in ``summary()``, and a tenant with a p99-TPOT
objective (``set_tenant_slo``) gets ``serve_tenant_slo_burn{tenant}`` =
observed p99 / objective at every render. The per-tenant state is made on
the first event that carries a tenant id, so a single-tenant engine pays
nothing.

Batched admission counts the admissions that shared a prefill dispatch
(``serve_prefill_batched_total``); embedding lookups served at the
admission boundary get ``serve_embeddings_total{model}`` and the
``serve_embedding_seconds`` histogram. Per-program-family attribution
(``record_program``) adds ``serve_program_seconds_total{family}`` and
``serve_program_dispatches_total{family}``: the wall seconds from a
program's dispatch call to the horizon readback that proves it complete,
an upper bound on its device time, with no sync of its own (the
reference's definition). Against the audit's per-family flop and byte
budgets (``analysis/audit_baseline.json``, ``family_budgets``), a render
publishes ``serve_mfu{family}`` and ``serve_mbu{family}`` — budget x
dispatches / seconds / the card's peak — for a card whose peaks are known
by name (``_DEVICE_PEAKS``: the H100); any other device, the CPU
included, publishes seconds only.

The KV wire and live migration (the reference's families):
``serve_kv_exports_total``, ``serve_kv_export_bytes_total``,
``serve_kv_ingests_total{result}``, ``serve_kv_ingest_bytes_total``,
``serve_transfers_total{result}``, ``serve_transfer_bytes_total``,
``serve_migrations_out_total``, ``serve_migrations_in_total{result}``,
``serve_migrations_settled_total{result}`` and the export, ingest,
transfer and seat histograms; ``summary()`` gains ``disagg`` and
``migration`` blocks once either moved.

With a ``writer`` (a :class:`~deeplearning4j_tpu_torch.utils.metrics.
MetricsWriter`), every record also goes out as a JSONL scalar tagged
``f"{prefix}/{name}"``, as the reference's: ``occupancy``,
``occupancy_frac`` and ``queue_depth`` at the step counter, and
``ttft_seconds``, ``tpot_seconds``, ``queue_delay_seconds``,
``sync_wait_seconds``, ``overlap_seconds``, ``retries_total``,
``restarts_total``, ``failed_total``, ``cancelled_total``,
``expired_total``, ``prefix_tokens_saved_total``, ``embedding_seconds``,
the KV wire's ``kv_export_seconds``, ``kv_ingest_seconds`` and
``transfer_seconds``, and the migration's ``migration_export_seconds`` and
``migration_seat_seconds``. Without a writer nothing is written.

Series names are the reference's, so its dashboards carry over.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

import numpy as np

from deeplearning4j_tpu_torch.analysis.sanitizers import (
    note_access,
    wrap_lock,
)
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, Reservoir

if TYPE_CHECKING:
    from deeplearning4j_tpu_torch.utils.metrics import MetricsWriter

RESERVOIR_CAP = 4096
#: (name fragment, dense bf16 FLOP/s, HBM bytes/s) of the cards whose peaks
#: the MFU/MBU gauges divide by: the H100 SXM's published dense rates (its
#: name, "NVIDIA H100 80GB HBM3") and the H100 PCIe's
_DEVICE_PEAKS = (
    ("H100 80GB HBM3", 989e12, 3.35e12),
    ("H100 PCIe", 756e12, 2.0e12),
)
#: the request phases the per-phase breakdown attributes time to
PHASES = ("queue", "prefill", "decode", "sync")


def device_peaks(device) -> tuple[float, float] | None:
    """``(dense bf16 FLOP/s, HBM bytes/s)`` of a CUDA device whose name
    ``_DEVICE_PEAKS`` knows, else None (the CPU, an unknown card)."""
    if device is None or getattr(device, "type", str(device)) != "cuda":
        return None
    import torch

    name = torch.cuda.get_device_name(device)
    for frag, flops, bw in _DEVICE_PEAKS:
        if frag in name:
            return flops, bw
    return None


def _pct(res: Reservoir, p: float) -> float:
    return float(np.percentile(np.asarray(res.values, np.float64), p))


class ServingMetrics:
    def __init__(self, registry: MetricsRegistry | None = None,
                 reservoir_cap: int = RESERVOIR_CAP, *,
                 writer: MetricsWriter | None = None,
                 prefix: str = "serve"):
        self.writer = writer
        self.prefix = prefix
        self.registry = registry if registry is not None else MetricsRegistry()
        self.ttft = Reservoir(reservoir_cap)
        self.tpot = Reservoir(reservoir_cap)
        self.occupancy = Reservoir(reservoir_cap)
        self.queue_depth = Reservoir(reservoir_cap)
        self.queue_delay = Reservoir(reservoir_cap)
        self.sync_wait = Reservoir(reservoir_cap)
        self.overlap = Reservoir(reservoir_cap)
        self.decode_horizon = 1
        self.n_finished = 0
        self.n_generated = 0
        self.n_failed = 0
        self.n_cancelled = 0
        self.n_expired = 0
        self.n_backpressure = 0
        self.n_retries = 0
        self.n_restarts = 0
        self.n_prefix_hits_full = 0
        self.n_prefix_hits_partial = 0
        self.n_prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.n_prefix_inserts = 0
        self.n_prefix_evictions = 0
        self.n_prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.decode_stall_seconds = 0.0
        self.phase_seconds = {p: 0.0 for p in PHASES}
        # per-program-family attribution, recorded by the engine thread
        # at readback (no lock, like phase_seconds)
        self.program_seconds: dict[str, float] = {}
        self.program_dispatches: dict[str, int] = {}
        #: the device the programs run on (the engine sets it): its name
        #: picks the peaks the MFU/MBU gauges divide by
        self.device = None
        self._family_budgets: dict | None = None  # lazy, from the audit
        self._peaks: tuple[float, float] | None = None
        self.n_batched_admissions = 0
        self.n_embeddings = 0
        self.embed_latency = Reservoir(reservoir_cap)
        # the KV wire (see .disagg): exports = segments prefilled here for
        # another replica, ingests = wire segments offered to the local
        # prefix cache, transfers = pushes to a decode replica's
        # /v1/kv_segment (recorded by the HTTP layer)
        self.n_kv_exports = 0
        self.kv_export_bytes = 0
        self.n_kv_ingests_stored = 0
        self.n_kv_ingests_declined = 0
        self.kv_ingest_bytes = 0
        self.n_transfers = 0
        self.n_transfer_failures = 0
        self.transfer_bytes = 0
        self.transfer_seconds = 0.0
        self.kv_export_latency = Reservoir(reservoir_cap)
        self.kv_ingest_latency = Reservoir(reservoir_cap)
        self.transfer_latency = Reservoir(reservoir_cap)
        # live session migration: slots parked here and shipped out,
        # sessions offered here (seated or declined), parked requests
        # settled by the destination (ok) or the fallback (failed)
        self.n_migrations_out = 0
        self.n_migrations_seated = 0
        self.n_migrations_declined = 0
        self.n_migrations_settled_ok = 0
        self.n_migrations_settled_failed = 0
        self.migration_seat_latency = Reservoir(reservoir_cap)
        self._step = 0
        self._reservoir_cap = reservoir_cap
        # per-tenant state, made on the first event with a tenant id;
        # handler threads record rejections while the engine thread
        # records outcomes, so it moves under a lock
        self._tlock = wrap_lock(threading.Lock(), "metrics._tlock")
        self._tenants: dict[str, dict] = {}  # guarded-by: _tlock
        self.n_rejections: dict[str, int] = {}  # guarded-by: _tlock
        self._tenant_slos: dict[str, float] = {}  # guarded-by: _tlock
        reg = self.registry
        self._c_requests = reg.counter(
            "serve_requests_total", "Terminal request outcomes by status.",
            ("outcome",),
        )
        self._c_tokens = reg.counter(
            "serve_tokens_generated_total", "Tokens generated (all requests).",
        )
        self._c_steps = reg.counter(
            "serve_engine_steps_total",
            "Decode horizons dispatched (K substeps each).",
        )
        self._c_backpressure = reg.counter(
            "serve_backpressure_total",
            "Submits rejected at max queue depth (HTTP 429).",
        )
        self._c_retries = reg.counter(
            "serve_retries_total", "Transient-fault boundary retries.",
        )
        self._c_restarts = reg.counter(
            "serve_restarts_total", "Engine rebuilds by deterministic replay.",
        )
        self._c_prefix_lookups = reg.counter(
            "serve_prefix_lookups_total",
            "Prefix-cache lookups by outcome (hit_full|hit_partial|miss).",
            ("result",),
        )
        self._c_prefix_saved = reg.counter(
            "serve_prefix_tokens_saved_total",
            "Prompt tokens served from cached KV instead of prefill.",
        )
        self._c_prefix_inserts = reg.counter(
            "serve_prefix_inserts_total", "Prefix segments cached.",
        )
        self._c_prefix_evictions = reg.counter(
            "serve_prefix_evictions_total",
            "Prefix segments evicted (LRU, never pinned ones).",
        )
        self._c_prefill_chunks = reg.counter(
            "serve_prefill_chunks_total",
            "Bounded prefill chunks executed for deferred piggyback "
            "admissions.",
        )
        self._c_decode_stall = reg.counter(
            "serve_decode_stall_seconds_total",
            "Wall seconds occupied decode slots sat stalled behind "
            "admission prefill work.",
        )
        self._c_grammar_compiles = reg.counter(
            "serve_grammar_compiles_total",
            "Grammar constraint resolutions at submit, by result "
            "(hit = LRU/disk cache, miss = fresh DFA compile, "
            "error = rejected 400).", ("result",),
        )
        self._c_stop_hits = reg.counter(
            "serve_stop_hits_total",
            "Requests finished by a stop-sequence match (host-side "
            "suffix match at readback).",
        )
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", "Time to first token, from scheduler arrival.",
        )
        self._h_tpot = reg.histogram(
            "serve_tpot_seconds", "Time per output token after the first.",
        )
        self._h_phase = reg.histogram(
            "serve_phase_seconds",
            "Per-event wall seconds by request phase "
            "(queue|prefill|decode|sync).", ("phase",),
        )
        self._c_rejections = reg.counter(
            "serve_rejections_total",
            "Submits shed before queueing, by reason "
            "(backpressure|quota) and tenant.", ("reason", "tenant"),
        )
        self._c_tenant_requests = reg.counter(
            "serve_tenant_requests_total",
            "Terminal request outcomes by tenant.", ("tenant", "outcome"),
        )
        self._c_tenant_tokens = reg.counter(
            "serve_tenant_tokens_total", "Tokens generated per tenant.",
            ("tenant",),
        )
        self._g_slo_burn = reg.gauge(
            "serve_tenant_slo_burn",
            "Observed p99 TPOT / tenant SLO objective (> 1 = violating).",
            ("tenant",),
        )
        self._c_batched = reg.counter(
            "serve_prefill_batched_total",
            "Admissions coalesced into shared same-bucket prefill "
            "dispatches.",
        )
        self._c_embeddings = reg.counter(
            "serve_embeddings_total",
            "Embedding requests served, by model.", ("model",),
        )
        self._h_embed = reg.histogram(
            "serve_embedding_seconds",
            "Embedding request service time (host-side lookup).",
        )
        self._c_kv_exports = reg.counter(
            "serve_kv_exports_total",
            "KV segments prefilled here and exported for a decode "
            "replica (disaggregated serving).")
        self._c_kv_export_bytes = reg.counter(
            "serve_kv_export_bytes_total",
            "Raw segment bytes exported over the KV wire.")
        self._h_kv_export = reg.histogram(
            "serve_kv_export_seconds",
            "Export service time: prefill + host snapshot.")
        self._c_kv_ingests = reg.counter(
            "serve_kv_ingests_total",
            "Wire KV segments offered to the local prefix cache, by "
            "result (stored|declined).", ("result",))
        self._c_kv_ingest_bytes = reg.counter(
            "serve_kv_ingest_bytes_total",
            "Raw segment bytes received over the KV wire.")
        self._h_kv_ingest = reg.histogram(
            "serve_kv_ingest_seconds",
            "Ingest service time: validate + device seat.")
        self._c_transfers = reg.counter(
            "serve_transfers_total",
            "KV segment pushes to a decode replica, by result "
            "(ok|failed).", ("result",))
        self._c_transfer_bytes = reg.counter(
            "serve_transfer_bytes_total",
            "Frame bytes pushed to decode replicas over the KV wire.")
        self._h_transfer = reg.histogram(
            "serve_transfer_seconds",
            "One KV segment push: POST /v1/kv_segment round trip.")
        self._c_migrations_out = reg.counter(
            "serve_migrations_out_total",
            "Live sessions exported (parked) at drain for re-seating on "
            "another replica.")
        self._c_migrations_in = reg.counter(
            "serve_migrations_in_total",
            "Migrated live sessions offered to this engine, by result "
            "(seated|declined).", ("result",))
        self._c_migrations_settled = reg.counter(
            "serve_migrations_settled_total",
            "Parked requests resolved, by result (ok = destination "
            "finished the stream, failed = fallback preemption).",
            ("result",))
        self._h_migration_seat = reg.histogram(
            "serve_migration_seat_seconds",
            "One migrated session seat: validate + device insert.")
        self._c_prog_seconds = reg.counter(
            "serve_program_seconds_total",
            "Wall seconds attributed to program families at the "
            "horizon-readback boundary (dispatch call to post-sync flush: "
            "an upper bound that includes async overlap).", ("family",),
        )
        self._c_prog_dispatches = reg.counter(
            "serve_program_dispatches_total",
            "Program dispatches by family.", ("family",),
        )
        self._g_mfu = reg.gauge(
            "serve_mfu",
            "Live model-flop utilization per program family: audited "
            "envelope flops x dispatches / measured seconds / the card's "
            "peak, clamped to 1. Exact at the audit geometry; a scale "
            "reference otherwise.", ("family",))
        self._g_mbu = reg.gauge(
            "serve_mbu",
            "Live memory-bandwidth utilization per program family: "
            "audited arg+out bytes x dispatches / measured seconds / the "
            "card's peak HBM bandwidth, clamped to 1. Exact at the audit "
            "geometry; a scale reference otherwise.", ("family",))

    def _emit(self, tag: str, value: float, step: int | None = None) -> None:
        if self.writer is not None:
            self.writer.scalar(f"{self.prefix}/{tag}", value, step)

    def _tenant(self, tenant_id: str) -> dict:  # lint: holds _tlock
        """Per-tenant counters and reservoirs (call holding ``_tlock``)."""
        st = self._tenants.get(tenant_id)
        if st is None:
            note_access("metrics.tenants", write=True)
            st = self._tenants[tenant_id] = {
                "tpot": Reservoir(self._reservoir_cap),
                "queue_delay": Reservoir(self._reservoir_cap),
                "n_finished": 0, "n_generated": 0, "n_rejected": 0,
                "n_other": 0,
            }
        return st

    def record_phase(self, phase: str, seconds: float) -> None:
        """Attribute ``seconds`` of wall time to a request phase."""
        self.phase_seconds[phase] += float(seconds)
        self._h_phase.observe(float(seconds), phase=phase)

    def record_program(self, family: str, seconds: float) -> None:
        """Attribute one program dispatch's wall interval (dispatch call to
        the readback that proved it complete) to its family."""
        self.program_seconds[family] = (
            self.program_seconds.get(family, 0.0) + float(seconds))
        self.program_dispatches[family] = (
            self.program_dispatches.get(family, 0) + 1)
        self._c_prog_seconds.inc(float(seconds), family=family)
        self._c_prog_dispatches.inc(family=family)

    def record_batched_admissions(self, n: int) -> None:
        """``n`` admissions served by one shared prefill dispatch
        (recorded once a coalesced group, n >= 2)."""
        self.n_batched_admissions += int(n)
        self._c_batched.inc(int(n))

    def record_embedding(self, model: str, n_words: int, seconds: float,
                         tenant: str = "") -> None:
        """One embedding request served on the host (``n_words`` lookups
        against the ``model`` embedder, no KV slot)."""
        self.n_embeddings += 1
        self.embed_latency.add(float(seconds))
        self._c_embeddings.inc(model=model)
        self._h_embed.observe(float(seconds))
        self._emit("embedding_seconds", seconds)
        if tenant:
            self._c_tenant_requests.inc(tenant=tenant, outcome="embedding")
            with self._tlock:
                self._tenant(tenant)["n_finished"] += 1

    def record_kv_export(self, n_tokens: int, nbytes: int, seconds: float,
                         tenant: str = "") -> None:
        """One KV segment prefilled here for a decode replica."""
        self.n_kv_exports += 1
        self.kv_export_bytes += int(nbytes)
        self.kv_export_latency.add(float(seconds))
        self._c_kv_exports.inc()
        self._c_kv_export_bytes.inc(int(nbytes))
        self._h_kv_export.observe(seconds)
        self._emit("kv_export_seconds", seconds)
        if tenant:
            self._c_tenant_requests.inc(tenant=tenant, outcome="kv_export")
            with self._tlock:
                self._tenant(tenant)["n_finished"] += 1

    def record_kv_ingest(self, n_tokens: int, nbytes: int, seconds: float,
                         *, stored: bool, tenant: str = "") -> None:
        """One wire segment offered to the local prefix cache; ``stored``
        means the follow-up generate will full-hit."""
        if stored:
            self.n_kv_ingests_stored += 1
        else:
            self.n_kv_ingests_declined += 1
        self.kv_ingest_bytes += int(nbytes)
        self.kv_ingest_latency.add(float(seconds))
        self._c_kv_ingests.inc(result="stored" if stored else "declined")
        self._c_kv_ingest_bytes.inc(int(nbytes))
        self._h_kv_ingest.observe(seconds)
        self._emit("kv_ingest_seconds", seconds)
        if tenant:
            self._c_tenant_requests.inc(tenant=tenant, outcome="kv_ingest")
            with self._tlock:
                self._tenant(tenant)["n_finished"] += 1

    def record_transfer(self, nbytes: int, seconds: float, *,
                        ok: bool = True) -> None:
        """One KV segment push to a decode replica (the HTTP layer); a
        failed push records its time but no bytes."""
        self.n_transfers += 1
        self.transfer_latency.add(float(seconds))
        self.transfer_seconds += float(seconds)
        self._c_transfers.inc(result="ok" if ok else "failed")
        self._h_transfer.observe(seconds)
        self._emit("transfer_seconds", seconds)
        if ok:
            self.transfer_bytes += int(nbytes)
            self._c_transfer_bytes.inc(int(nbytes))
        else:
            self.n_transfer_failures += 1

    def record_migration_out(self, n_generated: int, seconds: float,
                             tenant: str = "") -> None:
        """One live slot exported (parked) for migration."""
        self.n_migrations_out += 1
        self._c_migrations_out.inc()
        self._emit("migration_export_seconds", seconds)

    def record_migration_in(self, n_generated: int, seconds: float, *,
                            seated: bool, tenant: str = "") -> None:
        """One migrated session offered to this engine (a decline is
        soft: the source keeps its fail path)."""
        if seated:
            self.n_migrations_seated += 1
        else:
            self.n_migrations_declined += 1
        self.migration_seat_latency.add(float(seconds))
        self._c_migrations_in.inc(result="seated" if seated else "declined")
        self._h_migration_seat.observe(seconds)
        self._emit("migration_seat_seconds", seconds)
        if tenant and seated:
            self._c_tenant_requests.inc(tenant=tenant, outcome="migrated_in")

    def record_migration_settled(self, *, ok: bool, tenant: str = "") -> None:
        """One parked request resolved: by the destination's stream (ok)
        or by the fallback to preemption."""
        if ok:
            self.n_migrations_settled_ok += 1
        else:
            self.n_migrations_settled_failed += 1
        self._c_migrations_settled.inc(result="ok" if ok else "failed")

    def record_step(self, n_active: int, n_slots: int,
                    queue_depth: int) -> None:
        """One dispatched horizon with ``n_active`` of ``n_slots`` slots
        decoding."""
        self.occupancy.add(float(n_active))
        self.queue_depth.add(int(queue_depth))
        self._c_steps.inc()
        self._emit("occupancy", n_active, self._step)
        self._emit("occupancy_frac", n_active / n_slots, self._step)
        self._emit("queue_depth", queue_depth, self._step)
        self._step += 1

    def record_admitted(self, delay_s: float, tenant: str = "") -> None:
        self.queue_delay.add(float(delay_s))
        self.record_phase("queue", delay_s)
        self._emit("queue_delay_seconds", delay_s)
        if tenant:
            with self._tlock:
                self._tenant(tenant)["queue_delay"].add(float(delay_s))

    def record_prefill(self, seconds: float) -> None:
        self.record_phase("prefill", seconds)

    def record_readback(self, sync_wait_s: float, overlap_s: float) -> None:
        self.sync_wait.add(float(sync_wait_s))
        self.overlap.add(float(overlap_s))
        self.record_phase("decode", float(sync_wait_s) + float(overlap_s))
        self.record_phase("sync", sync_wait_s)
        self._emit("sync_wait_seconds", sync_wait_s)
        self._emit("overlap_seconds", overlap_s)

    def record_first_token(self, ttft_s: float) -> None:
        self.ttft.add(float(ttft_s))
        self._h_ttft.observe(ttft_s)
        self._emit("ttft_seconds", ttft_s)

    def record_finished(self, n_tokens: int, decode_s: float,
                        tenant: str = "") -> None:
        """Request retired with ``n_tokens`` generated, ``decode_s`` wall
        seconds after its first token."""
        self.n_finished += 1
        self.n_generated += n_tokens
        self._c_requests.inc(outcome="finished")
        self._c_tokens.inc(n_tokens)
        tpot = None
        if n_tokens > 1:
            tpot = decode_s / (n_tokens - 1)
            self.tpot.add(tpot)
            self._h_tpot.observe(tpot)
            self._emit("tpot_seconds", tpot)
        if tenant:
            self._c_tenant_requests.inc(tenant=tenant, outcome="finished")
            self._c_tenant_tokens.inc(n_tokens, tenant=tenant)
            with self._tlock:
                st = self._tenant(tenant)
                st["n_finished"] += 1
                st["n_generated"] += n_tokens
                if tpot is not None:
                    st["tpot"].add(tpot)

    def record_backpressure(self) -> None:
        self.n_backpressure += 1
        self._c_backpressure.inc()

    def record_rejection(self, reason: str, tenant: str = "") -> None:
        """One submit shed before queueing (``backpressure`` = queue
        depth, ``quota`` = the tenant's bucket dry), recorded beside
        :meth:`record_backpressure`."""
        self._c_rejections.inc(reason=reason, tenant=tenant)
        with self._tlock:
            self.n_rejections[reason] = self.n_rejections.get(reason, 0) + 1
            if tenant:
                self._tenant(tenant)["n_rejected"] += 1

    def set_tenant_slo(self, tenant_id: str, p99_tpot_s: float) -> None:
        """Declare a tenant's p99 TPOT objective (seconds): every render
        then publishes ``serve_tenant_slo_burn{tenant}`` once the tenant
        has TPOT samples."""
        if p99_tpot_s <= 0:
            raise ValueError("p99_tpot_s must be > 0")
        with self._tlock:
            self._tenant_slos[tenant_id] = float(p99_tpot_s)

    def _update_slo_burn(self) -> None:
        """Refresh the burn gauges from the per-tenant TPOT reservoirs (a
        tenant without samples publishes nothing: a 0 would read as a
        perfect SLO)."""
        with self._tlock:
            for tid, target in self._tenant_slos.items():
                st = self._tenants.get(tid)
                if st is not None and st["tpot"]:
                    self._g_slo_burn.set(_pct(st["tpot"], 99) / target,
                                         tenant=tid)

    def record_grammar_compile(self, result: str) -> None:
        """One grammar constraint resolution (hit|miss|error)."""
        self._c_grammar_compiles.inc(result=result)

    def record_stop_hit(self) -> None:
        """One request finished by a stop-sequence match."""
        self._c_stop_hits.inc()

    def record_retry(self) -> None:
        """One transient-fault retry at an engine boundary."""
        self.n_retries += 1
        self._c_retries.inc()
        self._emit("retries_total", self.n_retries)

    def record_restart(self) -> None:
        """One engine-state rebuild by deterministic replay."""
        self.n_restarts += 1
        self._c_restarts.inc()
        self._emit("restarts_total", self.n_restarts)

    def record_prefix_lookup(self, result: str, saved_tokens: int) -> None:
        """One admission-time prefix-cache lookup: ``result`` is
        ``hit_full``/``hit_partial``/``miss``, ``saved_tokens`` the prompt
        tokens the hit served from cached KV (0 on a miss)."""
        self._c_prefix_lookups.inc(result=result)
        if result == "hit_full":
            self.n_prefix_hits_full += 1
        elif result == "hit_partial":
            self.n_prefix_hits_partial += 1
        else:
            self.n_prefix_misses += 1
        if saved_tokens:
            self.prefix_tokens_saved += int(saved_tokens)
            self._c_prefix_saved.inc(int(saved_tokens))
            self._emit("prefix_tokens_saved_total", self.prefix_tokens_saved)

    def record_prefix_insert(self) -> None:
        self.n_prefix_inserts += 1
        self._c_prefix_inserts.inc()

    def record_prefix_eviction(self) -> None:
        self.n_prefix_evictions += 1
        self._c_prefix_evictions.inc()

    def record_prefill_chunk(self, tokens: int) -> None:
        """One bounded prefill chunk run for a deferred (piggyback)
        admission."""
        self.n_prefill_chunks += 1
        self.prefill_chunk_tokens += int(tokens)
        self._c_prefill_chunks.inc()

    def record_decode_stall(self, seconds: float) -> None:
        """Wall time occupied decode slots waited on admission prefill."""
        self.decode_stall_seconds += float(seconds)
        self._c_decode_stall.inc(float(seconds))

    def record_outcome(self, status, tenant: str = "") -> None:
        """A non-FINISHED terminal outcome (``RequestStatus`` or its value)."""
        s = getattr(status, "value", status)
        self._c_requests.inc(outcome=s)
        if tenant:
            self._c_tenant_requests.inc(tenant=tenant, outcome=s)
            with self._tlock:
                self._tenant(tenant)["n_other"] += 1
        if s == "failed":
            self.n_failed += 1
            self._emit("failed_total", self.n_failed)
        elif s == "cancelled":
            self.n_cancelled += 1
            self._emit("cancelled_total", self.n_cancelled)
        elif s == "expired":
            self.n_expired += 1
            self._emit("expired_total", self.n_expired)

    def _update_program_util(self) -> None:
        """Refresh the per-family MFU/MBU gauges: measured seconds
        (``record_program``) divided into the audit's flop/byte budgets.
        Render-time only: the hot path never touches this. Nothing is
        published without budgets or without the card's peaks."""
        if not self.program_dispatches:
            return
        if self._family_budgets is None:
            try:
                from deeplearning4j_tpu_torch.analysis.programs import (
                    family_budgets,
                )

                self._family_budgets = family_budgets()
            except Exception:
                self._family_budgets = {}
        if self._peaks is None:
            self._peaks = device_peaks(self.device) or ()
        if not self._family_budgets or not self._peaks:
            return  # seconds-only attribution
        peak_flops, peak_bw = self._peaks
        for family, n in list(self.program_dispatches.items()):
            budget = self._family_budgets.get(family)
            secs = self.program_seconds.get(family, 0.0)
            if budget is None or secs <= 0.0:
                continue
            self._g_mfu.set(
                min(1.0, budget["flops"] * n / secs / peak_flops),
                family=family)
            self._g_mbu.set(
                min(1.0, budget["bytes"] * n / secs / peak_bw),
                family=family)

    def render_prometheus(self) -> str:
        self._update_slo_burn()
        self._update_program_util()
        return self.registry.render()

    def summary(self) -> dict:
        out = {
            "n_finished": self.n_finished,
            "n_generated": self.n_generated,
            "n_failed": self.n_failed,
            "n_cancelled": self.n_cancelled,
            "n_expired": self.n_expired,
            "steps": self._step,
            "decode_horizon": self.decode_horizon,
            "n_retries": self.n_retries,
            "n_restarts": self.n_restarts,
        }
        lookups = (self.n_prefix_hits_full + self.n_prefix_hits_partial
                   + self.n_prefix_misses)
        if lookups:
            out["prefix_lookups"] = lookups
            out["prefix_hit_rate"] = (
                (self.n_prefix_hits_full + self.n_prefix_hits_partial)
                / lookups)
            out["prefix_tokens_saved"] = self.prefix_tokens_saved
            out["prefix_inserts"] = self.n_prefix_inserts
            out["prefix_evictions"] = self.n_prefix_evictions
        if self.n_batched_admissions:
            out["batched_admissions"] = self.n_batched_admissions
        if self.n_prefill_chunks:
            out["prefill_chunks"] = self.n_prefill_chunks
            out["prefill_chunk_tokens"] = self.prefill_chunk_tokens
        if self.decode_stall_seconds > 0:
            out["decode_stall_s"] = self.decode_stall_seconds
        if self.n_embeddings:
            out["n_embeddings"] = self.n_embeddings
            out["embedding_p50_s"] = _pct(self.embed_latency, 50)
        if (self.n_kv_exports or self.n_transfers
                or self.n_kv_ingests_stored or self.n_kv_ingests_declined):
            d = {
                "kv_exports": self.n_kv_exports,
                "kv_export_bytes": self.kv_export_bytes,
                "kv_ingests_stored": self.n_kv_ingests_stored,
                "kv_ingests_declined": self.n_kv_ingests_declined,
                "kv_ingest_bytes": self.kv_ingest_bytes,
                "transfers": self.n_transfers,
                "transfer_failures": self.n_transfer_failures,
                "transfer_bytes": self.transfer_bytes,
            }
            if self.kv_export_latency:
                d["kv_export_p50_s"] = _pct(self.kv_export_latency, 50)
            if self.transfer_latency:
                d["transfer_p50_s"] = _pct(self.transfer_latency, 50)
                if self.transfer_seconds > 0:
                    d["transfer_bytes_per_s"] = (self.transfer_bytes
                                                 / self.transfer_seconds)
            out["disagg"] = d
        if (self.n_migrations_out or self.n_migrations_seated
                or self.n_migrations_declined):
            d = {
                "migrations_out": self.n_migrations_out,
                "migrations_seated": self.n_migrations_seated,
                "migrations_declined": self.n_migrations_declined,
                "migrations_settled_ok": self.n_migrations_settled_ok,
                "migrations_settled_failed":
                    self.n_migrations_settled_failed,
            }
            if self.migration_seat_latency:
                d["seat_p50_s"] = _pct(self.migration_seat_latency, 50)
                d["seat_p99_s"] = _pct(self.migration_seat_latency, 99)
            out["migration"] = d
        with self._tlock:
            if self.n_rejections:
                out["rejections"] = dict(self.n_rejections)
            if self._tenants:
                out["tenants"] = {tid: self._tenant_summary(tid)
                                  for tid in sorted(self._tenants)}
        for name, xs in (("ttft", self.ttft), ("tpot", self.tpot),
                         ("queue_delay", self.queue_delay)):
            if xs:
                out[f"{name}_p50_s"] = _pct(xs, 50)
                out[f"{name}_p99_s"] = _pct(xs, 99)
        if self.sync_wait:
            sync, over = self.sync_wait.total, self.overlap.total
            out["sync_wait_mean_s"] = sync / len(self.sync_wait)
            if sync + over > 0:
                out["dispatch_overlap_frac"] = over / (sync + over)
        if self.occupancy:
            out["occupancy_mean"] = self.occupancy.mean
            out["queue_depth_max"] = int(self.queue_depth.max)
        if self.program_dispatches:
            out["program_seconds"] = dict(sorted(
                self.program_seconds.items()))
            out["program_dispatches"] = dict(sorted(
                self.program_dispatches.items()))
        attributed = sum(self.phase_seconds.values())
        if attributed > 0:
            out["phase_seconds"] = dict(self.phase_seconds)
            out["phase_frac"] = {p: v / attributed
                                 for p, v in self.phase_seconds.items()}
        return out

    def _tenant_summary(self, tid: str) -> dict:  # lint: holds _tlock
        st = self._tenants[tid]
        t = {"n_finished": st["n_finished"],
             "n_generated": st["n_generated"]}
        if st["n_rejected"]:
            t["n_rejected"] = st["n_rejected"]
        if st["n_other"]:
            t["n_other_outcomes"] = st["n_other"]
        if st["tpot"]:
            t["tpot_p50_s"] = _pct(st["tpot"], 50)
            t["tpot_p99_s"] = _pct(st["tpot"], 99)
            slo = self._tenant_slos.get(tid)
            if slo is not None:
                t["slo_burn"] = t["tpot_p99_s"] / slo
        if st["queue_delay"]:
            t["queue_delay_p50_s"] = _pct(st["queue_delay"], 50)
            t["queue_delay_p99_s"] = _pct(st["queue_delay"], 99)
        return t
