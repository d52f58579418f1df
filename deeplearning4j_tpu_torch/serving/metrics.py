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
  the token copy vs how long it worked while the horizon ran.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, Reservoir

RESERVOIR_CAP = 4096


def _pct(res: Reservoir, p: float) -> float:
    return float(np.percentile(np.asarray(res.values, np.float64), p))


class ServingMetrics:
    def __init__(self, registry: MetricsRegistry | None = None,
                 reservoir_cap: int = RESERVOIR_CAP):
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
        self.prefill_seconds = 0.0
        self._step = 0
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
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", "Time to first token, from scheduler arrival.",
        )
        self._h_tpot = reg.histogram(
            "serve_tpot_seconds", "Time per output token after the first.",
        )
        self._h_prefill = reg.histogram(
            "serve_prefill_seconds", "Admission prefill wall time per request.",
        )

    def record_step(self, n_active: int, queue_depth: int) -> None:
        """One dispatched horizon with ``n_active`` slots decoding."""
        self.occupancy.add(float(n_active))
        self.queue_depth.add(int(queue_depth))
        self._c_steps.inc()
        self._step += 1

    def record_admitted(self, delay_s: float) -> None:
        self.queue_delay.add(float(delay_s))

    def record_prefill(self, seconds: float) -> None:
        self.prefill_seconds += float(seconds)
        self._h_prefill.observe(seconds)

    def record_readback(self, sync_wait_s: float, overlap_s: float) -> None:
        self.sync_wait.add(float(sync_wait_s))
        self.overlap.add(float(overlap_s))

    def record_first_token(self, ttft_s: float) -> None:
        self.ttft.add(float(ttft_s))
        self._h_ttft.observe(ttft_s)

    def record_finished(self, n_tokens: int, decode_s: float) -> None:
        """Request retired with ``n_tokens`` generated, ``decode_s`` wall
        seconds after its first token."""
        self.n_finished += 1
        self.n_generated += n_tokens
        self._c_requests.inc(outcome="finished")
        self._c_tokens.inc(n_tokens)
        if n_tokens > 1:
            tpot = decode_s / (n_tokens - 1)
            self.tpot.add(tpot)
            self._h_tpot.observe(tpot)

    def record_backpressure(self) -> None:
        self.n_backpressure += 1
        self._c_backpressure.inc()

    def record_outcome(self, status) -> None:
        """A non-FINISHED terminal outcome (``RequestStatus`` or its value)."""
        s = getattr(status, "value", status)
        self._c_requests.inc(outcome=s)
        if s == "failed":
            self.n_failed += 1
        elif s == "cancelled":
            self.n_cancelled += 1
        elif s == "expired":
            self.n_expired += 1

    def render_prometheus(self) -> str:
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
            "prefill_s": self.prefill_seconds,
        }
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
        return out
