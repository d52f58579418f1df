"""Low-overhead span tracer with Chrome-trace/Perfetto export (the port's
own copy of ``deeplearning4j_tpu/obs/trace.py``; its export is the
reference's byte for byte for the same calls).

The span model is Dapper's, specialized to one process: a *track* is a
logical timeline (the engine loop, the scheduler queue, one KV slot),
and a *span* is a named interval on a track with key/value args (the
request id being the load-bearing one — it is what correlates a span
with the JSON logs and the metrics series). The serving engine records
the request lifecycle as spans across tracks::

    scheduler   |--queued req-3--|
    slot-0                       |prefill|--decode--|--decode--| ·finish
    engine           |== step ==||== step ==||== step ==|
                      |dispatch|  |sync|

Design constraints (this sits on the serving hot path):

- **disabled means free**: every record method starts with a single
  ``self.enabled`` attribute check and returns; no timestamps are
  taken, no tuples built. Engines run with a disabled tracer by
  default, and the overhead-guard test pins ``n_events == 0``.
- **bounded memory when enabled**: events land in a ``deque(maxlen=
  capacity)`` ring buffer — a long-running engine overwrites its
  oldest spans instead of growing; ``dropped`` counts the overwrites.
- **no clock calls inside the tracer**: callers pass ``ts``/``dur``
  from timestamps they already took for metrics (``time.perf_counter``
  domain, the same clock ``Request.arrival_time`` uses), so tracing a
  region costs exactly the two clock reads the region's metrics
  already paid.

Export is the ``trace_event`` JSON format (the Trace Event Format spec
both ``chrome://tracing`` and https://ui.perfetto.dev load): complete
events (``ph: "X"``) with microsecond ``ts``/``dur``, one ``tid`` per
track with ``thread_name``/``thread_sort_index`` metadata so the
engine loop sorts above the slot tracks.

Fleet tracing: span ``args`` may carry W3C-style ``trace_id`` /
``span_id`` / ``parent_span_id`` values (see :func:`new_trace_id`,
:func:`parse_traceparent`). The exporter additionally records a
wall-clock anchor (``origin_wall_time_s``) so per-process exports —
whose ``perf_counter`` origins are not comparable — can be rebased
onto one timeline by :mod:`deeplearning4j_tpu_torch.obs.collect` and viewed
as a single Perfetto document with cross-process flow arrows.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from collections import deque
from pathlib import Path

#: canonical track names the serving engine uses (slots are "slot-N")
ENGINE_TRACK = "engine"
SCHEDULER_TRACK = "scheduler"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def slot_track(slot: int) -> str:
    return f"slot-{slot}"


def new_trace_id() -> str:
    """Fresh 128-bit trace id (32 lowercase hex chars, W3C format)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """Fresh 64-bit span id (16 lowercase hex chars, W3C format)."""
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C ``traceparent`` header value (version 00, sampled)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """``(trace_id, parent_span_id)`` from a ``traceparent`` header,
    or ``None`` when the header is absent/malformed/all-zero (the spec
    says all-zero ids are invalid — treat as absent and start fresh)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


class Tracer:
    """Ring-buffered span recorder (see module docstring).

    ``span``/``instant``/``counter`` are thread-safe under the GIL
    (one ``deque.append`` each); ``chrome_trace``/``export`` snapshot
    the buffer, so they can run concurrently with recording.
    """

    def __init__(self, enabled: bool = True, capacity: int = 1 << 16,
                 process_name: str = "deeplearning4j_tpu_torch"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.process_name = str(process_name)
        self._events: deque = deque(maxlen=self.capacity)
        self._n_recorded = 0
        # export origin: spans use absolute perf_counter stamps; the
        # exporter rebases them so ts starts near zero. The wall-clock
        # anchor is taken at the same instant, giving cross-process
        # merges (obs.collect) a common base: exported relative ts=0
        # corresponds to wall time origin_wall_time_s.
        self._t0 = time.perf_counter()
        self._wall0 = time.time()

    # -- recording ---------------------------------------------------------

    def now(self) -> float:
        """Timestamp in the tracer's clock domain (perf_counter)."""
        return time.perf_counter()

    def span(self, track: str, name: str, ts: float, dur: float,
             **args) -> None:
        """Record a complete span: ``[ts, ts + dur)`` on ``track``."""
        if not self.enabled:
            return
        self._n_recorded += 1
        self._events.append((track, name, "X", ts, dur, args or None))

    def instant(self, track: str, name: str, ts: float | None = None,
                **args) -> None:
        """Record a point event (retirement, preemption, retry...)."""
        if not self.enabled:
            return
        self._n_recorded += 1
        self._events.append(
            (track, name, "i", ts if ts is not None else self.now(),
             0.0, args or None)
        )

    def counter(self, track: str, name: str, value: float,
                ts: float | None = None) -> None:
        """Record a counter sample (rendered as a filled series)."""
        if not self.enabled:
            return
        self._n_recorded += 1
        self._events.append(
            (track, name, "C", ts if ts is not None else self.now(),
             0.0, {name: float(value)})
        )

    @contextlib.contextmanager
    def region(self, track: str, name: str, **args):
        """Span as a context manager — for code that is not already
        timing itself (the training orchestrator). Costs nothing
        beyond the generator when disabled."""
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.span(track, name, t0, time.perf_counter() - t0, **args)

    # -- introspection -----------------------------------------------------

    @property
    def n_events(self) -> int:
        """Events currently buffered (<= capacity)."""
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events overwritten by the ring buffer."""
        return self._n_recorded - len(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._n_recorded = 0

    # -- export ------------------------------------------------------------

    def _track_order(self, tracks) -> list[str]:
        """Engine loop first, scheduler second, then slots/others in
        name order — the layout the trace viewer shows top-down."""
        head = [t for t in (ENGINE_TRACK, SCHEDULER_TRACK) if t in tracks]
        rest = sorted(t for t in tracks if t not in head)
        return head + rest

    def chrome_trace(self) -> dict:
        """The buffered events as a Trace Event Format dict (JSON-dump
        it, or hand it to ``export``)."""
        events = list(self._events)  # snapshot: recording may continue
        tids = {
            t: i for i, t in enumerate(
                self._track_order({e[0] for e in events})
            )
        }
        out = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": self.process_name}},
        ]
        for track, tid in tids.items():
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid, "args": {"name": track}})
            out.append({"name": "thread_sort_index", "ph": "M", "pid": 1,
                        "tid": tid, "args": {"sort_index": tid}})
        for track, name, ph, ts, dur, args in events:
            ev = {
                "name": name, "cat": track, "ph": ph, "pid": 1,
                "tid": tids[track],
                "ts": round((ts - self._t0) * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(max(0.0, dur) * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"  # instant scoped to its thread/track
            if args:
                ev["args"] = args
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            # wall time (time.time) at exported ts=0 — the merge anchor
            "origin_wall_time_s": self._wall0,
            "process_name": self.process_name,
        }

    def export(self, path: str | Path) -> Path:
        """Write the Chrome-trace JSON to ``path`` (open the file at
        https://ui.perfetto.dev or chrome://tracing)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)
        return path
