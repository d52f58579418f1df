"""Crash flight recorder: a bounded ring of recent engine events (the
port's own copy of ``deeplearning4j_tpu/obs/flight.py``).

Black-box style: the engine (and router) continuously record small
structured events — admissions, dispatches, faults, restarts,
scheduler depth, paged-block occupancy — into a ``deque(maxlen=
capacity)``. Recording follows the tracer's "disabled means free"
idiom (one ``self.enabled`` attribute check), and an *enabled*
recorder costs one clock read plus one ``deque.append`` per event, so
it ships enabled by default.

On ``EngineCrash``, a watchdog trip, SIGTERM, or ``GET /debug/dump``,
:meth:`FlightRecorder.dump` assembles a JSON postmortem bundle: the
event ring, a metrics snapshot, and the tail of the trace buffer.
The bundle is what you attach to an incident — so it must be safe to
attach: :func:`redact` recursively strips prompt text and token ids
(any field named ``prompt``/``text``/``tokens``/...) at dump time,
keeping lengths where they are cheap to compute. Recording keeps the
raw fields (the ring is process-private memory); only dumps redact.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path

#: field names whose values never leave the process in a dump
REDACT_KEYS = frozenset({
    "prompt", "text", "tokens", "prompt_tokens", "completion",
    "output", "toks", "body",
})

_REDACTED = "[redacted]"


def redact(obj):
    """Recursively replace values of sensitive keys (:data:`REDACT_KEYS`)
    with a placeholder — sized placeholders for strings/lists so the
    postmortem keeps shape information without content."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if str(k).lower() in REDACT_KEYS:
                if isinstance(v, (str, bytes, list, tuple)):
                    out[k] = f"{_REDACTED} len={len(v)}"
                else:
                    out[k] = _REDACTED
            else:
                out[k] = redact(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [redact(v) for v in obj]
    return obj


class FlightRecorder:
    """Bounded event ring with postmortem bundle dumps.

    ``record`` is thread-safe under the GIL (one ``deque.append``);
    ``dump`` snapshots, so it can run concurrently with recording
    (the ``/debug/dump`` handler thread vs. the engine thread).
    """

    def __init__(self, enabled: bool = True, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._n_recorded = 0

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        self._n_recorded += 1
        self._events.append(
            (time.time(), time.monotonic(), kind, fields or None)
        )

    @property
    def n_events(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        return self._n_recorded - len(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._n_recorded = 0

    # -- postmortem --------------------------------------------------------

    def dump(self, reason: str, *, metrics=None, tracer=None,
             extra: dict | None = None, trace_tail: int = 256) -> dict:
        """Assemble the redacted postmortem bundle as a dict.

        ``metrics`` is anything with a ``summary()`` method
        (``ServingMetrics``); ``tracer`` a :class:`~.trace.Tracer`
        whose last ``trace_tail`` buffered events are included.
        """
        events = [
            {"t_wall": tw, "t_mono": tm, "kind": kind,
             **(redact(fields) if fields else {})}
            for tw, tm, kind, fields in list(self._events)
        ]
        bundle = {
            "reason": reason,
            "t_wall": time.time(),
            "pid": os.getpid(),
            "n_events": len(events),
            "n_dropped": self.dropped,
            "events": events,
        }
        if extra:
            bundle.update(redact(dict(extra)))
        if metrics is not None:
            try:
                bundle["metrics"] = redact(metrics.summary())
            except Exception as e:  # postmortem must not throw
                bundle["metrics_error"] = repr(e)
        if tracer is not None:
            tail = list(tracer._events)[-trace_tail:]
            bundle["trace_tail"] = [
                {"track": track, "name": name, "ph": ph, "ts": ts,
                 "dur": dur, **({"args": redact(args)} if args else {})}
                for track, name, ph, ts, dur, args in tail
            ]
        return bundle

    def dump_to(self, path: str | Path, reason: str, **kw) -> Path:
        """Write the bundle as JSON to ``path`` (parents created)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        bundle = self.dump(reason, **kw)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, default=repr)
        return path
