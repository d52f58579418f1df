"""Request queue for the serving engine (port of
``deeplearning4j_tpu/serving/scheduler.py``, trimmed to this slice: no
tenancy, grammar/sampling-surface fields or KV-wire request kinds).

Strict priority across classes (class 0 drains before class 1), FIFO within
a class, with optional prefix affinity (``prefix_affinity_tokens``): ``pop``
may promote the oldest queued request of the front class whose first k
prompt tokens match the prompt just admitted, so shared-prefix requests
land in one admission round. Admission control happens at ``submit``:

- ``Backpressure`` when the queue is at ``max_queue_depth`` (HTTP 429);
- ``AdmissionError`` when ``len(prompt) + max_new`` cannot fit a cache slot
  (queueing it would deadlock admission).

Thread-safe: HTTP handler threads ``submit`` while the engine thread
``pop``s.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from collections import deque

import numpy as np


class RequestStatus(str, enum.Enum):
    """Request lifecycle; terminal states set ``done`` and free the slot."""

    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"
    EXPIRED = "expired"


class Backpressure(RuntimeError):
    """Queue at max depth — shed load upstream (HTTP 429)."""


class AdmissionError(ValueError):
    """Request can never be served (token budget exceeds slot size)."""


_ids = itertools.count()


def _next_id() -> str:
    return f"req-{next(_ids)}"


@dataclasses.dataclass
class Request:
    """One generation request: a 1-D int ``prompt``, ``max_new`` tokens to
    generate, an optional ``eos_token`` that retires the slot early,
    ``priority`` (0 most urgent) and an optional ``deadline_s`` measured
    from scheduler arrival. ``cancel()`` may be called from any thread; the
    engine honors it within one horizon."""

    prompt: np.ndarray
    max_new: int
    priority: int = 1
    eos_token: int | None = None
    deadline_s: float | None = None
    id: str = dataclasses.field(default_factory=_next_id)
    arrival_time: float | None = None
    status: RequestStatus = RequestStatus.QUEUED
    error: str | None = None
    #: set by the HTTP front end, signaled when the request retires
    done: threading.Event | None = None
    #: engine-measured {"ttft_s", "decode_s"} of a finished request
    timing: dict | None = None
    _cancel_evt: threading.Event = dataclasses.field(
        default_factory=threading.Event, init=False, repr=False,
        compare=False,
    )

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new < 1:
            raise AdmissionError(f"max_new must be >= 1, got {self.max_new}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise AdmissionError(
                f"deadline_s must be >= 0, got {self.deadline_s}"
            )

    def cancel(self) -> None:
        """Request best-effort cancellation (thread-safe, idempotent)."""
        self._cancel_evt.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel_evt.is_set()

    def expired(self, now: float | None = None) -> bool:
        """Deadline elapsed? (``now`` in the perf_counter domain.)"""
        if self.deadline_s is None or self.arrival_time is None:
            return False
        if now is None:
            now = time.perf_counter()
        return (now - self.arrival_time) > self.deadline_s


class RequestScheduler:
    """Bounded multi-priority FIFO queue."""

    def __init__(self, max_queue_depth: int = 128,
                 max_total_tokens: int | None = None,
                 n_priorities: int = 3, prefix_affinity_tokens: int = 0):
        self.max_queue_depth = max_queue_depth
        self.max_total_tokens = max_total_tokens
        self.n_priorities = n_priorities
        self.prefix_affinity_tokens = int(prefix_affinity_tokens)
        self._lock = threading.Lock()
        self._queues = [deque() for _ in range(n_priorities)]  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues)

    def submit(self, req: Request) -> str:
        """Enqueue ``req``; returns its id. Raises ``Backpressure`` or
        ``AdmissionError`` (see the module docstring)."""
        total = len(req.prompt) + req.max_new
        if self.max_total_tokens is not None and total > self.max_total_tokens:
            raise AdmissionError(
                f"request {req.id}: prompt+max_new ({total}) exceeds the "
                f"per-slot token budget ({self.max_total_tokens})"
            )
        if not 0 <= req.priority < self.n_priorities:
            raise AdmissionError(
                f"priority {req.priority} outside [0, {self.n_priorities})"
            )
        with self._lock:
            if sum(len(q) for q in self._queues) >= self.max_queue_depth:
                raise Backpressure(
                    f"queue at max depth ({self.max_queue_depth})"
                )
            req.arrival_time = time.perf_counter()
            req.status = RequestStatus.QUEUED
            self._queues[req.priority].append(req)
        return req.id

    def requeue(self, req: Request) -> None:
        """Put a popped-but-not-admitted request back at the FRONT of its
        class (it must never be dropped between pop and admission)."""
        with self._lock:
            req.status = RequestStatus.QUEUED
            self._queues[req.priority].appendleft(req)

    def cancel(self, req_id: str) -> bool:
        """Flag a still-queued request as cancelled (discarded at its
        admission turn). False when the id is not queued."""
        with self._lock:
            for q in self._queues:
                for req in q:
                    if req.id == req_id:
                        req.cancel()
                        return True
        return False

    def cancel_all(self) -> int:
        """Flag every queued request as cancelled; returns how many."""
        n = 0
        with self._lock:
            for q in self._queues:
                for req in q:
                    if not req.cancelled:
                        req.cancel()
                        n += 1
        return n

    def _affinity_pop_unlocked(self, q, key, admissible):  # lint: holds _lock
        """The oldest admissible request of ``q`` whose first ``len(key)``
        prompt tokens are ``key``, removed from ``q``; or None."""
        k = len(key)
        best = None
        for i, req in enumerate(q):
            if (len(req.prompt) >= k
                    and tuple(int(t) for t in req.prompt[:k]) == key
                    and (admissible is None or admissible(req))
                    and (best is None
                         or req.arrival_time < q[best].arrival_time)):
                best = i
        if best is None:
            return None
        req = q[best]
        del q[best]
        return req

    def pop(self, affinity_hint: np.ndarray | None = None,
            admissible=None) -> Request | None:
        """Next request by strict priority, or None when idle. Within the
        front non-empty class: with ``prefix_affinity_tokens`` k > 0 and an
        ``affinity_hint`` (the prompt just admitted), the oldest request
        sharing the hint's first k tokens goes first; otherwise the head.
        With ``admissible`` (a predicate the engine passes, e.g. "its KV
        blocks fit"), a class whose head fails it yields nothing and the
        next class is tried: a blocked high-priority request must not idle
        the engine, and FIFO order within a class is kept."""
        k = self.prefix_affinity_tokens
        key = (tuple(int(t) for t in affinity_hint[:k])
               if k > 0 and affinity_hint is not None
               and len(affinity_hint) >= k else None)
        with self._lock:
            for q in self._queues:
                if not q:
                    continue
                if key is not None:
                    req = self._affinity_pop_unlocked(q, key, admissible)
                    if req is not None:
                        return req
                if admissible is None or admissible(q[0]):
                    return q.popleft()
        return None
