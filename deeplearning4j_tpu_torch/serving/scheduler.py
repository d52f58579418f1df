"""Request queue for the serving engine (port of
``deeplearning4j_tpu/serving/scheduler.py``, trimmed to this slice: no
tenancy, streaming or KV-wire request kinds).

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

from deeplearning4j_tpu_torch.serving.grammar import (
    MAX_LOGIT_BIAS,
    MAX_STOP_LEN,
    MAX_STOP_SEQUENCES,
    MAX_TOP_LOGPROBS,
    GrammarError,
    parse_response_format,
)


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
    engine honors it within one horizon.

    Sampling-surface fields (engines built with ``sampling_surface=True``;
    see :mod:`.grammar`): ``temperature`` / ``top_k`` / ``top_p`` override
    the engine-wide sampler (None = the engine's); ``stop`` is a list of
    token-id sequences matched on the host at readback (the match is
    stripped from the stream); ``logit_bias`` maps token id -> additive
    logit; ``logprobs`` asks for per-token logprobs and ``top_logprobs``
    for the top alternatives a position; ``response_format`` constrains the
    output to a regex or a JSON schema (a token-level DFA mask)."""

    prompt: np.ndarray
    max_new: int
    priority: int = 1
    eos_token: int | None = None
    deadline_s: float | None = None
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    stop: list | None = None
    logit_bias: dict | None = None
    logprobs: bool = False
    top_logprobs: int = 0
    response_format: dict | str | None = None
    #: resolved by the engine at submit: the compiled grammar
    _grammar: object = dataclasses.field(default=None, repr=False,
                                         compare=False)
    #: set by the engine at retirement: per-token logprob records
    logprobs_out: list | None = dataclasses.field(default=None, repr=False,
                                                  compare=False)
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
        if self.temperature is not None and self.temperature < 0:
            raise AdmissionError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise AdmissionError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise AdmissionError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.stop is not None:
            self.stop = [[int(t) for t in np.asarray(s).reshape(-1)]
                         for s in self.stop]
            if len(self.stop) > MAX_STOP_SEQUENCES:
                raise AdmissionError(
                    f"at most {MAX_STOP_SEQUENCES} stop sequences, got "
                    f"{len(self.stop)}")
            for s in self.stop:
                if not 1 <= len(s) <= MAX_STOP_LEN:
                    raise AdmissionError(
                        f"stop sequences must be 1..{MAX_STOP_LEN} tokens, "
                        f"got {len(s)}")
        if self.logit_bias is not None:
            try:
                self.logit_bias = {int(k): float(v)
                                   for k, v in self.logit_bias.items()}
            except (TypeError, ValueError, AttributeError):
                raise AdmissionError(
                    "logit_bias must map token ids to numbers") from None
            if len(self.logit_bias) > MAX_LOGIT_BIAS:
                raise AdmissionError(
                    f"at most {MAX_LOGIT_BIAS} logit_bias entries, got "
                    f"{len(self.logit_bias)}")
            if any(k < 0 for k in self.logit_bias):
                raise AdmissionError("logit_bias token ids must be >= 0")
        if not 0 <= int(self.top_logprobs) <= MAX_TOP_LOGPROBS:
            raise AdmissionError(
                f"top_logprobs must be 0..{MAX_TOP_LOGPROBS}, got "
                f"{self.top_logprobs}")
        self.top_logprobs = int(self.top_logprobs)
        if self.top_logprobs:
            self.logprobs = True
        if self.response_format is not None:
            try:
                parse_response_format(self.response_format)
            except GrammarError as e:
                raise AdmissionError(f"bad response_format: {e}") from None

    @property
    def uses_sampling_surface(self) -> bool:
        """Any sampling-surface field set? Such requests decode through the
        engine's masked step (an engine without ``sampling_surface=True``
        rejects them at submit)."""
        return (self.temperature is not None or self.top_k is not None
                or self.top_p is not None or bool(self.stop)
                or bool(self.logit_bias) or self.logprobs
                or self.response_format is not None)

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
