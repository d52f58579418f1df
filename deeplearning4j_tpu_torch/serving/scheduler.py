"""Request queue for the serving engine (port of
``deeplearning4j_tpu/serving/scheduler.py``, without the KV-wire request
kinds). Generation requests and embedding lookups
(:class:`EmbeddingRequest`) share it.

Strict priority across classes (class 0 drains before class 1) and, when
a :class:`~.tenancy.TenantRegistry` is attached, DEFICIT ROUND-ROBIN
across tenants within each class, weighted by tenant weight: each tenant
banks ``drr_quantum * weight`` tokens of service credit per visit of the
rotation and its head request is served once the credit covers the
request's token cost (prompt + max_new), so one flooding tenant cannot
starve its classmates. Without a registry every request lands in one
implicit tenant and the order is FIFO within a class. With
``prefix_affinity_tokens`` k > 0, ``pop`` may promote the oldest queued
request of the front class whose first k prompt tokens match the prompt
just admitted (charged to its tenant's deficit), so shared-prefix
requests land in one admission round. Admission control happens at
``submit``:

- ``Backpressure`` when the queue is at ``max_queue_depth`` (HTTP 429);
- ``QuotaExceeded`` (a ``Backpressure``) when the tenant's token-rate
  bucket is dry (HTTP 429, labelled per tenant);
- ``AdmissionError`` when ``len(prompt) + max_new`` cannot fit a cache slot
  (queueing it would deadlock admission).

Thread-safe: HTTP handler threads ``submit`` while the engine thread
``pop``s.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
import queue as queue_mod
import threading
import time
from collections import deque

import numpy as np

from deeplearning4j_tpu_torch.analysis.sanitizers import (
    note_access,
    wrap_lock,
)
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

    ``tenant_id`` keys the scheduler's weighted-fair tier and the
    per-tenant metrics ("" = untenanted); ``adapter`` selects the LoRA
    bank row the slot decodes with (0 = the base model). ``stream`` (a
    ``queue.Queue``) receives each generated token as it reaches the host,
    then ``None`` as the end-of-stream sentinel, after the terminal
    status is set (the SSE front end drains it).

    Sampling-surface fields (engines built with ``sampling_surface=True``;
    see :mod:`.grammar`): ``temperature`` / ``top_k`` / ``top_p`` override
    the engine-wide sampler (None = the engine's); ``stop`` is a list of
    token-id sequences matched on the host at readback (the match is
    stripped from the stream); ``logit_bias`` maps token id -> additive
    logit; ``logprobs`` asks for per-token logprobs and ``top_logprobs``
    for the top alternatives a position; ``response_format`` constrains the
    output to a regex or a JSON schema (a token-level DFA mask).

    ``trace_id`` / ``parent_span_id`` carry the W3C trace context the HTTP
    front end resolves (see :mod:`...obs.trace`): the engine's admission
    span and the JSON log lines name them."""

    prompt: np.ndarray
    max_new: int
    priority: int = 1
    eos_token: int | None = None
    deadline_s: float | None = None
    tenant_id: str = ""
    adapter: int = 0
    stream: queue_mod.Queue | None = None
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
    trace_id: str = ""
    parent_span_id: str = ""
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

    kind = "generate"

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new < 1:
            raise AdmissionError(f"max_new must be >= 1, got {self.max_new}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise AdmissionError(
                f"deadline_s must be >= 0, got {self.deadline_s}"
            )
        if self.adapter < 0:
            raise AdmissionError(f"adapter must be >= 0, got {self.adapter}")
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

    def token_cost(self) -> int:
        """Service cost in tokens, the unit the DRR tier and the tenant
        token buckets meter (the per-slot budget's prompt + max_new)."""
        return len(self.prompt) + self.max_new

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


def _empty_prompt() -> np.ndarray:
    return np.zeros(0, np.int32)


@dataclasses.dataclass
class EmbeddingRequest(Request):
    """An embeddings lookup riding the same queue as generation. The
    engine serves it at the admission boundary from a host-side embedding
    model (no KV slot, no device dispatch), but it goes through the
    scheduler (priority, DRR, quota, backpressure), the per-tenant metrics
    and drain as a generation request does. ``result`` is filled with
    ``{word: vector or None}`` before ``done`` is set."""

    prompt: np.ndarray = dataclasses.field(default_factory=_empty_prompt)
    max_new: int = 1
    model: str = "word2vec"
    words: tuple[str, ...] = ()
    result: dict | None = None

    kind = "embedding"

    def __post_init__(self):
        super().__post_init__()
        self.words = tuple(str(w) for w in self.words)
        if not self.words:
            raise AdmissionError("embedding request needs >= 1 word")

    def token_cost(self) -> int:
        return len(self.words)


@dataclasses.dataclass
class KVExportRequest(Request):
    """Disaggregated-prefill work item (the reference's): prefill
    ``prompt`` into a slot held for the export, copy the KV segment and the
    pending logits row to the host and release the slot, with no decode.
    It rides the generation queue (priority, DRR, quota, backpressure) and
    needs a free slot as generation does. ``result`` holds the wire-ready
    segment (see :mod:`.disagg`) before ``done`` is set. Adapter 0 only:
    a frame carries no adapter, and an ingest lands its rows where every
    adapter-0 prompt can hit them."""

    max_new: int = 1  # the slot budget held during the export, never decoded
    result: dict | None = None

    kind = "kv_export"

    def __post_init__(self):
        super().__post_init__()
        if len(self.prompt) == 0:
            raise AdmissionError("kv_export needs a non-empty prompt")
        if self.adapter != 0:
            # the frame names no adapter, and the decode replica seats it
            # in a prefix cache that adapter-0 prompts read
            raise AdmissionError(
                f"kv_export serves adapter 0 only (got adapter "
                f"{self.adapter}): KV computed under an adapter never "
                "enters a prefix cache")


@dataclasses.dataclass
class KVIngestRequest(Request):
    """A wire-delivered KV segment awaiting a seat in the prefix cache
    (the reference's). Slotless: the engine thread serves it at the
    admission boundary, as an embedding lookup. ``segment`` is a
    :func:`~.disagg.decode_segment` dict; ``result`` reports ``{"stored":
    bool, "reason", "n_tokens"}`` before ``done`` is set. A decline is
    soft: the sender falls back to local prefill."""

    prompt: np.ndarray = dataclasses.field(default_factory=_empty_prompt)
    max_new: int = 1
    segment: dict | None = None
    result: dict | None = None

    kind = "kv_ingest"

    def __post_init__(self):
        super().__post_init__()
        if self.segment is None:
            raise AdmissionError("kv_ingest needs a decoded segment")

    def token_cost(self) -> int:
        return len(self.segment.get("tokens", ()))


@dataclasses.dataclass
class KVSessionRequest(Request):
    """A live generation session migrating in from another replica (the
    reference's): ``segment`` covers prompt + tokens so far,
    ``gen_tokens`` are the tokens already emitted (seated, never
    generated again), ``key_data`` the source slot's two sampling-key
    words (seated verbatim, so ``fold_in(key, position)`` continues the
    source's stream). ``prompt`` is the original prompt and ``max_new``
    the original budget. It needs a slot; a decline is soft
    (``result["seated"] is False``)."""

    segment: dict | None = None
    gen_tokens: tuple[int, ...] = ()
    key_data: np.ndarray | None = None
    result: dict | None = None

    kind = "kv_session"

    def __post_init__(self):
        super().__post_init__()
        if self.segment is None:
            raise AdmissionError("kv_session needs a decoded segment")
        self.gen_tokens = tuple(int(t) for t in self.gen_tokens)
        if len(self.prompt) == 0:
            raise AdmissionError("kv_session needs a non-empty prompt")
        if self.max_new - len(self.gen_tokens) < 1:
            raise AdmissionError("kv_session has no remaining budget")


class RequestScheduler:
    """Bounded multi-priority queue: strict priority across classes,
    weighted deficit round-robin across tenants within a class, FIFO
    within a tenant."""

    def __init__(self, max_queue_depth: int = 128,
                 max_total_tokens: int | None = None,
                 n_priorities: int = 3, prefix_affinity_tokens: int = 0,
                 tenancy=None, drr_quantum: int = 64):
        self.max_queue_depth = max_queue_depth
        self.max_total_tokens = max_total_tokens
        self.n_priorities = n_priorities
        self.prefix_affinity_tokens = int(prefix_affinity_tokens)
        self.tenancy = tenancy
        if drr_quantum < 1:
            raise ValueError(f"drr_quantum must be >= 1, got {drr_quantum}")
        self.drr_quantum = drr_quantum
        self._lock = wrap_lock(threading.Lock(), "scheduler._lock")
        # per class: tenant_id -> deque (FIFO within a tenant)
        self._queues = [{} for _ in range(n_priorities)]  # guarded-by: _lock
        # per class, the DRR rotation: tenant order, the current index,
        # banked deficits, whether the tenant at idx is owed its visit
        # quantum ("fresh"), and "carry", deficit adjustments banked while
        # a tenant is out of the rotation (applied when it enqueues
        # again). Deficits reset when a tenant's queue empties.
        self._drr = [
            {"order": [], "idx": 0, "deficit": {}, "fresh": True,
             "carry": {}}
            for _ in range(n_priorities)
        ]  # guarded-by: _lock

    def _weight(self, tenant_id: str) -> float:
        if self.tenancy is not None:
            t = self.tenancy.get(tenant_id)
            if t is not None:
                return t.weight
        return 1.0

    def _depth_unlocked(self) -> int:  # lint: holds _lock
        return sum(len(q) for per_class in self._queues
                   for q in per_class.values())

    def __len__(self) -> int:
        with self._lock:
            return self._depth_unlocked()

    @property
    def depth(self) -> int:
        """Queued requests (``len(self)``, the reference's property)."""
        return len(self)

    def has_kind(self, kind: str) -> bool:
        """Any queued request of ``kind``? The engine's admission entry
        check: embedding requests stay admissible with no free KV slot, so
        a full pool must not skip admission while slotless work waits."""
        with self._lock:
            return any(req.kind == kind for req in self._queued_unlocked())

    # lint: holds _lock
    def _enqueue_unlocked(self, req: Request, front: bool) -> None:
        per_class = self._queues[req.priority]
        drr = self._drr[req.priority]
        tid = req.tenant_id
        q = per_class.get(tid)
        if q is None:
            q = per_class[tid] = deque()
            if tid not in drr["deficit"]:
                drr["deficit"][tid] = drr["carry"].pop(tid, 0.0)
            if not drr["order"]:
                drr["fresh"] = True  # the class was idle: a new rotation
            if front:
                # the requeue of a tenant's only request: it re-enters
                # the rotation at the current position, so it is next
                drr["order"].insert(drr["idx"], tid)
            else:
                drr["order"].append(tid)
        if front:
            q.appendleft(req)
        else:
            q.append(req)

    # lint: holds _lock
    def _remove_tenant_if_empty(self, ci: int, tid: str) -> None:
        per_class = self._queues[ci]
        if per_class.get(tid):
            return
        per_class.pop(tid, None)
        drr = self._drr[ci]
        if tid in drr["order"]:
            pos = drr["order"].index(tid)
            was_current = pos == drr["idx"]
            drr["order"].remove(tid)
            if pos < drr["idx"]:
                drr["idx"] -= 1
            if drr["idx"] >= len(drr["order"]):
                drr["idx"] = 0  # wrap: the rotation restarts at the front
            if was_current:
                # whoever now sits at idx is owed its visit quantum
                drr["fresh"] = True
        drr["deficit"].pop(tid, None)

    def submit(self, req: Request) -> str:
        """Enqueue ``req``; returns its id. Raises ``Backpressure``,
        ``QuotaExceeded`` or ``AdmissionError`` (see the module doc)."""
        total = len(req.prompt) + req.max_new
        if (req.kind == "generate" and self.max_total_tokens is not None
                and total > self.max_total_tokens):
            raise AdmissionError(
                f"request {req.id}: prompt+max_new ({total}) exceeds the "
                f"per-slot token budget ({self.max_total_tokens})"
            )
        if not 0 <= req.priority < self.n_priorities:
            raise AdmissionError(
                f"priority {req.priority} outside [0, {self.n_priorities})"
            )
        with self._lock:
            note_access("scheduler.queues", write=True)
            if self._depth_unlocked() >= self.max_queue_depth:
                raise Backpressure(
                    f"queue at max depth ({self.max_queue_depth})"
                )
            if self.tenancy is not None:
                # after the depth check (a shed request burns no quota)
                # and inside the lock (depth and charge are one decision)
                self.tenancy.charge(req.tenant_id, req.token_cost())
            req.arrival_time = time.perf_counter()
            req.status = RequestStatus.QUEUED
            self._enqueue_unlocked(req, front=False)
        return req.id

    def requeue(self, req: Request) -> None:
        """Put a popped-but-not-admitted request back at the FRONT of its
        tenant's queue (it must never be dropped between pop and
        admission), refunding the cost its pop charged."""
        with self._lock:
            note_access("scheduler.queues", write=True)
            req.status = RequestStatus.QUEUED
            self._enqueue_unlocked(req, front=True)
            drr = self._drr[req.priority]
            drr["deficit"][req.tenant_id] = (
                drr["deficit"].get(req.tenant_id, 0.0) + req.token_cost())

    def adjust_deficit(self, req: Request, delta: float) -> None:
        """Bank ``delta`` service credit for ``req``'s tenant in its class
        (positive a refund, negative a charge); into the carry bank while
        the tenant is out of the rotation."""
        with self._lock:
            note_access("scheduler.queues", write=True)
            drr = self._drr[req.priority]
            tid = req.tenant_id
            if tid in drr["deficit"]:
                drr["deficit"][tid] += delta
            else:
                drr["carry"][tid] = drr["carry"].get(tid, 0.0) + delta

    def _queued_unlocked(self):  # lint: holds _lock
        return (req for per_class in self._queues
                for q in per_class.values() for req in q)

    def cancel(self, req_id: str) -> bool:
        """Flag a still-queued request as cancelled (discarded at its
        admission turn). False when the id is not queued."""
        with self._lock:
            for req in self._queued_unlocked():
                if req.id == req_id:
                    req.cancel()
                    return True
        return False

    def cancel_all(self) -> int:
        """Flag every queued request as cancelled; returns how many."""
        n = 0
        with self._lock:
            for req in self._queued_unlocked():
                if not req.cancelled:
                    req.cancel()
                    n += 1
        return n

    def _affinity_pop_unlocked(self, ci, key, admissible):  # lint: holds _lock
        """The oldest admissible request of class ``ci`` whose first
        ``len(key)`` prompt tokens are ``key``, across all tenants,
        removed and charged to its tenant's deficit; or None."""
        k = len(key)
        best = None
        for tid, q in self._queues[ci].items():
            for i, req in enumerate(q):
                if (len(req.prompt) >= k
                        and tuple(int(t) for t in req.prompt[:k]) == key
                        and (admissible is None or admissible(req))
                        and (best is None
                             or req.arrival_time < best[0].arrival_time)):
                    best = (req, tid, i)
        if best is None:
            return None
        req, tid, i = best
        del self._queues[ci][tid][i]
        drr = self._drr[ci]
        drr["deficit"][tid] = drr["deficit"].get(tid, 0.0) - req.token_cost()
        self._remove_tenant_if_empty(ci, tid)
        return req

    def _serve_head_unlocked(self, ci, tid):  # lint: holds _lock
        req = self._queues[ci][tid].popleft()
        self._drr[ci]["deficit"][tid] -= req.token_cost()
        self._remove_tenant_if_empty(ci, tid)
        return req

    def _drr_pop_unlocked(self, ci, admissible):  # lint: holds _lock
        """Deficit-round-robin pop from class ``ci``: a visit banks
        ``quantum * weight``; a tenant's head is served once its credit
        covers the head's cost, and the serving tenant stays current
        while the credit lasts. Tenants whose head fails ``admissible``
        are passed over, keeping their credit. When a whole rotation of
        quanta serves nobody, the rounds the closest tenant still needs
        are banked for everyone at once (the weight ratios kept), so the
        next rotation serves."""
        per_class = self._queues[ci]
        drr = self._drr[ci]
        order = drr["order"]
        if not order:
            return None
        for _rotation in range(2):
            any_admissible = False
            # n + 1 visits: the current tenant's first visit may already
            # have had its quantum
            for _ in range(len(order) + 1):
                tid = order[drr["idx"]]
                if drr["fresh"]:
                    drr["deficit"][tid] = (
                        drr["deficit"].get(tid, 0.0)
                        + self.drr_quantum * self._weight(tid))
                    drr["fresh"] = False
                req = per_class[tid][0]
                if admissible is None or admissible(req):
                    any_admissible = True
                    if drr["deficit"][tid] >= req.token_cost():
                        return self._serve_head_unlocked(ci, tid)
                drr["idx"] = (drr["idx"] + 1) % len(order)
                drr["fresh"] = True
            if not any_admissible:
                return None
            boost = None
            for tid in order:
                req = per_class[tid][0]
                if admissible is not None and not admissible(req):
                    continue
                need = req.token_cost() - drr["deficit"].get(tid, 0.0)
                inc = self.drr_quantum * self._weight(tid)
                rounds = max(0, math.ceil(need / inc) - 1)
                if boost is None or rounds < boost:
                    boost = rounds
            if boost:
                for tid in order:
                    drr["deficit"][tid] = (
                        drr["deficit"].get(tid, 0.0)
                        + boost * self.drr_quantum * self._weight(tid))
        return None  # unreachable: the second rotation serves

    def pop(self, affinity_hint: np.ndarray | None = None,
            admissible=None) -> Request | None:
        """Next request by strict priority, or None when idle. Within the
        front non-empty class: with ``prefix_affinity_tokens`` k > 0 and an
        ``affinity_hint`` (the prompt just admitted), the oldest request
        sharing the hint's first k tokens goes first; otherwise the DRR
        rotation picks. With ``admissible`` (a predicate the engine passes:
        "its KV blocks fit", "its tenant is under its slot cap"), a class
        where no request passes yields nothing and the next class is
        tried: a blocked high-priority request must not idle the
        engine."""
        k = self.prefix_affinity_tokens
        key = (tuple(int(t) for t in affinity_hint[:k])
               if k > 0 and affinity_hint is not None
               and len(affinity_hint) >= k else None)
        with self._lock:
            note_access("scheduler.queues", write=True)
            for ci in range(self.n_priorities):
                if not any(self._queues[ci].values()):
                    continue
                if key is not None:
                    req = self._affinity_pop_unlocked(ci, key, admissible)
                    if req is not None:
                        return req
                req = self._drr_pop_unlocked(ci, admissible)
                if req is not None:
                    return req
        return None
