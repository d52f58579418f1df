"""Resilient RPC primitives for the fleet control plane (the port's own
copy of ``deeplearning4j_tpu/serving/rpc.py``, stdlib only).

Every HTTP leg between fleet processes (router → replica, controller →
replica, prefill replica → decode replica) used to be a single attempt
with a locally-invented timeout and a binary healthy flag. This module
is the shared replacement, pure stdlib, used by the router, the
controller and the disagg push path alike:

- :class:`Deadline` — a per-request time budget that rides the
  ``X-Deadline-Ms`` header. The edge (router/controller) mints one from
  its request timeout; every downstream leg derives its socket timeout
  from the REMAINING budget, and servers honor it by capping their
  engine waits — so a request's worst-case latency is bounded end to
  end instead of per-hop.
- :class:`CircuitBreaker` — per-replica closed/open/half-open state
  replacing the binary ``healthy`` flag. ``failure_threshold``
  consecutive failures open the breaker; after an exponentially
  backed-off reset interval it admits exactly ONE half-open probe
  (a real request, not a health poll — health polls cannot close an
  open breaker, only report). A probe success closes it and resets the
  backoff; a probe failure re-opens with doubled backoff, capped.
- :func:`run_hedged` — tail-latency hedging for IDEMPOTENT legs: fire
  a second attempt after a p99-derived delay (:class:`LatencyWindow`),
  first success wins, loser is abandoned. Hedging is only safe because
  receivers dedup on the idempotency key (below); the generate leg is
  NOT hedged — decoding twice would double-bill tokens.
- :class:`IdempotencyRegistry` — receiver-side LRU of
  ``X-Idempotency-Key`` values so a duplicate seat/ingest (a hedge
  loser landing late, or a retry racing its original) is detected and
  declined with 409 instead of seated twice.

Nothing here owns threads long-term: hedge threads are daemons that
die with their attempt, and breakers/deadlines are plain state guarded
by a lock. Time is injectable (``clock=``) so tests never sleep.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict

#: header carrying the remaining request budget, integer milliseconds.
DEADLINE_HEADER = "X-Deadline-Ms"

#: header carrying the request's idempotency key for dedupable legs.
IDEMPOTENCY_HEADER = "X-Idempotency-Key"

#: breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class Deadline:
    """A monotonic per-request time budget.

    Created once at the edge with the full budget; each downstream leg
    asks :meth:`timeout` for a socket timeout derived from what is
    LEFT, and forwards :meth:`header_value` so the next hop sees the
    shrunken budget. ``None`` budgets are not representable — mint with
    an explicit number of seconds; unbounded legs are the bug this
    class exists to remove.
    """

    __slots__ = ("_t0", "_budget_s", "_clock")

    def __init__(self, budget_s: float, *, clock=time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self._budget_s = max(0.0, float(budget_s))

    @classmethod
    def from_header(cls, value, *, default_s: float,
                    clock=time.monotonic) -> "Deadline":
        """Parse an ``X-Deadline-Ms`` header value; malformed, missing
        or non-positive values fall back to ``default_s`` (a garbled
        header must not grant an infinite or zero budget)."""
        try:
            ms = int(str(value).strip())
        except (TypeError, ValueError):
            return cls(default_s, clock=clock)
        if ms <= 0:
            return cls(default_s, clock=clock)
        return cls(ms / 1000.0, clock=clock)

    def remaining_s(self) -> float:
        """Seconds of budget left; clamped at 0."""
        return max(0.0, self._budget_s - (self._clock() - self._t0))

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def header_value(self) -> str:
        """Remaining budget as integer milliseconds for the header."""
        return str(max(1, int(self.remaining_s() * 1000)))

    def timeout(self, cap: float | None = None, *,
                floor: float = 0.05) -> float:
        """A socket timeout derived from the remaining budget:
        ``min(remaining, cap)`` but never below ``floor`` — a
        microscopic timeout would turn an almost-expired request into
        a connect-time exception instead of a clean deadline 504."""
        t = self.remaining_s()
        if cap is not None:
            t = min(t, float(cap))
        return max(float(floor), t)


class CircuitBreaker:
    """Closed/open/half-open breaker with exponential probe backoff.

    State machine (all transitions under the internal lock):

    - CLOSED: requests flow. ``failure_threshold`` CONSECUTIVE
      failures → OPEN (success resets the count).
    - OPEN: requests declined until ``reset_s`` (doubling per re-open,
      capped at ``max_reset_s``) has elapsed; then the next ``allow()``
      admits exactly one caller and moves to HALF_OPEN.
    - HALF_OPEN: every other caller is declined while the single probe
      is in flight. Probe success → CLOSED (backoff reset); probe
      failure → OPEN with doubled backoff.

    ``on_transition(old, new)`` fires outside hot state mutation but
    inside the lock — keep it cheap (a flight-recorder append / gauge
    set, which is what the fleet wires in).
    """

    __slots__ = ("failure_threshold", "max_reset_s", "_base_reset_s",
                 "_reset_s", "_state", "_failures", "_opened_at",
                 "_clock", "_on_transition", "_lock")

    def __init__(self, *, failure_threshold: int = 3, reset_s: float = 1.0,
                 max_reset_s: float = 30.0, clock=time.monotonic,
                 on_transition=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self._base_reset_s = float(reset_s)
        self.max_reset_s = float(max_reset_s)
        self._reset_s = float(reset_s)
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new: str) -> None:
        # caller holds self._lock
        old, self._state = self._state, new
        if old != new and self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self) -> bool:
        """May a request be sent to this replica right now? An OPEN
        breaker whose backoff has elapsed admits the caller as THE
        half-open probe (state moves to HALF_OPEN); report the probe's
        outcome via record_success/record_failure."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self._reset_s:
                    self._transition(HALF_OPEN)
                    return True
                return False
            return False  # HALF_OPEN: probe already in flight

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._reset_s = self._base_reset_s
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._reset_s = min(self._reset_s * 2.0, self.max_reset_s)
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and \
                    self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition(OPEN)

    def snapshot(self) -> dict:
        """Journalable state (controller checkpoint)."""
        with self._lock:
            return {
                "state": self._state,
                "failures": int(self._failures),
                "reset_s": float(self._reset_s),
            }

    def restore(self, snap: dict) -> None:
        """Rehydrate from :meth:`snapshot`. A journaled OPEN breaker
        restores as due-for-probe (opened_at backdated) — the standby
        must re-verify against live traffic, not trust a stale open."""
        with self._lock:
            state = str(snap.get("state", CLOSED))
            if state not in (CLOSED, OPEN, HALF_OPEN):
                state = CLOSED
            if state == HALF_OPEN:  # probe owner died with the primary
                state = OPEN
            self._failures = max(0, int(snap.get("failures", 0)))
            self._reset_s = min(
                self.max_reset_s,
                max(self._base_reset_s,
                    float(snap.get("reset_s", self._base_reset_s))),
            )
            self._opened_at = self._clock() - self._reset_s
            self._transition(state)


class LatencyWindow:
    """Bounded sample window feeding the hedge delay.

    ``quantile(0.99)`` over the last ``cap`` observed leg latencies is
    the hedge trigger: hedge only when the primary attempt is slower
    than almost everything recently seen, so steady-state hedge volume
    is ~1% of legs. Until ``min_samples`` observations exist the window
    reports ``default_s`` — hedging on an empty histogram would fire on
    every request during warmup.
    """

    __slots__ = ("cap", "min_samples", "default_s", "_xs", "_lock")

    def __init__(self, *, cap: int = 512, min_samples: int = 20,
                 default_s: float = 1.0):
        self.cap = int(cap)
        self.min_samples = int(min_samples)
        self.default_s = float(default_s)
        self._xs: list[float] = []
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._xs.append(float(seconds))
            if len(self._xs) > self.cap:
                del self._xs[: len(self._xs) - self.cap]

    def quantile(self, q: float = 0.99) -> float:
        with self._lock:
            if len(self._xs) < self.min_samples:
                return self.default_s
            xs = sorted(self._xs)
        i = min(len(xs) - 1, max(0, int(q * len(xs))))
        return xs[i]


def run_hedged(attempt, *, delay_s: float, deadline: Deadline | None = None,
               on_hedge=None):
    """Run ``attempt(leg)`` with a hedged second attempt.

    ``attempt`` is called with leg index 0 immediately; if it has not
    produced a result within ``delay_s`` (and the deadline still has
    at least that much budget left), leg 1 fires concurrently. First
    COMPLETION wins — success or failure — matching the semantics the
    transfer leg wants: the loser's socket is abandoned to its own
    timeout, and the receiver's idempotency registry declines the late
    duplicate. Returns ``(result, legs_fired, winner_leg)``; raises the
    winning attempt's exception if every fired leg failed.

    ``on_hedge()`` fires when leg 1 launches (metrics/flight hook).
    Only use for IDEMPOTENT legs — the function cannot tell.
    """
    results: "queue.Queue[tuple[int, bool, object]]" = queue.Queue()

    def _run(leg: int) -> None:
        try:
            results.put((leg, True, attempt(leg)))
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            results.put((leg, False, e))

    t0 = threading.Thread(target=_run, args=(0,), daemon=True)
    t0.start()
    fired = 1
    try:
        leg, ok, val = results.get(timeout=max(0.0, float(delay_s)))
    except queue.Empty:
        hedge_worthwhile = deadline is None or \
            deadline.remaining_s() > float(delay_s)
        if hedge_worthwhile:
            if on_hedge is not None:
                on_hedge()
            threading.Thread(target=_run, args=(1,), daemon=True).start()
            fired = 2
        wait = None if deadline is None else deadline.timeout(floor=0.001)
        leg, ok, val = results.get(timeout=wait)
    if ok:
        return val, fired, leg
    if fired == 1:
        raise val
    # first completion was a failure; give the other leg its chance
    wait = None if deadline is None else deadline.timeout(floor=0.001)
    try:
        leg2, ok2, val2 = results.get(timeout=wait)
    except queue.Empty:
        raise val from None
    if ok2:
        return val2, fired, leg2
    raise val2


class IdempotencyRegistry:
    """Receiver-side LRU of idempotency keys.

    ``first_seen(key)`` returns True exactly once per key (within the
    LRU horizon); handlers decline the duplicate with 409 — the hedge
    winner already seated the state, so "declined duplicate" IS the
    success signal for the loser. Bounded so a key flood cannot grow
    host memory; eviction of ancient keys is safe because hedges race
    within one request budget, not across days.
    """

    __slots__ = ("cap", "_keys", "_lock")

    def __init__(self, cap: int = 4096):
        self.cap = int(cap)
        self._keys: "OrderedDict[str, None]" = OrderedDict()
        self._lock = threading.Lock()

    def first_seen(self, key: str) -> bool:
        if not key:
            return True  # unkeyed requests are never deduped
        with self._lock:
            if key in self._keys:
                self._keys.move_to_end(key)
                return False
            self._keys[key] = None
            while len(self._keys) > self.cap:
                self._keys.popitem(last=False)
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)
