"""Deterministic fault injection for the serving engine (a copy of
``deeplearning4j_tpu/serving/faults.py``, which imports no JAX; the port
keeps its own so that it imports nothing of the JAX package).

The original DL4J runtime assumed workers die (Akka supervision trees,
ZooKeeper-backed state); the serving engine is this repo's equivalent
heavy-traffic surface, so it gets the equivalent treatment: a
``FaultInjector`` the engine consults at its host-side boundaries
("step" before each fused decode DISPATCH — with a multi-step horizon
that is one K-substep program, so check indices count horizons, not
tokens — and "prefill" once per admission, however many bucket/chunk
programs the prompt takes), raising one of three fault classes the
supervisor reacts to:

- :class:`TransientFault` — recoverable blip (think preempted RPC,
  donated-buffer retry). The engine retries the boundary with capped
  exponential backoff; if the fault persists past ``max_retries`` it is
  escalated (quarantine the implicated request if the fault names one,
  otherwise :class:`EngineCrash`).
- :class:`PermanentFault` — poisoned input; carries the implicated
  ``req_id``. The engine fails exactly that request (slot freed, status
  ``FAILED``, ``done`` set) and keeps serving everything else.
- :class:`EngineCrash` — the whole step loop is considered dead. The
  supervisor rebuilds engine state by deterministic replay
  (:meth:`ServingEngine.recover`).

Two injection modes, both deterministic:

- **scripted** — ``plan(site, at=k)`` fires at the k-th check of that
  site (0-based, ``times`` consecutive checks). Chaos tests use this to
  pin exact fault positions.
- **seeded rates** — per-check Bernoulli draws from one
  ``np.random.default_rng(seed)``; the engine's check sequence is
  deterministic, so a given seed replays the same fault pattern. The
  bench's faults row uses this to price recovery overhead.

``delay_s`` additionally injects latency (a plain sleep) at every
check — chaos for the clock rather than the control flow, used to make
timeout paths deterministic in tests.

Injection happens strictly on the host, before a program is launched, so
device state is never half-written by an injected fault — recovery
paths still treat it as corrupt (see ``recover``), which is the
stronger assumption real faults need.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

TRANSIENT = "transient"
PERMANENT = "permanent"
CRASH = "crash"
_KINDS = (TRANSIENT, PERMANENT, CRASH)


class TransientFault(RuntimeError):
    """Recoverable boundary fault — retry with backoff."""

    def __init__(self, msg: str, req_id: str | None = None):
        super().__init__(msg)
        self.req_id = req_id


class PermanentFault(RuntimeError):
    """Poisoned request — fail it, keep serving the rest."""

    def __init__(self, msg: str, req_id: str | None = None):
        super().__init__(msg)
        self.req_id = req_id


class EngineCrash(RuntimeError):
    """Engine loop considered dead; supervisor must rebuild by replay."""


@dataclasses.dataclass
class _Planned:
    site: str
    at: int
    kind: str
    req_id: str | None
    times: int


class FaultInjector:
    """Seeded/scripted fault source consulted at engine boundaries.

    ``check(site, req_id=...)`` either returns (no fault) or raises one
    of the fault classes above. Scripted plans are evaluated first, then
    the seeded per-check rates; ``max_faults`` caps the total number of
    rate-drawn faults (scripted ones always fire).
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        transient_rate: float = 0.0,
        permanent_rate: float = 0.0,
        crash_rate: float = 0.0,
        sites: tuple[str, ...] = ("step", "prefill"),
        max_faults: int | None = None,
        delay_s: float = 0.0,
    ):
        if transient_rate + permanent_rate + crash_rate > 1.0:
            raise ValueError("fault rates sum past 1.0")
        self.transient_rate = transient_rate
        self.permanent_rate = permanent_rate
        self.crash_rate = crash_rate
        self.sites = tuple(sites)
        self.max_faults = max_faults
        self.delay_s = delay_s
        self._rng = np.random.default_rng(seed)
        self._plans: list[_Planned] = []
        self._calls: dict[str, int] = {}
        self.n_raised = 0

    def plan(self, site: str, at: int, kind: str = TRANSIENT, *,
             req_id: str | None = None, times: int = 1) -> "FaultInjector":
        """Script a fault at the ``at``-th check of ``site`` (0-based),
        firing for ``times`` consecutive checks. Returns self (chain)."""
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        self._plans.append(_Planned(site, at, kind, req_id, times))
        return self

    def _raise(self, kind: str, site: str, n: int,
               req_id: str | None) -> None:
        self.n_raised += 1
        msg = f"injected {kind} fault at {site}#{n}"
        if kind == TRANSIENT:
            raise TransientFault(msg, req_id=req_id)
        if kind == PERMANENT:
            raise PermanentFault(msg, req_id=req_id)
        raise EngineCrash(msg)

    def check(self, site: str, req_id: str | None = None) -> None:
        """Called by the engine at a boundary; raises to inject."""
        n = self._calls.get(site, 0)
        self._calls[site] = n + 1
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        for p in self._plans:
            if p.site == site and p.at <= n < p.at + p.times:
                self._raise(p.kind, site, n, p.req_id or req_id)
        if site not in self.sites:
            return
        if self.max_faults is not None and self.n_raised >= self.max_faults:
            return
        r = float(self._rng.random())
        if r < self.transient_rate:
            self._raise(TRANSIENT, site, n, req_id)
        elif r < self.transient_rate + self.permanent_rate:
            self._raise(PERMANENT, site, n, req_id)
        elif r < self.transient_rate + self.permanent_rate + self.crash_rate:
            self._raise(CRASH, site, n, req_id)
