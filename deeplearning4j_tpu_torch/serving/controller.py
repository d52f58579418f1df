"""Fleet controller: disaggregated prefill/decode orchestration over
N serving replicas (the port's own copy of
``deeplearning4j_tpu/serving/controller.py``: no ``torch``, no model, no
device; plain locks stand for the reference's sanitizer-wrapped ones).

The :class:`~deeplearning4j_tpu_torch.serving.router.ReplicaRouter` scales
throughput across interchangeable replicas; this controller adds the
one thing the router deliberately lacks — *roles*. In a disaggregated
fleet (DistServe/Mooncake) some replicas are PREFILL workers (compute
prompt KV, ship it) and some are DECODE workers (seat shipped KV, run
the token loop), so a long-prompt prefill burst stops stealing decode
TPOT at the replica level instead of the batch level.

Routing policy for ``POST /v1/generate`` (in priority order):

1. **Session stickiness.** A request carrying ``"session": <id>``
   lands on the decode replica that served that session last — its
   prefix cache almost certainly still holds the conversation's KV
   run. A dead/draining sticky target falls through to:
2. **Shadow-trie affinity.** Same host-side trie the router keeps: the
   decode-capable replica with the longest shared prompt prefix wins
   when the match reaches ``affinity_min_match`` tokens.
3. **Least loaded** decode-capable replica, round-robin on ties.

Independently of *which* decode replica wins, adapter-0 prompts of
``disagg_threshold`` tokens or more, and at least the decode replica's
hit grain (its ``/healthz`` ``hit_grain``: a shorter segment is
declined there), take the TRANSFER path when a dedicated prefill
replica is available: the controller POSTs
``/v1/prefill`` (with ``push_to`` naming the decode target) to the
prefill replica, which computes the KV rows, frames them
(:mod:`.disagg`), and pushes the segment straight to the decode
replica's ``/v1/kv_segment`` — replica-to-replica, the bytes never
transit the controller. The follow-up generate forwarded to the decode
replica then full-hits its prefix cache and goes straight to decoding.
ANY failure along that leg (prefill down, push rejected, segment
declined) just falls back to forwarding the generate as-is — the
decode replica prefills locally, byte-identical, only slower.

Role REBALANCING is hysteretic and observable: the health poller
samples every replica's queue depth (``/healthz``) and worst per-tenant
SLO burn (``/metrics.json``, the per-tenant ``slo_burn`` gauges), and a pure
:class:`RoleBalancer` flips one replica's role only after the pressure
imbalance persists for ``rebalance_windows`` consecutive samples AND
``rebalance_dwell_s`` has passed since the last flip — so a single
bursty window never thrashes the fleet. Pools never drain to zero.

Rolling restarts ride ``POST /fleet/drain`` / ``/fleet/undrain``
(body ``{"replica": "host:port"}``): the controller relays the
replica's own ``/drain`` endpoint and stops dispatching to it
immediately; in-flight work finishes because the replica keeps
stepping. ``/undrain`` restores it to the rotation. With ``{"migrate":
true}`` the drain additionally relays the replica's ``/migrate`` so
live sessions finish on a healthy decode replica (byte-identical —
see ``ServingEngine.export_sessions``) instead of riding out the
drain.

Resilience: every outbound leg honors the caller's
``X-Deadline-Ms`` budget (shrunken and re-forwarded per hop, socket
timeouts derived from it); per-replica CIRCUIT BREAKERS
(closed/open/half-open with exponential probe backoff,
:class:`~deeplearning4j_tpu_torch.serving.rpc.CircuitBreaker`) gate dispatch
— a health-poll success alone never closes an open breaker, only a
successful probe request does; the idempotent transfer leg is HEDGED
after the observed p99 transfer latency (the decode replica dedups on
the shared idempotency key; the generate leg is never hedged). The
controller checkpoints roles / sticky sessions / breaker state to a
JOURNAL (atomic rename), and a warm standby (``standby_of=``)
promotes from that journal after ``failover_after`` missed primary
probes, re-verifying against live fleet state.

The controller is the fleet's trace root: every outbound leg (prefill
dispatch, decode dispatch) is a real span carrying a fresh span id
downstream via ``traceparent``, so the merged Perfetto view chains
controller dispatch -> prefill -> transfer -> decode ingest -> decode
generate under one trace id.

Endpoints: ``POST /v1/generate`` (routed passthrough + X-Served-By),
``POST /fleet/drain`` / ``POST /fleet/undrain`` / ``POST /fleet/role``
(manual role override), ``GET /healthz``, ``GET /fleet`` (roles +
per-replica state), ``GET /metrics``, ``GET /debug/dump``.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import signal
import threading
import time
from collections import OrderedDict
from http.server import ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

from deeplearning4j_tpu_torch.analysis.sanitizers import (
    note_access,
    wrap_lock,
)
from deeplearning4j_tpu_torch.obs.flight import FlightRecorder
from deeplearning4j_tpu_torch.obs.logs import log_event
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry
from deeplearning4j_tpu_torch.obs.trace import (
    Tracer,
    format_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
)
from deeplearning4j_tpu_torch.serving.router import PrefixShadow, _ReplicaDown
from deeplearning4j_tpu_torch.serving.rpc import (
    CLOSED,
    DEADLINE_HEADER,
    HALF_OPEN,
    CircuitBreaker,
    Deadline,
    LatencyWindow,
    run_hedged,
)
from deeplearning4j_tpu_torch.utils.httpjson import (
    QuietHandler,
    read_json_body,
    send_body,
    send_json,
)

_log = logging.getLogger(__name__)

#: Prometheus text exposition format version served at /metrics
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the controller's single trace track
CONTROLLER_TRACK = "controller"

#: replica roles the controller understands. "monolithic" serves both
#: phases itself and stays out of the rebalancer's pools.
ROLES = ("prefill", "decode", "monolithic")


class RoleBalancer:
    """Pure, hysteretic role-rebalance policy (no I/O, no clocks of
    its own — fully unit-testable).

    ``observe(now, samples)`` takes one fleet sample — ``{name:
    {"role", "queue_depth", "slo_burn"}}`` — and returns the role
    moves ``[(replica_name, new_role)]`` to apply (at most one per
    call). A move requires the SAME imbalance direction for
    ``windows`` consecutive samples, at least ``dwell_s`` since the
    previous move, and a donor pool of >= 2 (a role is never emptied).

    Pressure model: prefill pressure is queue depth (prefill work is
    admission-bound); decode pressure is queue depth plus
    ``slo_weight`` x the excess SLO burn (burn > 1 means tenants'
    p99 TPOT objective is being violated — the signal disaggregation
    exists to protect). An imbalance counts when one side's mean
    pressure exceeds ``threshold`` x the other's plus an absolute
    epsilon, so two idle pools (0 vs 0.1) never trigger.
    """

    def __init__(self, threshold: float = 2.0, windows: int = 3,
                 dwell_s: float = 30.0, slo_weight: float = 4.0):
        self.threshold = float(threshold)
        self.windows = int(windows)
        self.dwell_s = float(dwell_s)
        self.slo_weight = float(slo_weight)
        self._direction = 0  # +1 decode needs help, -1 prefill does
        self._streak = 0
        self._last_move: float | None = None

    def _pressure(self, s: dict, decode: bool) -> float:
        p = float(s.get("queue_depth") or 0)
        if decode:
            p += self.slo_weight * max(0.0, float(s.get("slo_burn") or 0.0) - 1.0)
        return p

    def observe(self, now: float,
                samples: dict) -> list[tuple[str, str]]:
        pf = {n: s for n, s in samples.items() if s.get("role") == "prefill"}
        dc = {n: s for n, s in samples.items() if s.get("role") == "decode"}
        if not pf or not dc:
            self._streak, self._direction = 0, 0
            return []
        p_pf = sum(self._pressure(s, False) for s in pf.values()) / len(pf)
        p_dc = sum(self._pressure(s, True) for s in dc.values()) / len(dc)
        eps = 0.5
        if p_dc > self.threshold * p_pf + eps:
            direction = 1
        elif p_pf > self.threshold * p_dc + eps:
            direction = -1
        else:
            direction = 0
        if direction == 0:
            self._direction, self._streak = 0, 0
            return []
        if direction != self._direction:
            self._direction, self._streak = direction, 1
        else:
            self._streak += 1
        if self._streak < self.windows:
            return []
        if (self._last_move is not None
                and now - self._last_move < self.dwell_s):
            return []
        donors = pf if direction > 0 else dc
        if len(donors) <= 1:
            return []  # never empty a role
        name = min(
            donors,
            key=lambda n: self._pressure(donors[n], direction < 0),
        )
        self._last_move = now
        self._streak = 0
        return [(name, "decode" if direction > 0 else "prefill")]


class _Member:
    """Controller-side view of one fleet replica."""

    __slots__ = ("host", "port", "role", "role_since", "healthy",
                 "draining", "incompatible", "config_hash", "hit_grain",
                 "in_flight", "routed", "queue_depth", "slo_burn", "shadow",
                 "last_health", "breaker")

    def __init__(self, host: str, port: int, role: str = "monolithic"):
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r} (one of {ROLES})")
        self.host = host
        self.port = int(port)
        self.role = role  # guarded-by: _route_lock
        self.role_since = 0.0
        self.healthy = True  # guarded-by: _route_lock
        self.draining = False  # guarded-by: _route_lock
        self.incompatible = False  # guarded-by: _route_lock
        self.config_hash: str | None = None
        #: the shortest segment the replica seats (0 until polled)
        self.hit_grain = 0
        self.in_flight = 0  # guarded-by: _route_lock
        self.routed = 0
        self.queue_depth = 0
        self.slo_burn = 0.0
        self.shadow = PrefixShadow()
        self.last_health: dict | None = None
        # per-replica circuit breaker; dispatch gates on it (the binary
        # healthy flag above stays as the liveness VIEW, the breaker is
        # what decides). The controller replaces this with one wired to
        # its transition hooks.
        self.breaker = CircuitBreaker()

    def dispatchable(self) -> bool:  # lint: holds _route_lock
        """Usable AND the breaker is closed — the fast path. Open or
        half-open breakers only admit the explicit probe picked in
        ``_pick_decode``/``_pick_prefills``."""
        return self.usable() and self.breaker.state == CLOSED

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"

    def usable(self) -> bool:  # lint: holds _route_lock
        return self.healthy and not self.draining and not self.incompatible

    def decode_capable(self) -> bool:  # lint: holds _route_lock
        return self.role in ("decode", "monolithic")

    def state(self) -> dict:  # lint: holds _route_lock
        return {
            "role": self.role,
            "healthy": self.healthy,
            "draining": self.draining,
            "incompatible": self.incompatible,
            "config_hash": self.config_hash,
            "hit_grain": self.hit_grain,
            "in_flight": self.in_flight,
            "routed": self.routed,
            "queue_depth": self.queue_depth,
            "slo_burn": self.slo_burn,
            "shadow_nodes": len(self.shadow),
            "breaker": self.breaker.snapshot(),
        }


def _parse_member(spec) -> _Member:
    """Accept ``"host:port"``, ``"host:port=role"``, or
    ``(host, port[, role])`` tuples."""
    if isinstance(spec, str):
        addr, _, role = spec.partition("=")
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"replica spec {spec!r} is not "
                             "host:port[=role]")
        return _Member(host, int(port), role or "monolithic")
    host, port = spec[0], spec[1]
    role = spec[2] if len(spec) > 2 else "monolithic"
    return _Member(str(host), int(port), str(role))


class FleetController:
    """Role-aware fleet front end; ``start()`` is non-blocking.

    ``disagg_threshold`` — prompt length (tokens) at which a request
    takes the prefill->transfer->decode path instead of prefilling on
    the decode replica. Below it the transfer costs more than the
    prefill it saves (see PERF.md for the heuristic). A decode replica's
    ``hit_grain`` raises it for that replica, and a request naming an
    adapter other than 0 never takes the transfer.
    """

    def __init__(self, replicas, host: str = "127.0.0.1", port: int = 0,
                 disagg_threshold: int = 64,
                 affinity_min_match: int = 8,
                 health_interval_s: float = 0.5,
                 request_timeout_s: float = 300.0,
                 rebalance: RoleBalancer | None = None,
                 rebalance_enabled: bool = True,
                 session_cap: int = 65536,
                 tracer: Tracer | None = None,
                 flight: FlightRecorder | None = None,
                 flight_dir: str | None = None,
                 hedge_enabled: bool = True,
                 journal: str | None = None,
                 standby_of: str | None = None,
                 failover_after: int = 3):
        if not replicas:
            raise ValueError("need at least one replica")
        self.members = [_parse_member(spec) for spec in replicas]
        self.disagg_threshold = int(disagg_threshold)
        self.affinity_min_match = int(affinity_min_match)
        self.health_interval_s = float(health_interval_s)
        self.request_timeout_s = float(request_timeout_s)
        self.balancer = rebalance if rebalance is not None else RoleBalancer()
        self.rebalance_enabled = bool(rebalance_enabled)
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=False, process_name="controller")
        self.flight = flight if flight is not None else FlightRecorder()
        self.flight_dir = (flight_dir if flight_dir is not None
                           else os.environ.get("DL4J_TPU_FLIGHT_DIR")
                           or None)
        self._stop = threading.Event()
        self._route_lock = wrap_lock(threading.Lock(),
                                     "controller._route_lock")
        self._rr = 0  # round-robin tie-break cursor
        # session id -> decode replica name, LRU-bounded; a session
        # whose replica died just falls back to shadow affinity
        self._sessions: OrderedDict[str, str] = OrderedDict()
        self._session_cap = int(session_cap)
        # hedging: the transfer leg is idempotent (the decode replica
        # dedups on the shared idempotency key), so a second attempt
        # fires after the observed p99 transfer latency
        self.hedge_enabled = bool(hedge_enabled)
        self._transfer_lat = LatencyWindow()
        # checkpoint + failover: the journal captures roles, session
        # stickiness (LRU order), breaker state, and config hashes so a
        # warm standby promotes from disk and re-verifies against live
        # /fleet state instead of starting cold
        self.journal_path = Path(journal) if journal else None
        self._journal_seq = 0
        self.standby_of = standby_of or None
        self.failover_after = max(1, int(failover_after))
        self._primary_misses = 0
        # standby controllers route nothing until promoted
        self._active = self.standby_of is None

        reg = self.registry = MetricsRegistry()
        self._m_requests = reg.counter(
            "fleet_requests_total", "Requests accepted by the controller.")
        self._m_routed = reg.counter(
            "fleet_routed_total", "Generates dispatched, per replica.",
            labelnames=("replica",))
        self._m_disagg = reg.counter(
            "fleet_disagg_total",
            "Requests that took the prefill->transfer->decode path.")
        self._m_fallback = reg.counter(
            "fleet_transfer_fallback_total",
            "Disagg-eligible requests that fell back to local prefill "
            "on the decode replica (prefill down / push rejected / "
            "segment declined).")
        self._m_sticky = reg.counter(
            "fleet_sticky_total",
            "Dispatches decided by session stickiness.")
        self._m_affinity = reg.counter(
            "fleet_affinity_total",
            "Dispatches decided by shadow-trie prefix affinity.")
        self._m_retries = reg.counter(
            "fleet_retries_total",
            "Generate forwards retried on another replica.")
        self._m_no_replica = reg.counter(
            "fleet_no_replica_total",
            "Requests failed because no usable decode replica remained.")
        self._m_rebalance = reg.counter(
            "fleet_rebalances_total", "Role flips applied, per new role.",
            labelnames=("role",))
        self._m_role = reg.gauge(
            "fleet_role_replicas", "Usable replicas per role.",
            labelnames=("role",))
        self._m_healthy = reg.gauge(
            "fleet_replica_healthy", "1 while the replica is usable.",
            labelnames=("replica",))
        self._m_breaker = reg.gauge(
            "fleet_breaker_state",
            "Circuit breaker per replica: 0 closed, 0.5 half-open, "
            "1 open.",
            labelnames=("replica",))
        self._m_breaker_transitions = reg.counter(
            "fleet_breaker_transitions_total",
            "Breaker state changes, per replica and new state.",
            labelnames=("replica", "state"))
        self._m_hedges = reg.counter(
            "fleet_hedges_total",
            "Hedged transfer legs, by result (fired = second attempt "
            "launched, won = second attempt answered first).",
            labelnames=("result",))
        self._m_sessions_evicted = reg.counter(
            "fleet_sessions_evicted_total",
            "Sticky sessions dropped by LRU eviction at session_cap.")
        self._m_failovers = reg.counter(
            "fleet_failovers_total",
            "Standby promotions after losing the primary.")
        self._m_migrations = reg.counter(
            "fleet_migrations_total",
            "Live session migrations relayed on drain, by result.",
            labelnames=("result",))
        self._m_standby = reg.gauge(
            "fleet_standby", "1 while this controller is a standby.")
        self._m_standby.set(0.0 if self._active else 1.0)
        for m in self.members:
            self._m_healthy.set(1.0, replica=m.name)
            self._m_breaker.set(0.0, replica=m.name)
            # rewire each member's breaker through the controller's
            # transition hook (flight event + gauge + journal)
            m.breaker = CircuitBreaker(
                on_transition=self._breaker_hook(m.name))
        self._refresh_role_gauges()

        controller = self

        class Handler(QuietHandler):
            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    payload = controller.health_payload()
                    send_json(self, 200 if payload["ok"] else 503, payload)
                elif path == "/fleet":
                    send_json(self, 200, controller.fleet_state())
                elif path == "/metrics":
                    send_body(self, 200, reg.render().encode(),
                              PROM_CONTENT_TYPE)
                elif path == "/debug/dump":
                    send_json(self, 200,
                              controller.flight_bundle("debug_dump"))
                else:
                    send_json(self, 404, {"error": "not found"})

            def do_POST(self):
                path = urlparse(self.path).path
                if controller._stop.is_set():
                    send_json(self, 503, {"error": "controller stopped"})
                    return
                if not controller._active:
                    # a standby routes nothing until promoted; callers
                    # retry against the primary (or wait for failover)
                    send_json(self, 503, {"error": "standby controller",
                                          "standby": True})
                    return
                if path in ("/fleet/drain", "/fleet/undrain",
                            "/fleet/role"):
                    body = read_json_body(self)
                    if body is None:
                        send_json(self, 400, {"error": "malformed JSON"})
                        return
                    controller._handle_fleet_post(self, path, body)
                    return
                if path != "/v1/generate":
                    send_json(self, 404, {"error": "not found"})
                    return
                body = read_json_body(self)
                if body is None:
                    send_json(self, 400, {"error": "malformed JSON"})
                    return
                code, payload, served_by = controller.route(
                    body, traceparent=self.headers.get("traceparent"),
                    deadline_ms=self.headers.get(DEADLINE_HEADER))
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                if served_by is not None:
                    self.send_header("X-Served-By", served_by)
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="controller-http")
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="controller-health")

    # ------------------------------------------------------------- #
    # routing                                                        #
    # ------------------------------------------------------------- #

    @staticmethod
    def _prompt_tokens(body: dict) -> list[int]:
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return list(prompt.encode("latin-1", errors="replace"))
        if isinstance(prompt, list):
            try:
                return [int(t) for t in prompt]
            except (TypeError, ValueError):
                return []
        return []

    def _note_session(self, session, name: str) -> None:
        if not session:
            return
        key = str(session)
        with self._route_lock:
            note_access("controller._sessions", write=True)
            self._sessions[key] = name
            self._sessions.move_to_end(key)
            while len(self._sessions) > self._session_cap:
                evicted, _ = self._sessions.popitem(last=False)
                self._m_sessions_evicted.inc()
                log_event(_log, "fleet_session_evicted",
                          session=evicted, cap=self._session_cap)

    def _pick_decode(self, tokens, session,
                     exclude: set[str]) -> tuple[_Member, str]:
        """Choose the decode-capable target; returns ``(member, how)``
        with ``how`` in sticky/affinity/load. Raises ``_ReplicaDown``
        when no usable candidate remains. Breaker-gated: closed
        breakers are the normal pool; when it is empty, ONE due probe
        through an open breaker is admitted (half-open) so a recovered
        replica can prove itself on real traffic."""
        with self._route_lock:
            avail = [
                m for m in self.members
                if m.usable() and m.decode_capable()
                and m.name not in exclude
            ]
            candidates = [m for m in avail if m.breaker.state == CLOSED]
            if not candidates:
                # allow() consumes the half-open probe, so only ask
                # when no closed-breaker replica remains
                candidates = [m for m in avail if m.breaker.allow()]
            if not candidates:
                raise _ReplicaDown("no usable decode replica")
            chosen, how = None, "load"
            if session:
                note_access("controller._sessions", write=True)
                want = self._sessions.get(str(session))
                if want:
                    for m in candidates:
                        if m.name == want:
                            chosen, how = m, "sticky"
                            # a sticky HIT refreshes LRU recency, so
                            # active sessions outlive idle pins at the
                            # eviction cap
                            self._sessions.move_to_end(str(session))
                            break
            if chosen is None and tokens:
                best, best_match = None, -1
                for m in candidates:
                    match = m.shadow.longest_match(tokens)
                    if match > best_match or (
                        match == best_match
                        and m.in_flight < best.in_flight
                    ):
                        best, best_match = m, match
                if best_match >= self.affinity_min_match:
                    chosen, how = best, "affinity"
            if chosen is None:
                self._rr += 1
                lo = min(m.in_flight for m in candidates)
                tied = [m for m in candidates if m.in_flight == lo]
                chosen = tied[self._rr % len(tied)]
            chosen.in_flight += 1
            chosen.routed += 1
            if tokens:
                chosen.shadow.insert(tokens)
            return chosen, how

    def _pick_prefills(self, decode_name: str) -> list[_Member]:
        """Usable DEDICATED prefill replicas, least-loaded first
        (monolithic replicas prefill for themselves; shipping KV from
        one decode replica to another buys nothing). Entry [0] is the
        primary transfer target; entry [1], when present, is the hedge
        destination. Empty when the fleet has no transfer path — the
        caller falls back to local prefill. Breaker-gated like
        ``_pick_decode``."""
        with self._route_lock:
            avail = [
                m for m in self.members
                if m.usable() and m.role == "prefill"
                and m.name != decode_name
            ]
            candidates = [m for m in avail if m.breaker.state == CLOSED]
            if not candidates:
                candidates = [m for m in avail if m.breaker.allow()]
            ranked = sorted(
                (m.in_flight, i, m) for i, m in enumerate(candidates)
            )
            return [m for _, _, m in ranked]

    def _span(self, name: str, trace_id: str, span_id: str,
              parent_span: str, t0: float, **extra) -> None:
        if not self.tracer.enabled:
            return
        args = {"trace_id": trace_id, "span_id": span_id, **extra}
        if parent_span:
            args["parent_span_id"] = parent_span
        self.tracer.span(CONTROLLER_TRACK, name, t0,
                         time.perf_counter() - t0, **args)

    def _transfer_leg(self, prefills: list[_Member], target: _Member,
                      body: dict, tokens, trace_id: str,
                      parent_span: str,
                      dl: Deadline | None = None) -> bool:
        """The disagg leg: ask a prefill replica to compute the
        prompt's KV and push the segment to ``target``. True only when
        the segment was pushed AND seated — anything else means the
        forwarded generate will prefill locally (same bytes, just
        slower).

        Idempotent end to end (the decode replica dedups the push on
        the shared ``idem_key``), so with a second prefill candidate
        the leg is HEDGED: if the first attempt hasn't answered within
        the observed p99 transfer latency, a second fires at the
        alternate replica and the first completion wins. The loser's
        push is declined by the dedup (409) — which counts as success
        here, since the segment IS seated — at the price of one wasted
        prefill."""
        idem_key = "tx-" + new_span_id()
        req = {"prompt": tokens, "push_to": target.name,
               "idem_key": idem_key}
        for k in ("priority", "adapter"):
            if k in body:
                req[k] = body[k]
        raw = json.dumps(req).encode()

        def attempt(leg: int):
            prefill = prefills[leg % len(prefills)]
            span_id = new_span_id()
            t0 = time.perf_counter()
            ok, info, err = False, {}, None
            with self._route_lock:
                prefill.in_flight += 1
            try:
                conn = http.client.HTTPConnection(
                    prefill.host, prefill.port,
                    timeout=(dl.timeout(self.request_timeout_s)
                             if dl is not None
                             else self.request_timeout_s))
                try:
                    headers = {
                        "Content-Type": "application/json",
                        "traceparent": format_traceparent(
                            trace_id, span_id),
                        "X-Served-By": prefill.name,
                    }
                    if dl is not None:
                        headers[DEADLINE_HEADER] = dl.header_value()
                    conn.request("POST", "/v1/prefill", body=raw,
                                 headers=headers)
                    resp = conn.getresponse()
                    payload = resp.read()
                    try:
                        info = json.loads(payload.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        info = {}
                    if resp.status == 503:
                        raise _ReplicaDown(f"{prefill.name} answered 503")
                    ok = resp.status == 200 and bool(info.get("pushed"))
                    if (not ok and isinstance(info.get("ingest"), dict)
                            and info["ingest"].get("duplicate")):
                        # the other hedge leg's copy seated first —
                        # same bytes are in the decode replica's cache
                        ok = True
                    prefill.breaker.record_success()
                    if not ok:
                        err = "http %d pushed=%s" % (
                            resp.status, info.get("pushed"))
                except (OSError, http.client.HTTPException,
                        _ReplicaDown) as e:
                    err = str(e)
                    self._mark_unhealthy(prefill, err)
                    raise
                finally:
                    conn.close()
            finally:
                with self._route_lock:
                    prefill.in_flight -= 1
                dt = time.perf_counter() - t0
                self._transfer_lat.record(dt)
                self._span("dispatch", trace_id, span_id, parent_span,
                           t0, leg="prefill", replica=prefill.name,
                           ok=ok)
            return ok, err, prefill.name

        hedge = (self.hedge_enabled and len(prefills) >= 2
                 and (dl is None or not dl.expired()))
        ok, err, via = False, None, prefills[0].name

        def on_hedge():
            self._m_hedges.inc(result="fired")
            self.flight.record("hedge_fired", leg="transfer",
                               trace_id=trace_id,
                               primary=prefills[0].name,
                               hedge=prefills[1].name)

        try:
            if hedge:
                result, legs, winner = run_hedged(
                    attempt, delay_s=self._transfer_lat.quantile(0.99),
                    deadline=dl, on_hedge=on_hedge)
                ok, err, via = result
                if legs > 1 and winner == 1:
                    self._m_hedges.inc(result="won")
                    self.flight.record("hedge_won", leg="transfer",
                                       trace_id=trace_id, replica=via)
            else:
                ok, err, via = attempt(0)
        except (_ReplicaDown, OSError, http.client.HTTPException) as e:
            err = str(e)
        if ok:
            self._m_disagg.inc()
        else:
            self._m_fallback.inc()
            log_event(_log, "fleet_transfer_fallback",
                      prefill=via, decode=target.name,
                      error=err, trace_id=trace_id)
        self.flight.record("transfer", prefill=via,
                           decode=target.name, ok=ok,
                           trace_id=trace_id)
        return ok

    def _forward(self, member: _Member, raw: bytes, headers: dict,
                 dl: Deadline | None = None) -> tuple[int, bytes]:
        conn = http.client.HTTPConnection(
            member.host, member.port,
            timeout=(dl.timeout(self.request_timeout_s)
                     if dl is not None else self.request_timeout_s))
        try:
            conn.request("POST", "/v1/generate", body=raw,
                         headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status == 503:
                raise _ReplicaDown(f"{member.name} answered 503")
            member.breaker.record_success()
            return resp.status, payload
        except (OSError, http.client.HTTPException) as e:
            raise _ReplicaDown(f"{member.name}: {e}") from e
        finally:
            conn.close()

    def route(self, body: dict,
              traceparent: str | None = None,
              deadline_ms: str | None = None
              ) -> tuple[int, bytes, str | None]:
        """Route one generate request; returns
        ``(status, payload_bytes, replica_name | None)``.

        The transfer leg runs at most once (on the first decode pick):
        if the decode replica then dies before accepting the generate,
        the retry on a survivor skips re-transfer — the survivor
        prefills locally, which is the universal fallback anyway.

        Every leg's socket timeout and the shrunken ``X-Deadline-Ms``
        forwarded downstream derive from the caller's deadline budget
        (default: the controller's own request timeout). The generate
        leg itself is never hedged — decoding is not idempotent.
        """
        self._m_requests.inc()
        ctx = parse_traceparent(traceparent)
        trace_id, parent_span = ctx if ctx else (new_trace_id(), "")
        dl = Deadline.from_header(deadline_ms,
                                  default_s=self.request_timeout_s)
        tokens = self._prompt_tokens(body)
        session = body.get("session")
        raw = json.dumps(body).encode()
        exclude: set[str] = set()
        attempt = 0
        transfer_tried = False
        while True:
            if dl.expired():
                # budget gone: a bounded clean failure beats a forward
                # the caller will never read
                return 504, json.dumps(
                    {"error": "deadline exhausted",
                     "attempts": attempt}).encode(), None
            try:
                member, how = self._pick_decode(tokens, session, exclude)
            except _ReplicaDown:
                self._m_no_replica.inc()
                self.flight.record("no_replica", trace_id=trace_id,
                                   attempts=attempt)
                return 503, json.dumps(
                    {"error": "no usable decode replica"}).encode(), None
            attempt += 1
            self._m_routed.inc(replica=member.name)
            if how == "sticky":
                self._m_sticky.inc()
            elif how == "affinity":
                self._m_affinity.inc()
            if (not transfer_tried and not body.get("adapter")
                    and len(tokens) >= max(self.disagg_threshold,
                                           member.hit_grain)):
                transfer_tried = True
                prefills = self._pick_prefills(member.name)
                if prefills:
                    self._transfer_leg(prefills, member, body, tokens,
                                       trace_id, parent_span, dl)
            span_id = new_span_id()
            headers = {
                "Content-Type": "application/json",
                "traceparent": format_traceparent(trace_id, span_id),
                "X-Served-By": member.name,
                DEADLINE_HEADER: dl.header_value(),
            }
            if self.flight.enabled:
                self.flight.record("dispatch", replica=member.name,
                                   attempt=attempt, how=how,
                                   trace_id=trace_id)
            t0 = time.perf_counter()
            try:
                status, payload = self._forward(member, raw, headers, dl)
                self._span("dispatch", trace_id, span_id, parent_span,
                           t0, leg="decode", replica=member.name,
                           attempt=attempt, how=how, status=status)
                self._note_session(session, member.name)
                return status, payload, member.name
            except _ReplicaDown as e:
                self._span("dispatch", trace_id, span_id, parent_span,
                           t0, leg="decode", replica=member.name,
                           attempt=attempt, how=how, error=str(e))
                self._mark_unhealthy(member, str(e))
                self._m_retries.inc()
                exclude.add(member.name)
                log_event(_log, "fleet_retry", replica=member.name,
                          error=str(e), trace_id=trace_id)
            finally:
                with self._route_lock:
                    member.in_flight -= 1

    # ------------------------------------------------------------- #
    # fleet control                                                  #
    # ------------------------------------------------------------- #

    def _member(self, name: str) -> _Member | None:
        for m in self.members:
            if m.name == name:
                return m
        return None

    def _handle_fleet_post(self, handler, path: str, body: dict) -> None:
        name = str(body.get("replica", ""))
        member = self._member(name)
        if member is None:
            send_json(handler, 404,
                      {"error": f"unknown replica {name!r}"})
            return
        if path == "/fleet/role":
            role = str(body.get("role", ""))
            if role not in ROLES:
                send_json(handler, 400,
                          {"error": f"role must be one of {ROLES}"})
                return
            self._apply_role(member, role, why="manual")
            send_json(handler, 200, {"replica": name, "role": role})
            return
        draining = path == "/fleet/drain"
        ok, info = self._relay_drain(member, draining)
        with self._route_lock:
            note_access(f"controller.{name}.draining", write=True)
            if ok:
                member.draining = draining
            now_draining = member.draining
        log_event(_log, "fleet_drain" if draining else "fleet_undrain",
                  replica=name, relayed=ok)
        out = {
            "replica": name, "draining": now_draining,
            "relayed": ok, "replica_response": info,
        }
        if draining and ok and body.get("migrate"):
            # drain-with-migration: once the replica stops admitting,
            # relay its /migrate so live sessions finish elsewhere
            # instead of riding out the drain (or dying with it)
            out["migration"] = self._migrate_replica(member)
        self._write_journal()
        send_json(handler, 200 if ok else 502, out)

    def _migrate_replica(self, member: _Member) -> dict:
        """Relay ``member``'s ``POST /migrate`` with every OTHER
        usable decode-capable replica (closed breakers only — a
        migrating session must not probe a suspect replica) as the
        target list. Failure is soft: sessions that do not seat stay
        on the replica's ordinary drain path."""
        with self._route_lock:
            targets = [
                m.name for m in self.members
                if m is not member and m.dispatchable()
                and m.decode_capable()
            ]
        if not targets:
            self._m_migrations.inc(result="no_target")
            return {"error": "no migration targets"}
        info: dict = {}
        err = None
        try:
            conn = http.client.HTTPConnection(
                member.host, member.port,
                timeout=self.request_timeout_s)
            try:
                conn.request(
                    "POST", "/migrate",
                    body=json.dumps({"targets": targets}).encode(),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                raw = resp.read()
                try:
                    info = json.loads(raw.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    info = {}
                if resp.status != 200 and "error" not in info:
                    err = f"http {resp.status}"
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            err = str(e)
        if err:
            info = dict(info)
            info["error"] = err
        result = ("ok" if not info.get("error")
                  and not info.get("failed") else "failed")
        self._m_migrations.inc(result=result)
        self.flight.record("migration", replica=member.name,
                           result=result,
                           migrated=info.get("migrated"),
                           failed=info.get("failed"))
        log_event(_log, "fleet_migration", replica=member.name,
                  result=result, migrated=info.get("migrated"),
                  failed=info.get("failed"), error=info.get("error"))
        return info

    def _relay_drain(self, member: _Member,
                     draining: bool) -> tuple[bool, dict]:
        """POST the replica's own /drain or /undrain; the controller
        stops dispatching the moment the relay succeeds (it does not
        wait for the next health poll)."""
        try:
            conn = http.client.HTTPConnection(
                member.host, member.port,
                timeout=max(1.0, self.health_interval_s * 4))
            try:
                conn.request(
                    "POST", "/drain" if draining else "/undrain",
                    body=b"{}",
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                raw = resp.read()
                try:
                    info = json.loads(raw.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    info = {}
                return resp.status == 200, info
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            return False, {"error": str(e)}

    def _apply_role(self, member: _Member, role: str, why: str) -> None:
        with self._route_lock:
            note_access(f"controller.{member.name}.role", write=True)
            old, member.role = member.role, role
            member.role_since = time.monotonic()
        self._m_rebalance.inc(role=role)
        self._refresh_role_gauges()
        log_event(_log, "fleet_role_change", replica=member.name,
                  old=old, new=role, why=why)
        self._write_journal()

    def _refresh_role_gauges(self) -> None:
        counts = {r: 0 for r in ROLES}
        with self._route_lock:
            for m in self.members:
                counts[m.role] += 1
        for role, n in counts.items():
            self._m_role.set(float(n), role=role)

    def _maybe_rebalance(self) -> None:
        if not self.rebalance_enabled:
            return
        with self._route_lock:
            samples = {
                m.name: {"role": m.role, "queue_depth": m.queue_depth,
                         "slo_burn": m.slo_burn}
                for m in self.members if m.usable()
            }
        for name, role in self.balancer.observe(time.monotonic(),
                                                samples):
            member = self._member(name)
            if member is not None:
                self._apply_role(member, role, why="rebalance")
                self.flight.record("rebalance", replica=name, role=role)

    # ------------------------------------------------------------- #
    # health                                                         #
    # ------------------------------------------------------------- #

    def _breaker_hook(self, name: str):
        """Transition listener for one replica's breaker: gauge,
        counter, and flight event per state change. Fires inside the
        breaker's own lock, so it must stay cheap and must not take
        ``_route_lock``."""
        def hook(old: str, new: str) -> None:
            self._m_breaker.set(
                {CLOSED: 0.0, HALF_OPEN: 0.5}.get(new, 1.0),
                replica=name)
            self._m_breaker_transitions.inc(replica=name, state=new)
            self.flight.record("breaker", replica=name,
                               old=old, new=new)
            log_event(_log, "fleet_breaker", replica=name,
                      old=old, new=new)
        return hook

    def _mark_unhealthy(self, member: _Member, why: str) -> None:
        member.breaker.record_failure()
        with self._route_lock:
            note_access(f"controller.{member.name}.healthy", write=True)
            flipped = member.healthy
            if flipped:
                member.healthy = False
        if flipped:
            self._m_healthy.set(0.0, replica=member.name)
            log_event(_log, "fleet_replica_down", replica=member.name,
                      error=why)

    def _poll_one(self, member: _Member) -> None:
        hp = None
        burn = None
        try:
            conn = http.client.HTTPConnection(
                member.host, member.port,
                timeout=max(0.25, self.health_interval_s))
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                raw = resp.read()
                try:
                    hp = json.loads(raw)
                except ValueError:
                    hp = None
                ok = resp.status == 200
                if ok:
                    # worst per-tenant SLO burn: the tenant gauges ride
                    # /metrics.json as tenants.<tid>.slo_burn
                    conn.request("GET", "/metrics.json")
                    mresp = conn.getresponse()
                    mraw = mresp.read()
                    if mresp.status == 200:
                        try:
                            mj = json.loads(mraw)
                            burn = max(
                                (float(t.get("slo_burn") or 0.0)
                                 for t in mj.get("tenants", {}).values()),
                                default=0.0,
                            )
                        except (ValueError, TypeError):
                            burn = None
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            ok = False
        member.last_health = hp if isinstance(hp, dict) else None
        if ok and member.last_health is not None:
            hp = member.last_health
            cfg = hp.get("config_hash")
            if cfg:
                with self._route_lock:
                    note_access(
                        f"controller.{member.name}.config_hash",
                        write=True)
                    if member.config_hash is None:
                        member.config_hash = str(cfg)
                        newly_bad = False
                    else:
                        newly_bad = (member.config_hash != str(cfg)
                                     and not member.incompatible)
                        if newly_bad:
                            member.incompatible = True
                if newly_bad:
                    log_event(_log, "fleet_replica_incompatible",
                              replica=member.name,
                              expected=member.config_hash[:12],
                              got=str(cfg)[:12], level=logging.ERROR)
            try:
                member.hit_grain = int(hp.get("hit_grain") or 0)
            except (TypeError, ValueError):
                member.hit_grain = 0
            with self._route_lock:
                note_access(f"controller.{member.name}.draining",
                            write=True)
                member.draining = bool(hp.get("draining"))
                member.queue_depth = int(hp.get("queue_depth") or 0)
                if burn is not None:
                    member.slo_burn = burn
        if ok:
            with self._route_lock:
                note_access(f"controller.{member.name}.healthy",
                            write=True)
                flipped = not member.healthy
                if flipped:
                    member.healthy = True
            if flipped:
                self._m_healthy.set(1.0, replica=member.name)
                log_event(_log, "fleet_replica_up", replica=member.name)
        else:
            self._mark_unhealthy(member, "healthz poll failed")

    def poll_health(self) -> None:
        """One synchronous poll + rebalance pass (tests use this to
        avoid sleeping for the background interval)."""
        for m in self.members:
            self._poll_one(m)
        self._maybe_rebalance()
        if self._active:
            self._write_journal()

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            if self._active:
                self.poll_health()
            else:
                self._watch_primary()
            self._stop.wait(self.health_interval_s)

    # ------------------------------------------------------------- #
    # journal + standby failover                                     #
    # ------------------------------------------------------------- #

    def _write_journal(self) -> None:
        """Checkpoint controller state (roles, sticky sessions in LRU
        order, breaker snapshots, config hashes, drain flags) with an
        atomic tmp+rename so the standby never reads a torn file."""
        if self.journal_path is None:
            return
        with self._route_lock:
            note_access("controller._sessions", write=True)
            self._journal_seq += 1
            state = {
                "seq": self._journal_seq,
                "ts": time.time(),
                "controller": self.name,
                "roles": {m.name: m.role for m in self.members},
                "draining": [m.name for m in self.members if m.draining],
                "config_hashes": {
                    m.name: m.config_hash for m in self.members
                    if m.config_hash
                },
                "breakers": {
                    m.name: m.breaker.snapshot() for m in self.members
                },
                "sessions": list(self._sessions.items()),
            }
        tmp = self.journal_path.with_name(self.journal_path.name + ".tmp")
        try:
            tmp.write_text(json.dumps(state, sort_keys=True))
            os.replace(tmp, self.journal_path)
        except OSError as e:
            log_event(_log, "fleet_journal_write_failed", error=repr(e),
                      level=logging.ERROR)

    def restore_journal(self) -> bool:
        """Load the journal written by the (former) primary: roles,
        session stickiness, breaker state, expected config hashes.
        Returns False (and starts from the constructor state) when the
        journal is absent or unreadable — failover still works, it
        just loses stickiness and breaker history."""
        if self.journal_path is None or not self.journal_path.exists():
            return False
        try:
            state = json.loads(self.journal_path.read_text())
        except (OSError, ValueError) as e:
            log_event(_log, "fleet_journal_unreadable", error=repr(e),
                      level=logging.ERROR)
            return False
        with self._route_lock:
            note_access("controller._sessions", write=True)
            for name, role in (state.get("roles") or {}).items():
                m = self._member(str(name))
                if m is not None and role in ROLES:
                    m.role = str(role)
            for name in state.get("draining") or ():
                m = self._member(str(name))
                if m is not None:
                    m.draining = True
            for name, cfg in (state.get("config_hashes") or {}).items():
                m = self._member(str(name))
                if m is not None and m.config_hash is None:
                    m.config_hash = str(cfg)
            for name, snap in (state.get("breakers") or {}).items():
                m = self._member(str(name))
                if m is not None and isinstance(snap, dict):
                    m.breaker.restore(snap)
            self._sessions.clear()
            for pair in state.get("sessions") or ():
                if isinstance(pair, (list, tuple)) and len(pair) == 2:
                    self._sessions[str(pair[0])] = str(pair[1])
            self._journal_seq = int(state.get("seq") or 0)
        self._refresh_role_gauges()
        log_event(_log, "fleet_journal_restored",
                  seq=self._journal_seq,
                  sessions=len(self._sessions))
        return True

    def _watch_primary(self) -> None:
        """Standby mode: probe the primary's ``/healthz``;
        ``failover_after`` consecutive misses promote this standby."""
        host, _, port = str(self.standby_of).rpartition(":")
        ok = False
        try:
            conn = http.client.HTTPConnection(
                host or "127.0.0.1", int(port),
                timeout=max(0.25, self.health_interval_s))
            try:
                conn.request("GET", "/healthz")
                ok = conn.getresponse().status < 500
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError):
            ok = False
        if ok:
            self._primary_misses = 0
            return
        self._primary_misses += 1
        if self._primary_misses >= self.failover_after:
            self.promote()

    def promote(self) -> None:
        """Standby -> primary: restore the journal, then RE-VERIFY
        against live fleet state with a full health sweep — the live
        ``/healthz``/``/metrics.json`` answers override anything stale
        in the journal (drain flags, queue depths, a replica that died
        since the last checkpoint)."""
        if self._active:
            return
        restored = self.restore_journal()
        self._active = True
        self._primary_misses = 0
        self._m_standby.set(0.0)
        self._m_failovers.inc()
        self.flight.record("failover", controller=self.name,
                           primary=self.standby_of,
                           journal_restored=restored,
                           journal_seq=self._journal_seq)
        log_event(_log, "fleet_failover", controller=self.name,
                  primary=self.standby_of, journal_restored=restored,
                  journal_seq=self._journal_seq, level=logging.WARNING)
        self.poll_health()

    def health_payload(self) -> dict:
        with self._route_lock:
            usable = [m.name for m in self.members if m.usable()]
            decode = [m.name for m in self.members
                      if m.usable() and m.decode_capable()]
            return {
                "ok": self._active and bool(decode),
                "active": self._active,
                "standby_of": self.standby_of,
                "usable": usable,
                "roles": {m.name: m.role for m in self.members},
                "disagg_threshold": self.disagg_threshold,
            }

    def fleet_state(self) -> dict:
        with self._route_lock:
            return {
                "replicas": {m.name: m.state() for m in self.members},
                "sessions": len(self._sessions),
                "disagg_threshold": self.disagg_threshold,
                "active": self._active,
                "journal_seq": self._journal_seq,
            }

    # ------------------------------------------------------------- #
    # lifecycle + flight recorder                                    #
    # ------------------------------------------------------------- #

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def name(self) -> str:
        return "%s:%d" % self.address

    def flight_bundle(self, reason: str) -> dict:
        return self.flight.dump(
            reason, tracer=self.tracer,
            extra={"controller": self.name,
                   "fleet": self.fleet_state()})

    def _dump_flight(self, reason: str) -> None:
        if not self.flight_dir:
            return
        try:
            path = Path(self.flight_dir) / (
                "flight-controller-%s-%s-%d.json" % (
                    self.name.replace(":", "-"), reason,
                    int(time.time() * 1000)))
            self.flight.dump_to(
                path, reason, tracer=self.tracer,
                extra={"controller": self.name,
                       "fleet": self.fleet_state()})
            log_event(_log, "flight_dump", reason=reason,
                      path=str(path))
        except Exception as e:
            log_event(_log, "flight_dump_failed", reason=reason,
                      error=repr(e), level=logging.ERROR)

    def start(self) -> "FleetController":
        self._http_thread.start()
        self._health_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._health_thread.ident:
            self._health_thread.join(timeout=5)

    def serve_forever(self) -> None:
        """Blocking convenience for the CLI; Ctrl-C stops, SIGTERM
        dumps a flight bundle first, then stops."""
        self.start()
        done = threading.Event()

        def _on_sigterm(signum, frame):
            self._dump_flight("sigterm")
            done.set()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread (embedded use)
        try:
            while not done.is_set():
                time.sleep(1)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
