"""Prefix-affinity replica router: one thin process in front of N
serving replicas (the port's own copy of
``deeplearning4j_tpu/serving/router.py``: it imports no ``torch``, loads no
model and touches no device; plain locks stand for the reference's
sanitizer-wrapped ones).

Tensor parallelism (``ServingEngine(tp=N)``) scales one model copy
across devices; the router scales *throughput* across model copies. It
is deliberately dumb about models — it never tokenizes, never touches
a device, and holds no request state beyond in-flight counters — so a
replica fleet is just N ``ServingServer`` processes plus this.

Routing policy (in priority order):

1. **Prefix affinity.** The router keeps a host-side token trie per
   replica — a shadow of every prompt it has routed there. A new
   prompt goes to the healthy replica whose shadow reports the longest
   shared prefix, when that match reaches ``affinity_min_match``
   tokens: that replica's radix prefix cache almost certainly
   still holds the matching KV run, so routing anywhere else forfeits
   the prefill savings. The shadow is an over-approximation of the
   replica's real cache (it never sees evictions) — a stale hit costs
   one ordinary prefill, never a wrong answer, so the router stays
   decoupled from replica cache internals.
2. **Least loaded.** Otherwise the replica with the fewest router-side
   in-flight requests wins, round-robin on ties.

Failure handling mirrors the per-replica supervision already inside
``ServingServer``: an engine crash *inside* a replica is invisible
here (the replica's supervisor replays and the blocked forward simply
takes longer), while a dead replica *process* surfaces as a connect
error or 503 — the router marks it unhealthy, retries the request on
the remaining healthy replicas (generate submits are idempotent until
accepted: a connect/send failure means the replica never admitted it),
and a background poller flips the replica back to healthy once its
``/healthz`` answers 200 again.

Fleet tracing: the router is the natural trace root. It adopts the
caller's W3C ``traceparent`` (or starts a trace), and injects a fresh
dispatch span id downstream on EVERY forward attempt — including
retries onto survivors — so the merged Perfetto view (``trace-merge``)
shows the failed attempt and the retry as sibling spans under one
trace, each linked by a flow arrow to the replica's admission span.

Resilience: per-replica circuit breakers
(:class:`~deeplearning4j_tpu_torch.serving.rpc.CircuitBreaker`,
closed/open/half-open with exponential probe backoff) gate dispatch —
a health-poll success alone never closes an open breaker, only a
successful forwarded request does — and every attempt honors the
caller's ``X-Deadline-Ms`` budget (socket timeouts derived from it,
shrunken budget re-forwarded downstream). Generate forwards are never
hedged: decoding is not idempotent.

Endpoints: ``POST /v1/generate`` (routed passthrough; replica status
codes and bodies are forwarded verbatim, plus ``X-Served-By``),
``GET /healthz`` (200 while >= 1 replica is healthy), ``GET /replicas``
(per-replica routing state), ``GET /metrics`` (Prometheus text for the
router's own counters/gauges, labelled per replica),
``GET /debug/dump`` (flight-recorder postmortem bundle).
"""

from __future__ import annotations

import http.client
import logging
import os
import signal
import threading
import time
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
from deeplearning4j_tpu_torch.serving.rpc import (
    CLOSED,
    DEADLINE_HEADER,
    HALF_OPEN,
    CircuitBreaker,
    Deadline,
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

#: the router's single trace track (it has one logical timeline)
ROUTER_TRACK = "router"


class _ReplicaDown(Exception):
    """Transport-level failure talking to a replica (connect/send/read
    error or a 503) — the request was not accepted there."""


class PrefixShadow:
    """Host-side token trie over the prompts routed to one replica.

    ``longest_match`` is the router's estimate of how many prompt
    tokens the replica's prefix cache could reuse. Memory is bounded by
    ``max_nodes`` (one dict entry per distinct token position); at the
    cap the trie resets wholesale — crude, but affinity only needs
    recent history, and a cold shadow merely degrades to least-loaded
    routing until it re-learns.
    """

    __slots__ = ("_root", "_nodes", "max_nodes", "resets")

    def __init__(self, max_nodes: int = 1_000_000):
        self._root: dict = {}
        self._nodes = 0
        self.max_nodes = max_nodes
        self.resets = 0

    def insert(self, tokens) -> None:
        if self._nodes >= self.max_nodes:
            self._root = {}
            self._nodes = 0
            self.resets += 1
        node = self._root
        for t in tokens:
            t = int(t)
            nxt = node.get(t)
            if nxt is None:
                nxt = node[t] = {}
                self._nodes += 1
            node = nxt

    def longest_match(self, tokens) -> int:
        node = self._root
        n = 0
        for t in tokens:
            node = node.get(int(t))
            if node is None:
                break
            n += 1
        return n

    def __len__(self) -> int:
        return self._nodes


class _Replica:
    """Router-side view of one backend ``ServingServer``."""

    __slots__ = ("host", "port", "healthy", "in_flight", "routed",
                 "affinity_routed", "retried_away", "shadow",
                 "last_health", "lock", "draining", "incompatible",
                 "config_hash", "breaker")

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = int(port)
        # optimistic until the first poll: a router started moments
        # before its replicas shouldn't 503 the first request wave.
        # healthy/in_flight/retried_away are flipped by HTTP handler
        # threads AND the health poller, so they only move under the
        # router's _route_lock
        self.healthy = True  # guarded-by: _route_lock
        self.in_flight = 0  # guarded-by: _route_lock
        self.routed = 0
        self.affinity_routed = 0
        self.retried_away = 0  # guarded-by: _route_lock
        self.shadow = PrefixShadow()
        self.last_health: dict | None = None
        self.lock = threading.Lock()
        # replica reports draining (POST /drain): stop dispatching to
        # it, resume when its health payload clears the flag
        self.draining = False  # guarded-by: _route_lock
        # first-seen model identity; a replica that comes back from a
        # restart with a DIFFERENT hash is permanently excluded — it
        # serves a different checkpoint now, not this fleet's model
        self.config_hash: str | None = None
        self.incompatible = False  # guarded-by: _route_lock
        # per-replica circuit breaker; dispatch gates on it instead of
        # the binary healthy flag alone (the flag stays as the
        # liveness VIEW). The router replaces this with one wired to
        # its transition hooks.
        self.breaker = CircuitBreaker()

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"

    def state(self) -> dict:  # lint: holds _route_lock
        return {
            "healthy": self.healthy,
            "draining": self.draining,
            "incompatible": self.incompatible,
            "config_hash": self.config_hash,
            "in_flight": self.in_flight,
            "routed": self.routed,
            "affinity_routed": self.affinity_routed,
            "retried_away": self.retried_away,
            "shadow_nodes": len(self.shadow),
            "last_health": self.last_health,
            "breaker": self.breaker.snapshot(),
        }


def _parse_replica(spec) -> tuple[str, int]:
    """Accept ``(host, port)`` tuples or ``"host:port"`` strings."""
    if isinstance(spec, str):
        host, _, port = spec.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"replica spec {spec!r} is not host:port")
        return host, int(port)
    host, port = spec
    return str(host), int(port)


class ReplicaRouter:
    """HTTP router over N serving replicas; ``start()`` is non-blocking.

    ``affinity_min_match`` — minimum shared-prefix length (tokens)
    before affinity overrides least-loaded dispatch. ``health_interval_s``
    — background ``/healthz`` poll period; a replica is also marked
    unhealthy *immediately* when a forward to it fails at transport
    level, so the poll interval bounds recovery detection, not failure
    detection.
    """

    def __init__(self, replicas, host: str = "127.0.0.1", port: int = 0,
                 affinity_min_match: int = 8,
                 health_interval_s: float = 0.5,
                 request_timeout_s: float = 300.0,
                 tracer: Tracer | None = None,
                 flight: FlightRecorder | None = None,
                 flight_dir: str | None = None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = [
            _Replica(*_parse_replica(spec)) for spec in replicas
        ]
        self.affinity_min_match = int(affinity_min_match)
        self.health_interval_s = float(health_interval_s)
        self.request_timeout_s = float(request_timeout_s)
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=False, process_name="router")
        # enabled by default, like the replica engines: the postmortem
        # has to exist before the incident
        self.flight = flight if flight is not None else FlightRecorder()
        self.flight_dir = (flight_dir if flight_dir is not None
                           else os.environ.get("DL4J_TPU_FLIGHT_DIR")
                           or None)
        self._stop = threading.Event()
        self._route_lock = wrap_lock(threading.Lock(),
                                     "router._route_lock")
        self._rr = 0  # round-robin tie-break cursor

        reg = self.registry = MetricsRegistry()
        self._m_requests = reg.counter(
            "router_requests_total", "Requests accepted by the router.")
        self._m_routed = reg.counter(
            "router_routed_total", "Requests dispatched, per replica.",
            labelnames=("replica",))
        self._m_affinity = reg.counter(
            "router_affinity_total",
            "Dispatches where prefix affinity overrode least-loaded.")
        self._m_retries = reg.counter(
            "router_retries_total",
            "Forwards retried on another replica after a transport "
            "failure.")
        self._m_no_replica = reg.counter(
            "router_no_replica_total",
            "Requests failed because no healthy replica remained.")
        self._m_healthy = reg.gauge(
            "router_replica_healthy", "1 while the replica is routable.",
            labelnames=("replica",))
        self._m_draining = reg.gauge(
            "router_replica_draining",
            "1 while the replica reports draining (POST /drain).",
            labelnames=("replica",))
        self._m_incompatible = reg.gauge(
            "router_replica_incompatible",
            "1 once the replica returned with a different model-config "
            "hash (restarted onto the wrong checkpoint).",
            labelnames=("replica",))
        self._m_in_flight = reg.gauge(
            "router_replica_in_flight",
            "Router-side in-flight requests, per replica.",
            labelnames=("replica",))
        self._h_e2e = reg.histogram(
            "router_e2e_seconds",
            "End-to-end routed latency: pick + forward, including any "
            "retries onto surviving replicas.")
        self._h_ttft = reg.histogram(
            "router_replica_ttft_seconds",
            "Per-replica time from forward to the replica's response "
            "headers. The routed passthrough buffers whole bodies, so "
            "for generate this is the replica's full service time — "
            "the router's honest first-byte bound.",
            labelnames=("replica",))
        self._m_breaker = reg.gauge(
            "router_breaker_state",
            "Circuit breaker per replica: 0 closed, 0.5 half-open, "
            "1 open.",
            labelnames=("replica",))
        self._m_breaker_transitions = reg.counter(
            "router_breaker_transitions_total",
            "Breaker state changes, per replica and new state.",
            labelnames=("replica", "state"))
        for r in self.replicas:
            self._m_healthy.set(1.0, replica=r.name)
            self._m_in_flight.set(0.0, replica=r.name)
            self._m_breaker.set(0.0, replica=r.name)
            r.breaker = CircuitBreaker(
                on_transition=self._breaker_hook(r.name))

        router = self

        class Handler(QuietHandler):
            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    payload = router.health_payload()
                    send_json(self, 200 if payload["ok"] else 503, payload)
                elif path == "/replicas":
                    send_json(self, 200, router.replica_states())
                elif path == "/metrics":
                    send_body(self, 200, reg.render().encode(),
                              PROM_CONTENT_TYPE)
                elif path == "/debug/dump":
                    send_json(self, 200,
                              router.flight_bundle("debug_dump"))
                else:
                    send_json(self, 404, {"error": "not found"})

            def do_POST(self):
                if urlparse(self.path).path != "/v1/generate":
                    send_json(self, 404, {"error": "not found"})
                    return
                if router._stop.is_set():
                    send_json(self, 503, {"error": "router stopped"})
                    return
                body = read_json_body(self)
                if body is None:
                    send_json(self, 400, {"error": "malformed JSON"})
                    return
                code, payload, served_by = router.route(
                    body, traceparent=self.headers.get("traceparent"),
                    deadline_ms=self.headers.get(DEADLINE_HEADER))
                # forward the replica's JSON verbatim, tagging which
                # backend actually served it (observability + tests)
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                if served_by is not None:
                    self.send_header("X-Served-By", served_by)
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True)

    # ------------------------------------------------------------- #
    # routing                                                        #
    # ------------------------------------------------------------- #

    @staticmethod
    def _prompt_tokens(body: dict) -> list[int]:
        """The prompt as affinity tokens; text prompts use the repo's
        byte-level convention (latin-1 per byte), mirroring the
        replica's own parsing so shadow tries match what replicas
        cache."""
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return list(prompt.encode("latin-1", errors="replace"))
        if isinstance(prompt, list):
            try:
                return [int(t) for t in prompt]
            except (TypeError, ValueError):
                return []
        return []

    def _pick(self, tokens, exclude: set[str]) -> tuple[_Replica, bool]:
        """Choose a healthy replica for ``tokens``; returns
        ``(replica, via_affinity)``. Raises ``_ReplicaDown`` when no
        healthy candidate remains."""
        with self._route_lock:
            avail = [
                r for r in self.replicas
                if r.healthy and not r.draining and not r.incompatible
                and r.name not in exclude
            ]
            # breaker-gated: closed breakers are the normal pool; when
            # it is empty, ONE due probe through an open breaker is
            # admitted (half-open) so a recovered replica proves
            # itself on real traffic. allow() consumes the probe, so
            # only ask when no closed-breaker replica remains.
            candidates = [r for r in avail if r.breaker.state == CLOSED]
            if not candidates:
                candidates = [r for r in avail if r.breaker.allow()]
            if not candidates:
                raise _ReplicaDown("no healthy replica")
            best, best_match = None, -1
            for r in candidates:
                m = r.shadow.longest_match(tokens)
                # ties go to the less-loaded replica so identical
                # shadows (e.g. empty) don't pile onto one backend
                if m > best_match or (
                    m == best_match and r.in_flight < best.in_flight
                ):
                    best, best_match = r, m
            if best_match >= self.affinity_min_match:
                chosen, via_affinity = best, True
            else:
                self._rr += 1
                lo = min(r.in_flight for r in candidates)
                tied = [r for r in candidates if r.in_flight == lo]
                chosen = tied[self._rr % len(tied)]
                via_affinity = False
            chosen.in_flight += 1
            chosen.routed += 1
            if via_affinity:
                chosen.affinity_routed += 1
            if tokens:
                chosen.shadow.insert(tokens)
            self._m_in_flight.set(
                float(chosen.in_flight), replica=chosen.name)
            return chosen, via_affinity

    def _forward(self, replica: _Replica, raw: bytes, headers: dict,
                 dl: Deadline | None = None) -> tuple[int, bytes]:
        """POST the raw body to the replica's generate endpoint.
        Transport failures and 503 (draining / dead engine) raise
        ``_ReplicaDown`` so the caller retries elsewhere. The socket
        timeout derives from the request's deadline budget."""
        conn = http.client.HTTPConnection(
            replica.host, replica.port,
            timeout=(dl.timeout(self.request_timeout_s)
                     if dl is not None else self.request_timeout_s))
        try:
            t0 = time.perf_counter()
            conn.request("POST", "/v1/generate", body=raw,
                         headers=headers)
            resp = conn.getresponse()
            # response headers landed: the replica produced its first
            # byte (see the histogram's help for what that means here)
            ttft = time.perf_counter() - t0
            payload = resp.read()
            if resp.status == 503:
                raise _ReplicaDown(f"{replica.name} answered 503")
            replica.breaker.record_success()
            self._h_ttft.observe(ttft, replica=replica.name)
            return resp.status, payload
        except (OSError, http.client.HTTPException) as e:
            raise _ReplicaDown(f"{replica.name}: {e}") from e
        finally:
            conn.close()

    def route(self, body: dict,
              traceparent: str | None = None,
              deadline_ms: str | None = None
              ) -> tuple[int, bytes, str | None]:
        """Route one generate request; returns
        ``(status, payload_bytes, replica_name | None)``. Retries on
        the remaining healthy replicas after transport-level failures
        (the failed replica never accepted the request). Generate
        forwards are never HEDGED — decoding is not idempotent; only
        retry-after-failure is safe.

        The caller's ``X-Deadline-Ms`` budget bounds every attempt's
        socket timeout and is re-forwarded (shrunken) downstream; an
        exhausted budget answers a clean 504 instead of piling retries.

        Trace context: the caller's ``traceparent`` is adopted (or a
        trace started), and every forward attempt — retries included —
        carries a fresh dispatch span id downstream, so the replica's
        admission span parents to the attempt that actually reached it.
        """
        import json

        self._m_requests.inc()
        ctx = parse_traceparent(traceparent)
        trace_id, parent_span = ctx if ctx else (new_trace_id(), "")
        dl = Deadline.from_header(deadline_ms,
                                  default_s=self.request_timeout_s)
        tokens = self._prompt_tokens(body)
        raw = json.dumps(body).encode()
        exclude: set[str] = set()
        t_req = time.perf_counter()
        attempt = 0
        try:
            while True:
                if dl.expired():
                    return 504, json.dumps(
                        {"error": "deadline exhausted",
                         "attempts": attempt}).encode(), None
                try:
                    replica, via_affinity = self._pick(tokens, exclude)
                except _ReplicaDown:
                    self._m_no_replica.inc()
                    self.flight.record("no_replica", trace_id=trace_id,
                                       attempts=attempt)
                    return 503, json.dumps(
                        {"error": "no healthy replica"}).encode(), None
                attempt += 1
                self._m_routed.inc(replica=replica.name)
                if via_affinity:
                    self._m_affinity.inc()
                span_id = new_span_id()
                headers = {
                    "Content-Type": "application/json",
                    "traceparent": format_traceparent(trace_id, span_id),
                    "X-Served-By": replica.name,
                    DEADLINE_HEADER: dl.header_value(),
                }
                if self.flight.enabled:
                    self.flight.record(
                        "dispatch", replica=replica.name,
                        attempt=attempt, trace_id=trace_id,
                        via_affinity=via_affinity)
                t_try = time.perf_counter()
                try:
                    status, payload = self._forward(
                        replica, raw, headers, dl)
                    self._trace_dispatch(
                        trace_id, span_id, parent_span, replica.name,
                        attempt, t_try, status=status)
                    return status, payload, replica.name
                except _ReplicaDown as e:
                    self._trace_dispatch(
                        trace_id, span_id, parent_span, replica.name,
                        attempt, t_try, error=str(e))
                    self._mark_unhealthy(replica, str(e))
                    with self._route_lock:
                        replica.retried_away += 1
                    self._m_retries.inc()
                    exclude.add(replica.name)
                    self.flight.record("retry", replica=replica.name,
                                       trace_id=trace_id, error=str(e))
                    log_event(_log, "router_retry",
                              replica=replica.name, error=str(e),
                              trace_id=trace_id)
                finally:
                    with self._route_lock:
                        replica.in_flight -= 1
                        self._m_in_flight.set(
                            float(replica.in_flight),
                            replica=replica.name)
        finally:
            self._h_e2e.observe(time.perf_counter() - t_req)

    def _trace_dispatch(self, trace_id: str, span_id: str,
                        parent_span: str, replica: str, attempt: int,
                        t0: float, **extra) -> None:
        """One dispatch span on the router track; ``span_id`` is the
        id this attempt injected downstream, which is what makes the
        replica's admission span our child in the merged view."""
        if not self.tracer.enabled:
            return
        args = {"trace_id": trace_id, "span_id": span_id,
                "replica": replica, "attempt": attempt, **extra}
        if parent_span:
            args["parent_span_id"] = parent_span
        self.tracer.span(ROUTER_TRACK, "dispatch", t0,
                         time.perf_counter() - t0, **args)

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
            log_event(_log, "router_breaker", replica=name,
                      old=old, new=new)
        return hook

    def _mark_unhealthy(self, replica: _Replica, why: str) -> None:
        replica.breaker.record_failure()
        with self._route_lock:
            note_access(f"router.{replica.name}.healthy", write=True)
            flipped = replica.healthy
            if flipped:
                replica.healthy = False
        if flipped:
            self._m_healthy.set(0.0, replica=replica.name)
            log_event(_log, "router_replica_down",
                      replica=replica.name, error=why)

    def _poll_one(self, replica: _Replica) -> None:
        conn = http.client.HTTPConnection(
            replica.host, replica.port,
            timeout=max(0.25, self.health_interval_s))
        try:
            import json

            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            raw = resp.read()
            try:
                replica.last_health = json.loads(raw)
            except ValueError:
                replica.last_health = None
            ok = resp.status == 200
        except (OSError, http.client.HTTPException):
            replica.last_health = None
            ok = False
        finally:
            conn.close()
        hp = (replica.last_health
              if isinstance(replica.last_health, dict) else None)
        if ok and hp is not None:
            # re-verify model identity on every successful poll: a
            # replica that restarted onto a different checkpoint comes
            # back ALIVE but must not silently rejoin the fleet — its
            # answers (and its KV segments) belong to another model
            cfg = hp.get("config_hash")
            if cfg:
                with self._route_lock:
                    note_access(
                        f"router.{replica.name}.config_hash", write=True)
                    if replica.config_hash is None:
                        replica.config_hash = str(cfg)
                        newly_bad = False
                    else:
                        newly_bad = (replica.config_hash != str(cfg)
                                     and not replica.incompatible)
                        if newly_bad:
                            replica.incompatible = True
                if newly_bad:
                    self._m_incompatible.set(1.0, replica=replica.name)
                    log_event(_log, "router_replica_incompatible",
                              replica=replica.name,
                              expected=replica.config_hash[:12],
                              got=str(cfg)[:12], level=logging.ERROR)
            draining = bool(hp.get("draining"))
            with self._route_lock:
                note_access(f"router.{replica.name}.draining", write=True)
                moved = draining != replica.draining
                if moved:
                    replica.draining = draining
            if moved:
                self._m_draining.set(float(draining), replica=replica.name)
                log_event(_log,
                          "router_replica_draining" if draining
                          else "router_replica_resumed",
                          replica=replica.name)
        if ok:
            with self._route_lock:
                note_access(f"router.{replica.name}.healthy", write=True)
                flipped = not replica.healthy
                if flipped:
                    replica.healthy = True
            if flipped:
                self._m_healthy.set(1.0, replica=replica.name)
                log_event(_log, "router_replica_up", replica=replica.name)
        else:
            self._mark_unhealthy(replica, "healthz poll failed")

    def poll_health(self) -> None:
        """One synchronous poll of every replica (tests use this to
        avoid sleeping for the background interval)."""
        for r in self.replicas:
            self._poll_one(r)

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            self.poll_health()
            self._stop.wait(self.health_interval_s)

    def health_payload(self) -> dict:
        with self._route_lock:
            healthy = [r.name for r in self.replicas if r.healthy]
            return {
                "ok": bool(healthy),
                "healthy": healthy,
                "replicas": {r.name: r.healthy for r in self.replicas},
            }

    def replica_states(self) -> dict:
        with self._route_lock:
            return {r.name: r.state() for r in self.replicas}

    # ------------------------------------------------------------- #
    # lifecycle                                                      #
    # ------------------------------------------------------------- #

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def name(self) -> str:
        return "%s:%d" % self.address

    # ------------------------------------------------------------- #
    # flight recorder                                                #
    # ------------------------------------------------------------- #

    def flight_bundle(self, reason: str) -> dict:
        """The router's postmortem: event ring + routing state + the
        trace tail (the router registry has no ``summary()``; replica
        states carry the equivalent signal)."""
        return self.flight.dump(
            reason, tracer=self.tracer,
            extra={"router": self.name,
                   "replicas": self.replica_states()})

    def _dump_flight(self, reason: str) -> None:
        if not self.flight_dir:
            return
        try:
            path = Path(self.flight_dir) / (
                "flight-router-%s-%s-%d.json" % (
                    self.name.replace(":", "-"), reason,
                    int(time.time() * 1000)))
            self.flight.dump_to(
                path, reason, tracer=self.tracer,
                extra={"router": self.name,
                       "replicas": self.replica_states()})
            log_event(_log, "flight_dump", reason=reason,
                      path=str(path))
        except Exception as e:
            log_event(_log, "flight_dump_failed", reason=reason,
                      error=repr(e), level=logging.ERROR)

    def start(self) -> "ReplicaRouter":
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
        dumps a flight bundle first (the orchestrator's kill is
        exactly when the postmortem is wanted), then stops."""
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
