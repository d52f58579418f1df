"""HTTP-JSON front end for the serving engine (port of
``deeplearning4j_tpu/serving/server.py``).

Stdlib ``ThreadingHTTPServer`` plus one background thread running the
engine loop; handler threads block on the request's ``done`` event, or,
with ``"stream": true``, relay tokens as SSE frames off the request's
stream queue (the tokens reach the host with each horizon's one readback:
streaming adds no device sync).

Multi-tenant mode: when the engine carries a
:class:`~.tenancy.TenantRegistry`, every POST resolves its API key
(``X-API-Key``, or ``Authorization: Bearer <key>``) to a tenant: an
unknown key gets 401, a missing key the registry's anonymous tenant (401
when it has none). The tenant supplies the default priority and LoRA
adapter, and its token-rate quota's exhaustion is a 429.

Endpoints:

- ``POST /v1/generate`` — body ``{"prompt": [ints] | "text", "max_new":
  int, "priority"?: int, "eos_token"?: int, "deadline_s"?: float,
  "adapter"?: int, "stream"?: bool}``, and on
  an engine with the sampling surface ``"temperature"``, ``"top_k"``,
  ``"top_p"``, ``"stop"`` (a string or a list of strings or token lists;
  strings only for byte vocabularies), ``"logit_bias"``, ``"logprobs"``,
  ``"top_logprobs"``, ``"response_format"``; returns ``{"id", "tokens",
  "text"?, "timing"?, "logprobs"?}`` (text only for byte vocabularies,
  vocab <= 256). 429 on backpressure or tenant quota, 400 on a request
  that can never fit a slot, names an adapter outside the LoRA bank or
  sets surface fields the engine does not serve, 401 on an unknown API
  key, 503 while draining, stopping or after the engine died, 408 /
  499 / 500 for expired / cancelled / failed requests, 504 when the
  handler times out (the request is cancelled in the engine). With
  ``"stream": true`` the answer is ``text/event-stream``: one ``data:
  {"token", "text"?}`` frame a generated token, then ``data: {"id",
  "status", "n_tokens", "done": true, "error"?, "logprobs"?}``; the
  streamed tokens, concatenated, are the non-streamed ``tokens`` tail
  byte for byte. A timeout sends ``{"error", "done": true}`` and cancels
  the request; a client that disconnects cancels it too (its slot frees
  within one horizon).
- ``POST /drain`` / ``POST /undrain`` — pause or resume admission without
  stopping the engine loop: new submits get 503 and ``/readyz`` 503 while
  in-flight and queued work finishes. Idempotent.
- ``GET /healthz`` — 200 while the engine loop is alive (recovering
  included), 503 once it died or while the watchdog finds it hung; the
  payload carries ``hung``, ``beat_age_s`` and ``restarts``.
- ``GET /readyz`` — 200 only when healthy and not draining (what a load
  balancer routes on).
- ``POST /v1/embeddings`` — body ``{"words": ["w", ...] | "w w ...",
  "model"?: "word2vec", "priority"?: int}``; returns ``{"id", "model",
  "vectors": {word: [floats] | null}}`` (null: out of vocabulary). The
  lookups ride the generation queue (priority, tenancy, quotas, drain) and
  are served on the host at the admission boundary, with no KV slot. 400
  on empty or non-string ``words``, 503 when the engine loaded no
  embedding model, 429 on backpressure, 504 on a timeout, 500 for an
  unknown model.
- ``GET /metrics`` — Prometheus text of the engine's metrics registry
  (with ``serve_engine_alive`` and ``serve_draining``). Also served, with
  the other observability GETs, on ``metrics_port`` when one is set: a
  scrape sidecar that keeps answering while generate traffic saturates
  the main listener.
- ``GET /metrics.json`` — ``ServingMetrics.summary()`` plus live engine
  state, the prefix cache's stats and the tenants' bucket levels.
- ``GET /debug/dump`` — the flight recorder's redacted postmortem bundle
  (recent engine events, a metrics snapshot, the trace's tail).
- ``POST /profile?s=N`` — arm a ``torch.profiler`` capture of the next N
  engine steps (the engine's :class:`~..obs.profiler.ProfileTrigger`);
  answers the capture's directory, 409 while a capture is armed, 400 for
  N < 1, 503 without a trigger.

The KV wire and live migration (frames in :mod:`.disagg`):

- ``POST /v1/prefill`` — body ``{"prompt", "push_to"?: "host:port",
  "idem_key"?, "priority"?, "adapter"?}``: prefill only; the segment is
  framed and, with ``push_to``, pushed to that replica's
  ``/v1/kv_segment`` under a ``transfer`` span (its outgoing
  ``traceparent`` names it). Answers ``{"id", "n_tokens", "nbytes",
  "config_hash", "pushed"?, "ingest"?}``, never the frame; a failed push
  is a 200 with ``"pushed": false`` (the caller prefills locally).
- ``POST /v1/kv_segment`` — a binary frame seated in the prefix cache;
  400/409 from the frame's checks, else 200 ``{"stored", "reason"}``; a
  repeated ``X-Idempotency-Key`` is 409 (hedged copies are seated once).
- ``POST /v1/kv_session`` — a frame with a live session's state (``gen``)
  seated mid-generation and decoded to the end here; 200 with the full
  token list, a soft 409 ``{"seated": false}`` on a decline, 400 without
  ``gen``.
- ``POST /migrate`` — body ``{"targets"?: [...]}`` (else
  ``migrate_targets``): every live session is exported on the engine loop
  and pushed to the first target that seats and completes it; its waiting
  caller gets the destination's tokens, and what cannot move retires
  CANCELLED with its partial tokens. Reachable while drained.
  ``stop(drain_s > 0)`` migrates to ``migrate_targets`` at the drain
  deadline before preempting.

``X-Deadline-Ms`` (the remaining budget a router or controller forwards)
caps every engine wait and shrinks on every outbound leg; ``/healthz``
carries the engine's ``config_hash``, which a router or controller reads
to mark a replica restarted onto another model incompatible.

Every request gets a W3C trace context: the caller's ``traceparent`` (its
trace id, and its span as our parent) or a fresh trace id. The engine's
admission span and log lines carry it, and each request ends with one
structured ``access`` log line (status, trace context, tenant, which
server answered).

``stop(drain_s)`` stops admission, gives in-flight work up to ``drain_s``
seconds, migrates (see above) and cancels what is left, and shuts the
listener down.

Supervision (the reference's ``_engine_loop``, server.py:1364): an
exception escaping ``engine.step()`` is recovered by
``engine.recover()`` (deterministic replay; waiting callers keep waiting
and get the uninterrupted stream). After ``max_restarts`` consecutive
crashes, or when recovery itself raises, the engine is dead: every waiting
request is failed and ``/healthz`` turns 503. The loop stamps a heartbeat
at every iteration; a loop whose beat is older than ``hang_threshold_s``
while the engine has work is reported hung (a thread can be alive but
wedged inside a device call).

Postmortems (``flight_dir``): the flight
bundle is written there on an engine crash (before recovery rebuilds the
state), when the engine dies, at the first watchdog trip that ``/healthz``
sees, and on SIGTERM under ``serve_forever``.
"""

from __future__ import annotations

import http.client
import json
import logging
import queue
import signal
import threading
import time
import traceback
from http.server import ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.obs.logs import log_event
from deeplearning4j_tpu_torch.obs.trace import (
    format_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
)
from deeplearning4j_tpu_torch.serving.disagg import (
    WireError,
    decode_segment,
    encode_segment,
)
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.serving.rpc import (
    DEADLINE_HEADER,
    IDEMPOTENCY_HEADER,
    Deadline,
    IdempotencyRegistry,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionError,
    Backpressure,
    EmbeddingRequest,
    KVExportRequest,
    KVIngestRequest,
    KVSessionRequest,
    Request,
    RequestStatus,
)
from deeplearning4j_tpu_torch.utils.httpjson import (
    QuietHandler,
    read_json_body,
    send_body,
    send_json,
)

_log = logging.getLogger(__name__)

#: the tenant of a request whose API key the registry does not know
_UNKNOWN_KEY = object()

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_STATUS_HTTP = {
    RequestStatus.FAILED: 500,
    RequestStatus.EXPIRED: 408,
    RequestStatus.CANCELLED: 499,
}


class ServingServer:
    """Engine + HTTP front end; ``start()`` does not block.
    ``metrics_port`` adds the scrape sidecar, ``flight_dir`` the
    postmortem directory; ``profile`` (a ``ProfileTrigger``) is handed to
    the engine, whose steps it brackets; ``migrate_targets`` (host:port)
    are where a drain or ``POST /migrate`` moves live sessions."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 300.0,
                 max_restarts: int = 5, hang_threshold_s: float = 120.0,
                 metrics_port: int | None = None,
                 flight_dir: str | None = None, profile=None,
                 migrate_targets: tuple[str, ...] = ()):
        self.engine = engine
        # where live sessions go at the drain deadline (and on a POST
        # /migrate with no targets), tried in order before preemption
        self.migrate_targets = tuple(migrate_targets)
        # receiver-side dedup of hedged or retried seat and ingest legs:
        # a repeated X-Idempotency-Key is declined with 409
        self._idem = IdempotencyRegistry()
        # one-slot mailbox for session export: /migrate posts {"evt": ...}
        # and the engine loop (the only thread that touches slot and
        # device state) fills in "sessions" between steps; the loop takes
        # the box under _box_lock, so a poster that gives up knows whether
        # an export (which parks sessions) ran
        self._migrate_box: dict | None = None  # guarded-by: _box_lock
        self._box_lock = threading.Lock()
        self._migrate_lock = threading.Lock()
        if profile is not None:
            engine.profile = profile
        self.request_timeout_s = request_timeout_s
        self.max_restarts = max_restarts
        self.hang_threshold_s = hang_threshold_s
        self.flight_dir = flight_dir
        self._hang_dumped = False
        # watchdog heartbeat: stamped at the top of every loop iteration
        self._last_beat: float | None = None
        self._stop = threading.Event()
        self._draining = threading.Event()
        # admission pause by POST /drain: unlike stop()'s drain the loop
        # keeps running, and /undrain resumes
        self._paused = threading.Event()
        self._dead = threading.Event()
        self.last_error: str | None = None
        # supervisor state on the engine's registry: one scrape carries both
        reg = engine.metrics.registry
        reg.gauge("serve_engine_alive",
                  "1 while the supervised engine loop is considered live."
                  ).set_function(lambda: float(self._health()["ok"]))
        reg.gauge("serve_draining", "1 while the server is draining."
                  ).set_function(lambda: float(
                      self._draining.is_set() or self._paused.is_set()))
        server = self

        class Handler(QuietHandler):
            def do_GET(self):
                if not server._common_get(self):
                    send_json(self, 404, {"error": "not found"})

            def do_POST(self):
                path = urlparse(self.path).path
                if path == "/profile":
                    server._handle_profile(self)
                    return
                if path in ("/drain", "/undrain"):
                    server._handle_drain(self, path == "/drain")
                    return
                if path == "/migrate":
                    # reachable while paused: a controller drains a
                    # replica first, then asks it to migrate what is left
                    server._handle_migrate(self)
                    return
                if path not in ("/v1/generate", "/v1/embeddings",
                                "/v1/kv_segment", "/v1/prefill",
                                "/v1/kv_session"):
                    send_json(self, 404, {"error": "not found"})
                    return
                if (server._draining.is_set() or server._paused.is_set()
                        or server._stop.is_set()):
                    send_json(self, 503, {"error": "draining"})
                    return
                if server._dead.is_set():
                    send_json(self, 503, {"error": "engine dead",
                                           "last_error": server.last_error})
                    return
                tenant = server._resolve_tenant(self)
                if tenant is _UNKNOWN_KEY:
                    send_json(self, 401, {"error": "unknown API key"})
                    return
                if path == "/v1/kv_segment":  # a binary wire frame
                    server._handle_kv_segment(self, tenant)
                    return
                if path == "/v1/kv_session":  # a frame with session state
                    server._handle_kv_session(self, tenant)
                    return
                body = read_json_body(self)
                if body is None:
                    send_json(self, 400, {"error": "malformed JSON"})
                    return
                if path == "/v1/embeddings":
                    server._handle_embeddings(self, body, tenant)
                elif path == "/v1/prefill":
                    server._handle_prefill(self, body, tenant)
                else:
                    server._handle_generate(self, body, tenant)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        # what the access log names as the server that answered
        self.name = "%s:%d" % self._httpd.server_address[:2]
        self._engine_thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="engine-loop")
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-serve")
        # the scrape sidecar: the observability GETs on their own port
        self._metrics_httpd = None
        self._metrics_thread = None
        if metrics_port is not None:

            class MetricsHandler(QuietHandler):
                def do_GET(self):
                    if not server._common_get(self):
                        send_json(self, 404, {"error": "not found"})

            self._metrics_httpd = ThreadingHTTPServer((host, metrics_port),
                                                      MetricsHandler)
            self._metrics_thread = threading.Thread(
                target=self._metrics_httpd.serve_forever, daemon=True,
                name="metrics-serve")

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def metrics_address(self) -> tuple[str, int] | None:
        """(host, port) of the metrics sidecar, or None without one."""
        if self._metrics_httpd is None:
            return None
        return self._metrics_httpd.server_address[:2]

    def _common_get(self, handler) -> bool:
        """The observability GETs, served on the main listener and on the
        sidecar; False for an unknown path."""
        path = urlparse(handler.path).path
        if path == "/healthz":
            payload = self._health()
            send_json(handler, 200 if payload["ok"] else 503, payload)
        elif path == "/readyz":
            payload = self._health()
            ready = payload["ok"] and not payload["draining"]
            payload["ready"] = ready
            send_json(handler, 200 if ready else 503, payload)
        elif path == "/metrics":
            send_body(handler, 200,
                  self.engine.metrics.render_prometheus().encode(),
                  PROM_CONTENT_TYPE)
        elif path == "/metrics.json":
            send_json(handler, 200, self._metrics_payload())
        elif path == "/debug/dump":
            send_json(handler, 200, self.flight_bundle("debug_dump"))
        else:
            return False
        return True

    def flight_bundle(self, reason: str) -> dict:
        """The flight recorder's redacted postmortem bundle: recent engine
        events, a metrics snapshot and the trace's tail."""
        return self.engine.flight.dump(
            reason, metrics=self.engine.metrics, tracer=self.engine.tracer,
            extra={"server": self.name, "health": self._health()})

    def _dump_flight(self, reason: str) -> None:
        """Write the bundle into ``flight_dir`` (nothing without one; never
        raises: this runs on crash paths)."""
        if not self.flight_dir:
            return
        try:
            path = Path(self.flight_dir) / (
                "flight-%s-%s-%d.json" % (self.name.replace(":", "-"),
                                          reason, int(time.time() * 1000)))
            self.engine.flight.dump_to(
                path, reason, metrics=self.engine.metrics,
                tracer=self.engine.tracer,
                extra={"server": self.name, "last_error": self.last_error})
            log_event(_log, "flight_dump", reason=reason, path=str(path))
        except Exception as e:
            log_event(_log, "flight_dump_failed", level=logging.ERROR,
                      reason=reason, error=repr(e))

    def _handle_profile(self, handler) -> None:
        """``POST /profile?s=N``: arm a capture of the next N engine
        steps."""
        trigger = self.engine.profile
        if trigger is None:
            send_json(handler, 503, {
                "error": "no ProfileTrigger configured (start the server "
                         "with profiling wired)"})
            return
        qs = parse_qs(urlparse(handler.path).query)
        try:
            n = int(qs.get("s", ["1"])[0])
            if n < 1:
                raise ValueError
        except ValueError:
            send_json(handler, 400, {"error": "s must be an int >= 1"})
            return
        try:
            capture_dir = trigger.arm(n)
        except RuntimeError as e:  # a capture is armed already
            send_json(handler, 409, {"error": str(e)})
            return
        log_event(_log, "profile_armed", steps=n, dir=str(capture_dir))
        send_json(handler, 200, {"armed": n, "dir": str(capture_dir)})

    def _byte_vocab(self) -> bool:
        return self.engine.cfg.vocab_size <= 256

    def _hung(self, now: float | None = None) -> tuple[bool, float | None]:
        """(hung?, beat age in s): the loop thread is alive but its
        heartbeat is older than ``hang_threshold_s`` while the engine has
        work (an idle loop beats at every sleep poll)."""
        if self._last_beat is None:
            return False, None
        age = (now if now is not None else time.monotonic()) - self._last_beat
        hung = (age > self.hang_threshold_s
                and self._engine_thread.is_alive()
                and not self._stop.is_set()
                and not self.engine.idle)
        return hung, age

    def _health(self) -> dict:
        alive = not self._dead.is_set() and (
            self._engine_thread.is_alive() or not self._engine_thread.ident)
        hung, beat_age = self._hung()
        if hung:
            alive = False  # wedged in a device call counts as not live
            if not self._hang_dumped:
                # the wedged loop cannot dump itself: the probe that sees
                # the trip does, once
                self._hang_dumped = True
                self._dump_flight("watchdog_hang")
        return {
            "ok": alive,
            "engine_alive": alive,
            "hung": hung,
            "beat_age_s": beat_age,
            "hang_threshold_s": self.hang_threshold_s,
            "draining": self._draining.is_set() or self._paused.is_set(),
            "last_error": self.last_error,
            "restarts": self.engine.metrics.n_restarts,
            # fleet fields: a router or controller routes on them (a
            # replica restarted onto another model shows a new hash)
            "config_hash": self.engine.config_hash,
            # a controller sends no shorter prompt over the KV wire
            "hit_grain": self.engine.hit_grain,
            "queue_depth": len(self.engine.scheduler),
            "idle": self.engine.idle,
            "device": str(self.engine.device),
        }

    def _metrics_payload(self) -> dict:
        """``/metrics.json``: the metrics summary and live engine state,
        with the prefix cache's stats and the tenants' bucket levels."""
        eng = self.engine
        out = eng.metrics.summary()
        out.update(
            n_slots=eng.n_slots,
            slots_active=eng.pool.n_active,
            queue_depth=len(eng.scheduler),
            draining=self._draining.is_set() or self._paused.is_set(),
            engine_alive=(self._engine_thread.is_alive()
                          and not self._dead.is_set()),
            last_error=self.last_error,
        )
        if eng.prefix_cache is not None:
            out["prefix_cache"] = eng.prefix_cache.stats()
        if eng.tenancy is not None:
            buckets = {}
            for tid in eng.tenancy.tenant_ids():
                lvl = eng.tenancy.bucket_level(tid)
                if lvl is not None:
                    buckets[tid] = round(lvl, 1)
            out["tenancy"] = {"n_tenants": len(eng.tenancy),
                              "bucket_levels": buckets}
        return out

    def _handle_drain(self, handler, draining: bool) -> None:
        """``POST /drain`` / ``POST /undrain``: pause or resume admission,
        the engine loop running on (idempotent both ways)."""
        if draining:
            self._paused.set()
        else:
            self._paused.clear()
        send_json(handler, 200, {
            "draining": self._paused.is_set(),
            "in_flight": self.engine.pool.n_active,
            "queued": len(self.engine.scheduler),
        })

    def _resolve_tenant(self, handler):
        """The request's tenant by its API key (``X-API-Key``, or
        ``Authorization: Bearer <key>``): None without tenancy,
        ``_UNKNOWN_KEY`` for a key the registry does not know (and for no
        key when it has no anonymous tenant)."""
        tenancy = self.engine.tenancy
        if tenancy is None:
            return None
        key = handler.headers.get("X-API-Key")
        if not key:
            auth = handler.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                key = auth[len("Bearer "):]
        t = tenancy.resolve_key(key)
        return _UNKNOWN_KEY if t is None else t

    def _parse(self, body: dict, tenant=None) -> Request:
        """The request of a body; the tenant supplies the priority and the
        LoRA adapter unless the body names its own."""
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if not self._byte_vocab():
                raise ValueError(
                    "text prompts need a byte-level model (vocab <= 256)")
            prompt = list(prompt.encode("latin-1", errors="replace"))
        if not isinstance(prompt, list):
            raise ValueError("'prompt' must be a token list or a string")
        return Request(
            prompt=[int(t) for t in prompt],
            max_new=int(body.get("max_new", 16)),
            temperature=(float(body["temperature"]) if "temperature" in body
                         else None),
            top_k=int(body["top_k"]) if "top_k" in body else None,
            top_p=float(body["top_p"]) if "top_p" in body else None,
            stop=self._parse_stop(body.get("stop")),
            logit_bias=body.get("logit_bias"),
            logprobs=bool(body.get("logprobs", False)),
            top_logprobs=int(body.get("top_logprobs", 0)),
            response_format=body.get("response_format"),
            priority=int(body.get(
                "priority", tenant.priority if tenant is not None else 1)),
            eos_token=(int(body["eos_token"]) if "eos_token" in body
                       else None),
            deadline_s=(float(body["deadline_s"]) if "deadline_s" in body
                        else None),
            adapter=int(body.get(
                "adapter",
                tenant.default_adapter if tenant is not None else 0)),
            tenant_id=tenant.tenant_id if tenant is not None else "",
            stream=queue.Queue() if body.get("stream") else None,
            done=threading.Event(),
        )

    def _parse_stop(self, stop) -> list[list[int]] | None:
        """``stop`` as token lists: a string or a list of strings (byte
        vocabularies only) or token lists."""
        if stop is None:
            return None
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list):
            raise ValueError("'stop' must be a string or a list of "
                             "strings/token lists")
        out = []
        for s in stop:
            if isinstance(s, str):
                if not self._byte_vocab():
                    raise ValueError("string stop sequences need a "
                                     "byte-level model (vocab <= 256)")
                s = list(s.encode("latin-1", errors="replace"))
            if not isinstance(s, list) or not s:
                raise ValueError("each stop sequence must be a non-empty "
                                 "string or token list")
            out.append([int(t) for t in s])
        return out

    @staticmethod
    def _resolve_trace(handler, req: Request) -> None:
        """W3C trace context: adopt the caller's ``traceparent`` (its trace
        id, its span as our parent) or start a fresh trace, so the access
        log and the engine's admission span always correlate."""
        ctx = parse_traceparent(handler.headers.get("traceparent"))
        if ctx is not None:
            req.trace_id, req.parent_span_id = ctx
        else:
            req.trace_id = new_trace_id()

    def _deadline(self, handler) -> Deadline:
        """The request's budget: the caller's ``X-Deadline-Ms`` (a router
        or controller shrinks it on every hop), else the server's request
        timeout. Every engine wait and outbound leg below takes its
        timeout from it."""
        return Deadline.from_header(handler.headers.get(DEADLINE_HEADER),
                                    default_s=self.request_timeout_s)

    def _access_log(self, handler, req, http: int, status: str,
                    **fields) -> None:
        """The one structured access line a request: trace context,
        tenant, and which server answered (``X-Served-By`` when a router
        set it)."""
        log_event(_log, "access", req_id=req.id, http=http, status=status,
                  trace_id=req.trace_id or None,
                  parent_span_id=req.parent_span_id or None,
                  tenant=req.tenant_id or None,
                  served_by=handler.headers.get("X-Served-By") or self.name,
                  **fields)

    def _completed(self, handler, req, http: int, status: str,
                   **fields) -> None:
        """``request_completed`` and the access line."""
        log_event(_log, "request_completed", req_id=req.id, http=http,
                  status=status, trace_id=req.trace_id or None, **fields)
        self._access_log(handler, req, http, status, **fields)

    def _handle_generate(self, handler, body: dict, tenant=None) -> None:
        try:
            req = self._parse(body, tenant)
        except (AdmissionError, ValueError, TypeError) as e:
            send_json(handler, 400, {"error": str(e)})
            return
        self._resolve_trace(handler, req)
        dl = self._deadline(handler)
        if req.deadline_s is None and handler.headers.get(DEADLINE_HEADER):
            # the wire budget becomes the engine-side expiry: a queued
            # request whose budget lapsed retires EXPIRED
            req.deadline_s = dl.remaining_s()
        try:
            self.engine.submit(req)
        except Backpressure as e:
            self._access_log(handler, req, 429, "backpressure")
            send_json(handler, 429, {"error": str(e)})
            return
        except (AdmissionError, ValueError, TypeError) as e:
            self._access_log(handler, req, 400, "admission_error")
            send_json(handler, 400, {"error": str(e)})
            return
        wait_s = dl.timeout(self.request_timeout_s, floor=0.0)
        if req.stream is not None:
            self._stream_generate(handler, req, wait_s)
            return
        if not req.done.wait(wait_s):
            req.cancel()  # the slot stops decoding for a gone client
            self._completed(handler, req, 504, "timeout")
            send_json(handler, 504, {"error": "generation timed out"})
            return
        if req.status is not RequestStatus.FINISHED:
            self.engine.pop_result(req.id)
            code = _STATUS_HTTP.get(req.status, 500)
            self._completed(handler, req, code, req.status.value)
            send_json(handler, code, {
                "id": req.id, "status": req.status.value,
                "error": req.error or req.status.value,
            })
            return
        toks = self.engine.pop_result(req.id).tolist()
        self._completed(handler, req, 200, "finished",
                        n_tokens=len(toks) - len(req.prompt))
        out = {"id": req.id, "tokens": toks}
        if req.timing is not None:
            out["timing"] = {k: round(float(v), 6)
                             for k, v in req.timing.items()}
        if req.logprobs and req.logprobs_out is not None:
            out["logprobs"] = req.logprobs_out
        if self._byte_vocab():
            out["text"] = bytes(t % 256 for t in toks).decode("latin-1")
        send_json(handler, 200, out)

    @staticmethod
    def _sse(handler, payload: dict) -> None:
        """One SSE ``data:`` frame, flushed."""
        handler.wfile.write(b"data: " + json.dumps(payload).encode()
                            + b"\n\n")
        handler.wfile.flush()

    def _stream_generate(self, handler, req: Request, wait_s: float) -> None:
        """SSE relay: a frame for each token as it lands on
        ``req.stream``, then a final frame with the terminal status (the
        engine sets it before the end-of-stream sentinel). A timeout
        cancels the request; so does a client that disconnects."""
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        deadline = time.monotonic() + wait_s
        byte_vocab = self._byte_vocab()
        n = 0
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    req.cancel()
                    self._completed(handler, req, 504, "timeout",
                                    stream=True)
                    self._sse(handler, {"error": "generation timed out",
                                        "done": True})
                    return
                try:
                    tok = req.stream.get(timeout=min(remaining, 1.0))
                except queue.Empty:
                    continue  # still decoding: check the deadline again
                if tok is None:
                    break  # the end-of-stream sentinel
                n += 1
                frame = {"token": int(tok)}
                if byte_vocab:
                    frame["text"] = chr(tok % 256)
                self._sse(handler, frame)
            final = {"id": req.id, "status": req.status.value,
                     "n_tokens": n, "done": True}
            if req.status is not RequestStatus.FINISHED and req.error:
                final["error"] = req.error
            if req.logprobs and req.logprobs_out is not None:
                final["logprobs"] = req.logprobs_out
            self._sse(handler, final)
            self._completed(handler, req, 200, req.status.value, n_tokens=n,
                            stream=True)
        except (BrokenPipeError, ConnectionResetError):
            req.cancel()  # the client is gone: free its slot
            self._completed(handler, req, 499, "client_gone", n_tokens=n,
                            stream=True)
        finally:
            # the stream delivered the tokens: drop the stored copy
            self.engine.pop_result(req.id)

    def _handle_embeddings(self, handler, body: dict, tenant=None) -> None:
        """``POST /v1/embeddings`` (the reference's, server.py:698)."""
        words = body.get("words")
        if isinstance(words, str):
            words = words.split()
        if (not isinstance(words, list) or not words
                or not all(isinstance(w, str) for w in words)):
            send_json(handler, 400, {
                "error": "'words' must be a non-empty list of strings"})
            return
        if not self.engine.embedders:
            send_json(handler, 503, {"error": "no embedding models loaded"})
            return
        try:
            req = EmbeddingRequest(
                words=tuple(words), model=str(body.get("model", "word2vec")),
                priority=int(body.get(
                    "priority", tenant.priority if tenant is not None
                    else 1)),
                tenant_id=tenant.tenant_id if tenant is not None else "",
                done=threading.Event())
        except (AdmissionError, ValueError, TypeError) as e:
            send_json(handler, 400, {"error": str(e)})
            return
        self._resolve_trace(handler, req)
        try:
            self.engine.submit(req)
        except Backpressure as e:
            self._access_log(handler, req, 429, "backpressure",
                             kind="embedding")
            send_json(handler, 429, {"error": str(e)})
            return
        except AdmissionError as e:
            self._access_log(handler, req, 400, "admission_error",
                             kind="embedding")
            send_json(handler, 400, {"error": str(e)})
            return
        if not req.done.wait(self.request_timeout_s):
            req.cancel()
            self._completed(handler, req, 504, "timeout", kind="embedding")
            send_json(handler, 504, {"error": "embedding timed out"})
            return
        if req.status is not RequestStatus.FINISHED:
            code = _STATUS_HTTP.get(req.status, 500)
            self._completed(handler, req, code, req.status.value,
                            kind="embedding")
            send_json(handler, code, {
                "id": req.id, "status": req.status.value,
                "error": req.error or req.status.value})
            return
        vectors = {w: (None if v is None else [float(x) for x in v])
                   for w, v in req.result.items()}
        self._completed(handler, req, 200, "finished", kind="embedding",
                        n_words=len(words))
        send_json(handler, 200, {"id": req.id, "model": req.model,
                                  "vectors": vectors})

    # -- the KV wire --------------------------------------------------------

    def _read_frame(self, handler, what: str):
        """The binary frame of a wire POST, decoded against this engine's
        config hash; None after answering 400 or the frame's
        ``WireError.status`` (409 for another model)."""
        try:
            length = int(handler.headers.get("Content-Length", "0"))
            data = handler.rfile.read(length)
        except (ValueError, OSError):
            send_json(handler, 400, {"error": "unreadable body"})
            return None
        try:
            return decode_segment(data, expect_hash=self.engine.config_hash)
        except WireError as e:
            log_event(_log, f"{what}_rejected", error=str(e), http=e.status,
                      nbytes=len(data))
            send_json(handler, e.status, {"error": str(e)})
            return None

    def _submit_and_wait(self, handler, req, kind: str,
                         dl: Deadline) -> bool:
        """Submit a wire request and wait for it within the budget; False
        after answering 429, 400 or 504."""
        self._resolve_trace(handler, req)
        try:
            self.engine.submit(req)
        except Backpressure as e:
            self._access_log(handler, req, 429, "backpressure", kind=kind)
            send_json(handler, 429, {"error": str(e)})
            return False
        except AdmissionError as e:
            self._access_log(handler, req, 400, "admission_error", kind=kind)
            send_json(handler, 400, {"error": str(e)})
            return False
        if not req.done.wait(dl.timeout(self.request_timeout_s, floor=0.0)):
            req.cancel()
            self._access_log(handler, req, 504, "timeout", kind=kind)
            send_json(handler, 504, {"error": f"{kind} timed out"})
            return False
        return True

    def _answer_unfinished(self, handler, req, kind: str) -> None:
        code = _STATUS_HTTP.get(req.status, 500)
        self.engine.pop_result(req.id)
        self._access_log(handler, req, code, req.status.value, kind=kind)
        send_json(handler, code, {"id": req.id, "status": req.status.value,
                                  "error": req.error or req.status.value})

    def _tenant_fields(self, tenant) -> dict:
        return {"priority": tenant.priority if tenant is not None else 1,
                "tenant_id": tenant.tenant_id if tenant is not None else ""}

    def _handle_kv_segment(self, handler, tenant) -> None:
        """``POST /v1/kv_segment`` (the reference's, server.py:790): seat
        one binary KV-segment frame in the prefix cache through the
        engine's admission loop. 400/409 from the frame's checks;
        otherwise 200 with ``{"stored", "reason"}`` (a decline is no
        error). A repeated ``X-Idempotency-Key`` (a hedged copy) is 409."""
        dl = self._deadline(handler)
        idem = handler.headers.get(IDEMPOTENCY_HEADER, "")
        if not self._idem.first_seen(idem):
            log_event(_log, "kv_segment_duplicate", idem_key=idem)
            send_json(handler, 409, {"error": "duplicate frame",
                                     "duplicate": True, "stored": False})
            return
        seg = self._read_frame(handler, "kv_segment")
        if seg is None:
            return
        req = KVIngestRequest(segment=seg, done=threading.Event(),
                              **self._tenant_fields(tenant))
        if not self._submit_and_wait(handler, req, "kv_ingest", dl):
            return
        if req.status is not RequestStatus.FINISHED:
            self._answer_unfinished(handler, req, "kv_ingest")
            return
        self._access_log(handler, req, 200, "finished", kind="kv_ingest",
                         stored=bool(req.result.get("stored")))
        send_json(handler, 200, {"id": req.id, **req.result})

    def _handle_kv_session(self, handler, tenant) -> None:
        """``POST /v1/kv_session`` (the reference's, server.py:859): seat
        one live migrated session (a frame whose ``gen`` block carries the
        tokens so far, the key words and the budget) and decode it to the
        end here. 200 answers the full token sequence; a seating decline
        is a soft 409 (the sender keeps its fallback); a repeated
        idempotency key is 409 with ``"duplicate": true``."""
        dl = self._deadline(handler)
        idem = handler.headers.get(IDEMPOTENCY_HEADER, "")
        if not self._idem.first_seen(idem):
            log_event(_log, "kv_session_duplicate", idem_key=idem)
            send_json(handler, 409, {"error": "duplicate session frame",
                                     "duplicate": True})
            return
        seg = self._read_frame(handler, "kv_session")
        if seg is None:
            return
        gen = seg.get("gen")
        if not isinstance(gen, dict):
            send_json(handler, 400, {
                "error": "frame carries no session state ('gen' header)"})
            return
        try:
            n_prompt = int(gen["n_prompt"])
            req = KVSessionRequest(
                prompt=[int(t) for t in seg["tokens"][:n_prompt]],
                max_new=int(gen["max_new"]),
                eos_token=(None if gen.get("eos_token") is None
                           else int(gen["eos_token"])),
                adapter=int(gen.get("adapter", 0)),
                segment=seg,
                gen_tokens=tuple(int(t) for t in gen.get("tokens", ())),
                key_data=np.asarray(gen.get("key_data", ()), np.int64),
                done=threading.Event(), **self._tenant_fields(tenant))
        except (AdmissionError, KeyError, TypeError, ValueError) as e:
            send_json(handler, 400, {
                "error": f"bad session state: {type(e).__name__}: {e}"})
            return
        if not self._submit_and_wait(handler, req, "kv_session", dl):
            return
        if (req.status is RequestStatus.FAILED
                and isinstance(req.result, dict)
                and not req.result.get("seated", True)):
            # the engine cannot continue it byte for byte: the sender
            # keeps the session on its own fallback
            self._access_log(handler, req, 409, "declined",
                             kind="kv_session",
                             reason=req.result.get("reason"))
            send_json(handler, 409, {
                "id": req.id, "seated": False,
                "reason": req.result.get("reason"),
                "error": req.error or "session declined"})
            return
        if req.status is not RequestStatus.FINISHED:
            self._answer_unfinished(handler, req, "kv_session")
            return
        toks = self.engine.pop_result(req.id).tolist()
        self._access_log(handler, req, 200, "finished", kind="kv_session",
                         n_tokens=len(toks) - len(req.prompt))
        send_json(handler, 200, {"id": req.id, "status": "finished",
                                 "tokens": toks,
                                 "n_generated": len(toks) - len(req.prompt)})

    def _handle_prefill(self, handler, body: dict, tenant) -> None:
        """``POST /v1/prefill`` (the reference's, server.py:968):
        prefill-only. The prompt's KV rows are framed for the wire and,
        with ``"push_to": "host:port"``, pushed to that decode replica's
        ``/v1/kv_segment`` (``idem_key`` rides as its idempotency key).
        Answers the frame's metadata, never the frame; a failed push is a
        200 with ``"pushed": false``, and the caller prefills locally."""
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if not self._byte_vocab():
                send_json(handler, 400, {
                    "error": "text prompts need a byte-level model "
                             "(vocab <= 256)"})
                return
            prompt = list(prompt.encode("latin-1", errors="replace"))
        if not isinstance(prompt, list) or not prompt:
            send_json(handler, 400, {
                "error": "'prompt' must be a non-empty token list or a "
                         "string"})
            return
        try:
            req = KVExportRequest(
                prompt=[int(t) for t in prompt],
                priority=int(body.get(
                    "priority", tenant.priority if tenant is not None
                    else 1)),
                adapter=int(body.get(
                    "adapter", tenant.default_adapter if tenant is not None
                    else 0)),
                tenant_id=tenant.tenant_id if tenant is not None else "",
                done=threading.Event())
        except (AdmissionError, TypeError, ValueError) as e:
            send_json(handler, 400, {"error": str(e)})
            return
        dl = self._deadline(handler)
        if not self._submit_and_wait(handler, req, "kv_export", dl):
            return
        if req.status is not RequestStatus.FINISHED:
            self._answer_unfinished(handler, req, "kv_export")
            return
        res = req.result
        frame = encode_segment(
            config_hash=res["config_hash"], tokens=res["tokens"],
            leaves=res["leaves"], logits=res["logits"],
            layout=res["layout"], block_size=res["block_size"])
        out = {"id": req.id, "n_tokens": len(req.prompt),
               "nbytes": len(frame), "config_hash": res["config_hash"]}
        push_to = body.get("push_to")
        if push_to:
            pushed, info = self._push_segment(
                str(push_to), frame, req, res.get("span_id"),
                idem_key=str(body.get("idem_key") or ""), deadline=dl)
            out["pushed"] = pushed
            if info:
                out["ingest"] = info
        self._access_log(handler, req, 200, "finished", kind="kv_export",
                         n_tokens=len(req.prompt), nbytes=len(frame))
        send_json(handler, 200, out)

    def _post_frame(self, target: str, path: str, frame: bytes, req,
                    span_id: str, idem_key: str, deadline: Deadline | None,
                    timeout_s: float) -> tuple[int, dict, str | None]:
        """POST a frame to ``target`` (host:port) with the idempotency key,
        the remaining budget and a ``traceparent`` naming ``span_id``;
        ``(http status or 0, JSON answer, transport error or None)``."""
        host, _, port = target.rpartition(":")
        try:
            conn = http.client.HTTPConnection(
                host or "127.0.0.1", int(port),
                timeout=(deadline.timeout(self.request_timeout_s)
                         if deadline is not None else timeout_s))
            headers = {"Content-Type": "application/octet-stream"}
            if idem_key:
                headers[IDEMPOTENCY_HEADER] = idem_key
            if deadline is not None:
                headers[DEADLINE_HEADER] = deadline.header_value()
            if req.trace_id:
                headers["traceparent"] = format_traceparent(req.trace_id,
                                                            span_id)
            try:
                conn.request("POST", path, body=frame, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException) as e:
            return 0, {}, repr(e)
        try:
            info = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            info = {}
        return resp.status, info if isinstance(info, dict) else {}, None

    def _push_segment(self, target: str, frame: bytes, req,
                      parent_span: str | None, *, idem_key: str = "",
                      deadline: Deadline | None = None) -> tuple[bool, dict]:
        """POST the frame to ``target``'s ``/v1/kv_segment``; ``(ok, the
        ingest answer)``. A ``transfer`` span (the outgoing
        ``traceparent`` names it as the ingest's parent) and the transfer
        metrics are recorded either way."""
        t0 = time.perf_counter()
        span_id = new_span_id()
        status, info, err = self._post_frame(
            target, "/v1/kv_segment", frame, req, span_id, idem_key,
            deadline, min(30.0, self.request_timeout_s))
        ok = status == 200 and bool(info.get("stored"))
        if err is None and status != 200:
            err = "http %d: %s" % (status, info.get("error"))
        dt = time.perf_counter() - t0
        self.engine.metrics.record_transfer(len(frame), dt, ok=ok)
        tctx = {}
        if self.engine.tracer.enabled and req.trace_id:
            tctx = {"trace_id": req.trace_id, "span_id": span_id}
            if parent_span:
                tctx["parent_span_id"] = parent_span
        self.engine.tracer.span("transfer", "transfer", t0, dt,
                                target=target, nbytes=len(frame), ok=ok,
                                **tctx)
        log_event(_log, "kv_transfer", target=target, nbytes=len(frame),
                  ok=ok, seconds=round(dt, 6), error=err,
                  stored=bool(info.get("stored")))
        if err:
            info = dict(info)
            info["error"] = err
        return ok, info

    # -- live session migration ---------------------------------------------

    def _handle_migrate(self, handler) -> None:
        """``POST /migrate`` (the reference's, server.py:1126): export every
        live session and seat each on one of ``{"targets": ["host:port",
        ...]}`` (else ``migrate_targets``), completing the original
        requests with the destination's tokens. What cannot move stays on
        the ordinary drain path."""
        body = read_json_body(handler)
        if body is None:
            body = {}
        targets = body.get("targets") or list(self.migrate_targets)
        if not isinstance(targets, (list, tuple)):
            send_json(handler, 400, {"error": "'targets' must be a list"})
            return
        res = self._migrate_sessions([str(t) for t in targets],
                                     self._deadline(handler))
        send_json(handler, 200 if "error" not in res else 503, res)

    def _migrate_sessions(self, targets: list[str],
                          deadline: Deadline | None = None) -> dict:
        """Export the live sessions on the engine loop and push each to the
        first target that seats and completes it; the rest retire
        CANCELLED with their partial tokens. Serialized: concurrent
        ``/migrate`` posts and ``stop()`` share one mailbox."""
        targets = [t for t in targets if t]
        out = {"targets": list(targets), "exported": 0, "migrated": 0,
               "failed": 0}
        if not targets:
            out["error"] = "no migration targets"
            return out
        with self._migrate_lock:
            if not self._engine_thread.is_alive() or self._dead.is_set():
                out["error"] = "engine not running"
                return out
            evt = threading.Event()
            box: dict = {"evt": evt}
            with self._box_lock:
                self._migrate_box = box
            t_end = time.monotonic() + (deadline.timeout(30.0)
                                        if deadline is not None else 30.0)
            # the loop exits once drained and idle: poll its liveness
            while not evt.is_set() and time.monotonic() < t_end:
                if (not self._engine_thread.is_alive()
                        or self._dead.is_set()):
                    break
                evt.wait(0.05)
            if not evt.is_set():
                with self._box_lock:
                    taken = self._migrate_box is not box
                    self._migrate_box = None
                if not taken:
                    out["error"] = "engine loop unavailable for export"
                    return out
                # the loop took the box and is exporting: the export is
                # bounded (one horizon's readback and a host copy a slot),
                # and what it parks must be settled, or its callers wait
                # for tokens nobody will send
                while not evt.wait(0.05):
                    if not self._engine_thread.is_alive():
                        break
                sessions = box.get("sessions") or []
                for sess in sessions:
                    self.engine.fail_migrated(
                        sess["req"], "migration deadline expired during "
                        "the export", partial=sess["gen"]["tokens"])
                out["exported"] = out["failed"] = len(sessions)
                out["error"] = "deadline expired during the export"
                return out
            if "error" in box:
                out["error"] = box["error"]
                return out
            sessions = box.get("sessions") or []
            out["exported"] = len(sessions)
            for sess in sessions:
                ok, info = self._push_session(sess, targets, deadline)
                if ok:
                    self.engine.complete_migrated(
                        sess["req"], info["tokens"],
                        n_streamed=sess["n_streamed"])
                    out["migrated"] += 1
                else:
                    self.engine.fail_migrated(
                        sess["req"],
                        info.get("error") or "migration push failed",
                        partial=sess["gen"]["tokens"])
                    out["failed"] += 1
        log_event(_log, "migrate", exported=out["exported"],
                  migrated=out["migrated"], failed=out["failed"],
                  n_targets=len(targets), error=out.get("error"))
        return out

    def _push_session(self, sess: dict, targets: list[str],
                      deadline: Deadline | None = None) -> tuple[bool, dict]:
        """POST one exported session's frame to each target's
        ``/v1/kv_session`` until one seats and completes it (the
        idempotency key is the request id's, so a retry racing a slow
        earlier attempt is declined, never seated twice); ``(ok, answer)``
        with the full token list when ok."""
        req = sess["req"]
        frame = encode_segment(
            config_hash=sess["config_hash"], tokens=sess["tokens"],
            leaves=sess["leaves"], logits=sess["logits"],
            layout=sess["layout"], block_size=sess["block_size"],
            gen=sess["gen"])
        last: dict = {}
        for target in targets:
            t0 = time.perf_counter()
            span_id = new_span_id()
            status, info, err = self._post_frame(
                target, "/v1/kv_session", frame, req, span_id,
                "mig-" + req.id, deadline, self.request_timeout_s)
            dt = time.perf_counter() - t0
            ok = (err is None and status == 200
                  and info.get("status") == "finished"
                  and isinstance(info.get("tokens"), list))
            if err is None and not ok:
                err = "http %d: %s" % (status,
                                       info.get("reason") or info.get("error"))
            if self.engine.tracer.enabled and req.trace_id:
                self.engine.tracer.span(
                    "migrate_push", "transfer", t0, dt, target=target,
                    nbytes=len(frame), ok=ok, trace_id=req.trace_id,
                    span_id=span_id)
            self.engine.flight.record("migrate_push", req_id=req.id,
                                      target=target, ok=ok,
                                      http=status or None, error=err)
            log_event(_log, "session_migrate_push", req_id=req.id,
                      target=target, nbytes=len(frame), ok=ok,
                      seconds=round(dt, 6), error=err)
            if ok:
                return True, info
            last = dict(info)
            last["error"] = err
        return False, last

    def _engine_loop(self) -> None:
        consecutive = 0
        while not self._stop.is_set():
            self._last_beat = time.monotonic()
            box = None
            if self._migrate_box is not None:  # lint: lock-ok peek, swapped under the lock
                with self._box_lock:
                    box, self._migrate_box = self._migrate_box, None
            if box is not None:
                # between steps every slot is quiescent: the export runs
                # on this thread, which owns the slot and device state
                try:
                    box["sessions"] = self.engine.export_sessions()
                except Exception as e:
                    box["error"] = f"{type(e).__name__}: {e}"
                box["evt"].set()
            try:
                progressed = self.engine.step()
                consecutive = 0
            except Exception as e:  # EngineCrash or an engine bug
                self.last_error = f"{type(e).__name__}: {e}"
                traceback.print_exc()
                consecutive += 1
                # before recover(): the last look at the crashed state
                self._dump_flight("engine_crash")
                if consecutive > self.max_restarts:
                    self._die()
                    return
                try:
                    self.engine.recover()
                except Exception as e2:  # recovery itself is broken
                    self.last_error = (f"recover failed: "
                                       f"{type(e2).__name__}: {e2}")
                    traceback.print_exc()
                    self._die()
                    return
                continue
            if not progressed:
                if self._draining.is_set():
                    return
                time.sleep(0.002)

    def _die(self) -> None:
        """Unrecoverable: mark the engine dead and fail every waiting
        caller (a dead engine must not hang them)."""
        self._dead.set()
        self._dump_flight("engine_dead")
        try:
            self.engine.fail_all(f"engine dead: {self.last_error}")
        except Exception:
            traceback.print_exc()  # state may be corrupt; handlers time out

    def start(self) -> "ServingServer":
        self._engine_thread.start()
        self._http_thread.start()
        if self._metrics_thread is not None:
            self._metrics_thread.start()
        return self

    def stop(self, drain_s: float = 0.0) -> None:
        """Stop admission, drain for up to ``drain_s`` seconds, migrate the
        live sessions to ``migrate_targets`` (when set and ``drain_s`` >
        0), cancel the stragglers, then shut down."""
        self._draining.set()
        deadline = time.monotonic() + drain_s
        while (time.monotonic() < deadline
               and self._engine_thread.is_alive()
               and not self.engine.idle):
            time.sleep(0.005)
        if (drain_s > 0 and self.migrate_targets
                and self._engine_thread.is_alive()
                and not self._dead.is_set() and not self.engine.idle):
            # live sessions at the deadline move to another replica first;
            # preemption below gets what migration could not seat
            try:
                self._migrate_sessions(list(self.migrate_targets))
            except Exception as e:
                log_event(_log, "migrate_on_stop_failed",
                          error=f"{type(e).__name__}: {e}")
        if self._engine_thread.is_alive() and not self.engine.idle:
            self.engine.preempt_all()
            grace = time.monotonic() + 1.0
            while (time.monotonic() < grace
                   and self._engine_thread.is_alive()
                   and not self.engine.idle):
                time.sleep(0.005)
        self._stop.set()
        if self._engine_thread.ident:
            self._engine_thread.join(timeout=10)
        if not self._dead.is_set() and not self.engine.idle:
            self.engine.fail_all("server stopped before completion")
        if self._http_thread.ident:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._metrics_httpd is not None:
            if self._metrics_thread.ident:
                self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()

    def serve_forever(self, drain_s: float = 0.0, on_start=None) -> None:
        """Blocking convenience for the CLI; Ctrl-C and SIGTERM drain for
        ``drain_s`` seconds and exit (SIGTERM writes a flight bundle
        first). ``on_start`` is called once the server listens."""
        self.start()
        if on_start is not None:
            on_start()
        done = threading.Event()

        def on_sigterm(signum, frame):
            self._dump_flight("sigterm")
            done.set()

        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass  # not the main thread: Ctrl-C still works
        try:
            while not done.is_set():
                time.sleep(1)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop(drain_s)
