"""HTTP-JSON front end for the serving engine (port of
``deeplearning4j_tpu/serving/server.py``, trimmed to this slice).

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
- ``GET /metrics`` — Prometheus text of the engine's metrics registry.
- ``GET /metrics.json`` — ``ServingMetrics.summary()`` plus live engine
  state, the prefix cache's stats and the tenants' bucket levels.

``stop(drain_s)`` stops admission, gives in-flight work up to ``drain_s``
seconds, cancels what is left, and shuts the listener down.

Supervision (the reference's ``_engine_loop``, server.py:1364): an
exception escaping ``engine.step()`` is recovered by
``engine.recover()`` (deterministic replay; waiting callers keep waiting
and get the uninterrupted stream). After ``max_restarts`` consecutive
crashes, or when recovery itself raises, the engine is dead: every waiting
request is failed and ``/healthz`` turns 503. The loop stamps a heartbeat
at every iteration; a loop whose beat is older than ``hang_threshold_s``
while the engine has work is reported hung (a thread can be alive but
wedged inside a device call).
"""

from __future__ import annotations

import json
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionError,
    Backpressure,
    Request,
    RequestStatus,
)

#: the tenant of a request whose API key the registry does not know
_UNKNOWN_KEY = object()

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_STATUS_HTTP = {
    RequestStatus.FAILED: 500,
    RequestStatus.EXPIRED: 408,
    RequestStatus.CANCELLED: 499,
}


def _send(handler, code: int, body: bytes, content_type: str) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _send_json(handler, code: int, payload) -> None:
    _send(handler, code, json.dumps(payload).encode(), "application/json")


class ServingServer:
    """Engine + HTTP front end; ``start()`` does not block."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 300.0,
                 max_restarts: int = 5, hang_threshold_s: float = 120.0):
        self.engine = engine
        self.request_timeout_s = request_timeout_s
        self.max_restarts = max_restarts
        self.hang_threshold_s = hang_threshold_s
        # watchdog heartbeat: stamped at the top of every loop iteration
        self._last_beat: float | None = None
        self._stop = threading.Event()
        self._draining = threading.Event()
        # admission pause by POST /drain: unlike stop()'s drain the loop
        # keeps running, and /undrain resumes
        self._paused = threading.Event()
        self._dead = threading.Event()
        self.last_error: str | None = None
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    payload = server._health()
                    _send_json(self, 200 if payload["ok"] else 503, payload)
                elif path == "/readyz":
                    payload = server._health()
                    ready = payload["ok"] and not payload["draining"]
                    payload["ready"] = ready
                    _send_json(self, 200 if ready else 503, payload)
                elif path == "/metrics":
                    _send(self, 200,
                          server.engine.metrics.render_prometheus().encode(),
                          PROM_CONTENT_TYPE)
                elif path == "/metrics.json":
                    _send_json(self, 200, server._metrics_payload())
                else:
                    _send_json(self, 404, {"error": "not found"})

            def do_POST(self):
                path = urlparse(self.path).path
                if path in ("/drain", "/undrain"):
                    server._handle_drain(self, path == "/drain")
                    return
                if path != "/v1/generate":
                    _send_json(self, 404, {"error": "not found"})
                    return
                if (server._draining.is_set() or server._paused.is_set()
                        or server._stop.is_set()):
                    _send_json(self, 503, {"error": "draining"})
                    return
                if server._dead.is_set():
                    _send_json(self, 503, {"error": "engine dead",
                                           "last_error": server.last_error})
                    return
                tenant = server._resolve_tenant(self)
                if tenant is _UNKNOWN_KEY:
                    _send_json(self, 401, {"error": "unknown API key"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    _send_json(self, 400, {"error": "malformed JSON"})
                    return
                server._handle_generate(self, body, tenant)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._engine_thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="engine-loop")
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-serve")

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

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
        return {
            "ok": alive,
            "engine_alive": alive,
            "hung": hung,
            "beat_age_s": beat_age,
            "hang_threshold_s": self.hang_threshold_s,
            "draining": self._draining.is_set() or self._paused.is_set(),
            "last_error": self.last_error,
            "restarts": self.engine.metrics.n_restarts,
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
        _send_json(handler, 200, {
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

    def _handle_generate(self, handler, body: dict, tenant=None) -> None:
        try:
            req = self._parse(body, tenant)
            self.engine.submit(req)
        except Backpressure as e:
            _send_json(handler, 429, {"error": str(e)})
            return
        except (AdmissionError, ValueError, TypeError) as e:
            _send_json(handler, 400, {"error": str(e)})
            return
        if req.stream is not None:
            self._stream_generate(handler, req)
            return
        if not req.done.wait(self.request_timeout_s):
            req.cancel()  # the slot stops decoding for a gone client
            _send_json(handler, 504, {"error": "generation timed out"})
            return
        if req.status is not RequestStatus.FINISHED:
            self.engine.pop_result(req.id)
            _send_json(handler, _STATUS_HTTP.get(req.status, 500), {
                "id": req.id, "status": req.status.value,
                "error": req.error or req.status.value,
            })
            return
        toks = self.engine.pop_result(req.id).tolist()
        out = {"id": req.id, "tokens": toks}
        if req.timing is not None:
            out["timing"] = {k: round(float(v), 6)
                             for k, v in req.timing.items()}
        if req.logprobs and req.logprobs_out is not None:
            out["logprobs"] = req.logprobs_out
        if self._byte_vocab():
            out["text"] = bytes(t % 256 for t in toks).decode("latin-1")
        _send_json(handler, 200, out)

    @staticmethod
    def _sse(handler, payload: dict) -> None:
        """One SSE ``data:`` frame, flushed."""
        handler.wfile.write(b"data: " + json.dumps(payload).encode()
                            + b"\n\n")
        handler.wfile.flush()

    def _stream_generate(self, handler, req: Request) -> None:
        """SSE relay: a frame for each token as it lands on
        ``req.stream``, then a final frame with the terminal status (the
        engine sets it before the end-of-stream sentinel). A timeout
        cancels the request; so does a client that disconnects."""
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        deadline = time.monotonic() + self.request_timeout_s
        byte_vocab = self._byte_vocab()
        n = 0
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    req.cancel()
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
        except (BrokenPipeError, ConnectionResetError):
            req.cancel()  # the client is gone: free its slot
        finally:
            # the stream delivered the tokens: drop the stored copy
            self.engine.pop_result(req.id)

    def _engine_loop(self) -> None:
        consecutive = 0
        while not self._stop.is_set():
            self._last_beat = time.monotonic()
            try:
                progressed = self.engine.step()
                consecutive = 0
            except Exception as e:  # EngineCrash or an engine bug
                self.last_error = f"{type(e).__name__}: {e}"
                traceback.print_exc()
                consecutive += 1
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
        try:
            self.engine.fail_all(f"engine dead: {self.last_error}")
        except Exception:
            traceback.print_exc()  # state may be corrupt; handlers time out

    def start(self) -> "ServingServer":
        self._engine_thread.start()
        self._http_thread.start()
        return self

    def stop(self, drain_s: float = 0.0) -> None:
        """Stop admission, drain for up to ``drain_s`` seconds, cancel the
        stragglers, then shut down."""
        self._draining.set()
        deadline = time.monotonic() + drain_s
        while (time.monotonic() < deadline
               and self._engine_thread.is_alive()
               and not self.engine.idle):
            time.sleep(0.005)
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

    def serve_forever(self, drain_s: float = 0.0) -> None:
        """Blocking convenience for the CLI; Ctrl-C drains and exits."""
        self.start()
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop(drain_s)
