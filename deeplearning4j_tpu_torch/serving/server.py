"""HTTP-JSON front end for the serving engine (port of
``deeplearning4j_tpu/serving/server.py``, trimmed to this slice).

Stdlib ``ThreadingHTTPServer`` plus one background thread running the
engine loop; handler threads block on the request's ``done`` event.

Endpoints:

- ``POST /v1/generate`` — body ``{"prompt": [ints] | "text", "max_new":
  int, "priority"?: int, "eos_token"?: int, "deadline_s"?: float}``;
  returns ``{"id", "tokens", "text"?, "timing"?}`` (text only for byte
  vocabularies, vocab <= 256). 429 on backpressure, 400 on a request that
  can never fit a slot, 503 while stopping or after the engine died, 408 /
  499 / 500 for expired / cancelled / failed requests, 504 when the
  handler times out (the request is cancelled in the engine).
- ``GET /healthz`` — 200 while the engine loop is alive, 503 once it died.
- ``GET /metrics`` — Prometheus text of the engine's metrics registry.

``stop(drain_s)`` stops admission, gives in-flight work up to ``drain_s``
seconds, cancels what is left, and shuts the listener down. An exception
escaping ``engine.step()`` kills the engine loop: every waiting request is
failed and ``/healthz`` turns 503 (crash replay is a later slice).
"""

from __future__ import annotations

import json
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
                 port: int = 0, request_timeout_s: float = 300.0):
        self.engine = engine
        self.request_timeout_s = request_timeout_s
        self._stop = threading.Event()
        self._draining = threading.Event()
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
                elif path == "/metrics":
                    _send(self, 200,
                          server.engine.metrics.render_prometheus().encode(),
                          PROM_CONTENT_TYPE)
                else:
                    _send_json(self, 404, {"error": "not found"})

            def do_POST(self):
                if urlparse(self.path).path != "/v1/generate":
                    _send_json(self, 404, {"error": "not found"})
                    return
                if server._draining.is_set() or server._stop.is_set():
                    _send_json(self, 503, {"error": "draining"})
                    return
                if server._dead.is_set():
                    _send_json(self, 503, {"error": "engine dead",
                                           "last_error": server.last_error})
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    _send_json(self, 400, {"error": "malformed JSON"})
                    return
                server._handle_generate(self, body)

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

    def _health(self) -> dict:
        alive = not self._dead.is_set() and (
            self._engine_thread.is_alive() or not self._engine_thread.ident)
        return {
            "ok": alive,
            "engine_alive": alive,
            "draining": self._draining.is_set(),
            "last_error": self.last_error,
            "queue_depth": len(self.engine.scheduler),
            "idle": self.engine.idle,
            "device": str(self.engine.device),
        }

    def _parse(self, body: dict) -> Request:
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
            priority=int(body.get("priority", 1)),
            eos_token=(int(body["eos_token"]) if "eos_token" in body
                       else None),
            deadline_s=(float(body["deadline_s"]) if "deadline_s" in body
                        else None),
            done=threading.Event(),
        )

    def _handle_generate(self, handler, body: dict) -> None:
        try:
            req = self._parse(body)
            self.engine.submit(req)
        except Backpressure as e:
            _send_json(handler, 429, {"error": str(e)})
            return
        except (AdmissionError, ValueError, TypeError) as e:
            _send_json(handler, 400, {"error": str(e)})
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
        if self._byte_vocab():
            out["text"] = bytes(t % 256 for t in toks).decode("latin-1")
        _send_json(handler, 200, out)

    def _engine_loop(self) -> None:
        while not self._stop.is_set():
            try:
                progressed = self.engine.step()
            except Exception as e:  # a dead engine must not hang callers
                self.last_error = f"{type(e).__name__}: {e}"
                traceback.print_exc()
                self._dead.set()
                self.engine.fail_all(f"engine dead: {self.last_error}")
                return
            if not progressed:
                if self._draining.is_set():
                    return
                time.sleep(0.002)

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
