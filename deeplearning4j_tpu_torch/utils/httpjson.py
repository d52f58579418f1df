"""Shared plumbing for the port's stdlib HTTP servers (the serving
server, the router and the fleet controller; a copy of
``deeplearning4j_tpu/utils/httpjson.py``): one place for response framing
and request-log silencing."""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler


def send_body(handler: BaseHTTPRequestHandler, code: int, body: bytes,
              content_type: str) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def send_json(handler: BaseHTTPRequestHandler, code: int,
              payload=None) -> None:
    send_body(
        handler, code,
        json.dumps(payload if payload is not None else {}).encode(),
        "application/json",
    )


def read_json_body(handler: BaseHTTPRequestHandler):
    """Parse the request body as JSON; returns None on malformed input
    (callers answer 400)."""
    n = int(handler.headers.get("Content-Length", 0))
    try:
        return json.loads(handler.rfile.read(n) or b"{}")
    except json.JSONDecodeError:
        return None


class QuietHandler(BaseHTTPRequestHandler):
    """BaseHTTPRequestHandler with request logging silenced."""

    def log_message(self, *a):  # noqa: D102
        pass
