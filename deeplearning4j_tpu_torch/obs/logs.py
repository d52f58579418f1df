"""Structured JSON logging with request-id correlation (the port's own
copy of ``deeplearning4j_tpu/obs/logs.py``).

One JSON object per line on the configured stream, machine-parseable
and greppable by the same field names the tracer and metrics use —
``req_id`` is the correlation key: a request's scheduler submit, engine
admission, retirement and HTTP completion all log it, so
``grep '"req_id": "req-17"'`` reconstructs one request's path through
every subsystem, and the same id appears in the trace spans' args.

Emitters use stdlib ``logging`` with structured fields in ``extra``::

    log.info("request_admitted", extra={"req_id": r.id, "slot": 3})

which costs nothing until a handler is attached (the engine's loggers
default to the root WARNING level). ``configure_json_logging`` attaches
the JSON handler to the package logger — the ``--log-json`` serve flag
calls it; tests point it at a ``StringIO``.
"""

from __future__ import annotations

import json
import logging
import sys
import time

#: LogRecord attributes that are plumbing, not structured fields
_RESERVED = frozenset(
    logging.LogRecord(
        "", 0, "", 0, "", (), None
    ).__dict__
) | {"message", "asctime", "taskName"}


class JsonLogFormatter(logging.Formatter):
    """One JSON object per record: ``ts`` (epoch seconds), ``level``,
    ``logger``, ``event`` (the message), plus every ``extra`` field."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": record.getMessage(),
        }
        for k, v in record.__dict__.items():
            if k not in _RESERVED and not k.startswith("_"):
                out[k] = v
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def configure_json_logging(
    level: int = logging.INFO,
    stream=None,
    logger: str = "deeplearning4j_tpu_torch",
) -> logging.Handler:
    """Attach a JSON-lines handler to ``logger`` (the package root by
    default) and set its level. Returns the handler so callers (tests,
    shutdown paths) can detach it with ``logging.getLogger(logger)
    .removeHandler(handler)``."""
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonLogFormatter())
    lg = logging.getLogger(logger)
    lg.addHandler(handler)
    lg.setLevel(level)
    return handler


def log_event(log: logging.Logger, event: str, *,
              level: int = logging.INFO, **fields) -> None:
    """Structured emit helper: ``log_event(log, "engine_crash",
    restarts=2)``. Skips all work when the level is disabled."""
    if log.isEnabledFor(level):
        fields.setdefault("t_mono", round(time.perf_counter(), 6))
        log.log(level, event, extra=fields)
