"""Metrics writer + timing listener.

≙ SURVEY §5 observability: replaces the reference's scattered slf4j
logging + dropwizard resources with a structured scalar writer (JSONL —
greppable, plottable, no extra deps) and an optimizer listener that
records score/step-time series.

The port's copy of ``deeplearning4j_tpu/utils/metrics.py``, over the
port's ``optimize/api.py`` listener interface.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from deeplearning4j_tpu_torch.optimize.api import IterationListener


class MetricsWriter:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def scalar(self, tag: str, value: float, step: int | None = None) -> None:
        rec = {"tag": tag, "value": float(value), "time": time.time()}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def read(path: str | Path) -> list[dict]:
        out = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    out.append(json.loads(line))
        return out


class MetricsIterationListener(IterationListener):
    """Streams optimizer scores + inter-iteration wall time to a writer."""

    def __init__(self, writer: MetricsWriter, prefix: str = "train"):
        self.writer = writer
        self.prefix = prefix
        self._last: float | None = None

    def iteration_done(self, info: dict) -> None:
        now = time.perf_counter()
        step = info["iteration"]
        self.writer.scalar(f"{self.prefix}/score", info["score"], step)
        if self._last is not None:
            self.writer.scalar(f"{self.prefix}/step_seconds", now - self._last, step)
        self._last = now
