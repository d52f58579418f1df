"""Tracing / profiling (the port's version of
``deeplearning4j_tpu/utils/profiling.py``).

The reference has no structured tracing — only StopWatch logging in the
YARN worker (WorkerNode.java:39-75) and per-iteration score logs
(BaseOptimizer.java:160). This module gives a host-side StopWatch and
``timed``, ``trace`` (``torch.profiler`` with CUDA activity when a card is
present, written as a Chrome trace that Perfetto opens) and ``annotate``
(a named range in those traces: ``record_function``, plus an NVTX range on
the card).
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path


class StopWatch:
    """≙ commons StopWatch usage in WorkerNode: wall-clock segments."""

    def __init__(self):
        self._start: float | None = None
        self.total = 0.0
        self.laps: list[float] = []

    def start(self) -> "StopWatch":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        assert self._start is not None, "not started"
        lap = time.perf_counter() - self._start
        self.laps.append(lap)
        self.total += lap
        self._start = None
        return lap

    @contextlib.contextmanager
    def lap(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile a code region with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write its Chrome trace to
    ``log_dir/trace.json`` (default: a fresh directory under the system's
    temporary directory). Yields the profiler; its ``trace_path``
    attribute names the file once the region ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir) if log_dir is not None else Path(
        tempfile.mkdtemp(prefix="dl4j_torch_trace_"))
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_path = str(out / "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in profiler traces: a
    ``record_function`` range, and an NVTX range when a card is present
    (what Nsight tools show)."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Host-side timing context; sink(label, seconds) or print."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink:
            sink(label, dt)
        else:
            print(f"[timing] {label}: {dt:.4f}s")
