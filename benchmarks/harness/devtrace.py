"""The device trace of a traced run, reduced to what the readers take.

``torch.profiler`` records host and device activity over a few steps after
the window; its Chrome trace is read back for every device operation
(kernels, copies, sets) with its start, length and launch grid, and for
the harness's own spans. The traced window is the harness's ``bench.traced``
span, which ends after a synchronize, so every operation it launched lies
inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.traced"


@dataclass
class DeviceTrace:
    window_s: float
    #: (name, start us, length us, grid) of every device operation in the
    #: window, kernels and copies alike; grid is () for copies
    ops: list = field(default_factory=list)
    #: (name, start us, end us) of the harness's spans in the window
    spans: list = field(default_factory=list)
    #: (name, start us, end us) of the host's operators in the window
    cpu_ops: list = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    def kernels(self, substring: str = "") -> list:
        return [o for o in self.ops if o[3] and substring in o[0]]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d, _ in self.ops)
        out: list[list[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def top_ops(self, n: int = 10) -> list:
        tot: dict[str, float] = {}
        for name, _, dur, _ in self.ops:
            tot[name] = tot.get(name, 0.0) + dur / 1e6
        return [[k[:160], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time by what the host was doing: each gap between
        busy intervals named by the innermost harness span and the
        outermost host operator at its middle, summed by name."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        # top-level host operators do not overlap: keep them in order
        tops: list = []
        for name, a, b in sorted(self.cpu_ops, key=lambda x: (x[1], -x[2])):
            if not tops or a >= tops[-1][2]:
                tops.append((name, a, b))
        starts = [a for _, a, _ in tops]
        tot: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [s for s in self.spans if s[1] <= mid < s[2]]
            span = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "outside spans")
            k = bisect.bisect_right(starts, mid) - 1
            op = tops[k][0] if k >= 0 and mid < tops[k][2] else "python"
            key = f"{span} | {op}"
            tot[key] = tot.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def read_profile(prof) -> DeviceTrace:
    """Reduce a finished ``torch.profiler.profile`` to a DeviceTrace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    win = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    tr = DeviceTrace(window_s=(t1 - t0) / 1e6, t0=t0, t1=t1)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        if ts + dur < t0 or ts > t1:
            continue
        if cat in _DEVICE_CATS:
            # a kernel's grid (or (1,)); () marks a copy or a set
            grid = (tuple(e.get("args", {}).get("grid", ())) or (1,)
                    if cat == "kernel" else ())
            tr.ops.append((e["name"], ts, dur, grid))
        elif cat == "user_annotation" and e["name"] != WINDOW_SPAN:
            tr.spans.append((e["name"], ts, ts + dur))
        elif cat == "cpu_op":
            tr.cpu_ops.append((e["name"], ts, ts + dur))
    return tr
