"""Metrics registry (the port's own copy of ``deeplearning4j_tpu/obs/
registry.py``): counters, gauges, bounded histograms, Prometheus
text exposition, and a fixed-size reservoir sampler.

The scrape model is Prometheus's: instruments accumulate in-process,
and ``MetricsRegistry.render()`` serializes the current state in the
text exposition format (version 0.0.4) that a fleet scraper ingests —
the serving server mounts it at ``GET /metrics``. Everything is
bounded by construction: counters/gauges are O(label-sets), histograms
hold a fixed bucket vector per label-set, and the
:class:`Reservoir` keeps a fixed-size uniform sample of an unbounded
series (exact n/total/min/max, sampled percentiles) — so a month of
traffic costs the same memory as a minute.

Label support is the minimal production subset: an instrument is
created with ``labelnames`` and each operation passes the label
*values* as keyword args (``counter.inc(outcome="finished")``).
Metric/label names are validated against the Prometheus grammar at
creation so a typo fails at wiring time, not at scrape time.

Thread-safety: instrument updates AND reads take a per-instrument
lock (the serving engine thread and HTTP handler threads both record
while the metrics sidecar scrapes): a scrape straddling an update is
fine under Prometheus semantics, but an unlocked read iterating the
label-set dict while a first-time label set inserts is not — that is a
"dict changed size during iteration" crash in the scrape handler.
Readers snapshot under the lock and render outside it, so gauge
callbacks (which reach into pool/scheduler state behind their own
locks) never run with an instrument lock held.
"""

from __future__ import annotations

import math
import random
import re
import threading


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (seconds): 100µs .. 30s, roughly 1-2-5
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers bare, +Inf spelled."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (
        str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')
    )


def _labelset(labelnames: tuple, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared "
            f"labelnames {sorted(labelnames)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


def _render_labels(labelnames: tuple, values: tuple,
                   extra: list[tuple[str, str]] = ()) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, values)
    ]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _header(self) -> list[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]


class Counter(_Instrument):
    """Monotonically increasing count (per label-set)."""

    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: dict[tuple, float] = {}  # guarded-by: _lock

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _labelset(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labelset(self.labelnames, labels), 0.0)

    def render(self) -> list[str]:
        out = self._header()
        with self._lock:
            values = dict(self._values)
        values = values or ({(): 0.0} if not self.labelnames else {})
        for key in sorted(values):
            out.append(
                f"{self.name}{_render_labels(self.labelnames, key)} "
                f"{_fmt(values[key])}"
            )
        return out


class Gauge(_Instrument):
    """Point-in-time value; either ``set()`` explicitly or bind a
    callback with ``set_function`` so scrapes read live state (queue
    depth, slot occupancy) without the hot path updating anything."""

    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: dict[tuple, float] = {}  # guarded-by: _lock
        self._fn = None

    def set(self, value: float, **labels) -> None:
        key = _labelset(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labelset(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_function(self, fn) -> "Gauge":
        """Bind a zero-arg callable evaluated at render time (only for
        unlabelled gauges)."""
        if self.labelnames:
            raise ValueError("callback gauges cannot be labelled")
        self._fn = fn
        return self

    def value(self, **labels) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._values.get(_labelset(self.labelnames, labels), 0.0)

    def render(self) -> list[str]:
        out = self._header()
        if self._fn is not None:
            # callback path: evaluated with NO lock held — callbacks
            # read pool/scheduler state behind their own locks
            try:
                v = float(self._fn())
            except Exception:
                v = math.nan  # a dead callback must not kill the scrape
            out.append(f"{self.name} {_fmt(v)}")
            return out
        with self._lock:
            values = dict(self._values)
        values = values or ({(): 0.0} if not self.labelnames else {})
        for key in sorted(values):
            out.append(
                f"{self.name}{_render_labels(self.labelnames, key)} "
                f"{_fmt(values[key])}"
            )
        return out


class Histogram(_Instrument):
    """Fixed-bucket cumulative histogram (per label-set): bounded
    memory no matter how many observations, Prometheus-queryable via
    ``histogram_quantile`` over the ``_bucket`` series."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("need at least one bucket bound")
        self.buckets = bs
        # +1 count slot for +Inf; guarded-by: _lock
        self._counts: dict[tuple, list[int]] = {}  # guarded-by: _lock
        self._sum: dict[tuple, float] = {}  # guarded-by: _lock

    def observe(self, value: float, **labels) -> None:
        key = _labelset(self.labelnames, labels)
        v = float(value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sum[key] = 0.0
            # linear probe: bucket vectors are short (<= ~20) and the
            # serving latencies concentrate in the first few bounds
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sum[key] += v

    def count(self, **labels) -> int:
        key = _labelset(self.labelnames, labels)
        with self._lock:
            return sum(self._counts.get(key, ()))

    def render(self) -> list[str]:
        out = self._header()
        with self._lock:
            counts = {k: list(v) for k, v in self._counts.items()}
            sums = dict(self._sum)
        counts = counts or (
            {(): [0] * (len(self.buckets) + 1)} if not self.labelnames
            else {}
        )
        for key in sorted(counts):
            cum = 0
            for b, c in zip(self.buckets, counts[key]):
                cum += c
                lbl = _render_labels(
                    self.labelnames, key, extra=[("le", _fmt(b))]
                )
                out.append(f"{self.name}_bucket{lbl} {cum}")
            cum += counts[key][-1]
            lbl = _render_labels(self.labelnames, key, extra=[("le", "+Inf")])
            out.append(f"{self.name}_bucket{lbl} {cum}")
            plain = _render_labels(self.labelnames, key)
            out.append(
                f"{self.name}_sum{plain} {_fmt(sums.get(key, 0.0))}"
            )
            out.append(f"{self.name}_count{plain} {cum}")
        return out


class MetricsRegistry:
    """Instrument namespace + Prometheus text renderer. ``counter`` /
    ``gauge`` / ``histogram`` are get-or-create, so independent
    subsystems can wire the same metric without coordination (a kind
    mismatch on an existing name raises — that is a bug, not a race)."""

    def __init__(self):
        self._instruments: dict[str, _Instrument] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(
                    name, help, labelnames, **kw
                )
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}"
                )
            return inst

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name) -> _Instrument | None:
        with self._lock:
            return self._instruments.get(name)

    def render(self) -> str:
        """The whole registry in Prometheus text exposition format.
        The instrument list is snapshotted under the registry lock and
        rendered outside it (per-instrument locks and gauge callbacks
        must not nest under it)."""
        with self._lock:
            insts = [self._instruments[n]
                     for n in sorted(self._instruments)]
        lines = []
        for inst in insts:
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"


class Reservoir:
    """Fixed-size uniform sample of an unbounded series (Vitter's
    Algorithm R) with EXACT ``n``/``total``/``min``/``max``.

    This is what bounds ``ServingMetrics``' latency series: a
    long-running engine keeps percentile summaries over a statistically
    uniform ``cap``-size sample instead of an ever-growing list, while
    the aggregates stay exact. Seeded, so tests replay the same sample.
    Supports ``append`` and iteration so it drops into list-shaped
    call sites."""

    def __init__(self, cap: int = 2048, seed: int = 0):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self._rng = random.Random(seed)
        self._vals: list[float] = []
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._vals) < self.cap:
            self._vals.append(x)
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self._vals[j] = x

    append = add  # list-compatible call sites

    @property
    def values(self) -> list[float]:
        """The current sample (length ``min(n, cap)``)."""
        return list(self._vals)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(self._vals)

    def __repr__(self):
        return (f"Reservoir(n={self.n}, cap={self.cap}, "
                f"mean={self.mean:.6g})")
