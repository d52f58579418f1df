"""Time per output token after the first, p95 over the window's requests:
(last token - first token) / (tokens - 1) on the host clock. A request
refused or failed is infinite: the line then leaves the metric out, and
the run's ``failed`` counts it."""

import math

from benchmarks.harness.core import percentile


def read(rec):
    vals = rec["window"].get("tpot_s")
    if not vals:
        return None
    p = percentile(vals, 95)
    return p * 1e3 if math.isfinite(p) else None
