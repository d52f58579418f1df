"""Time to first token, p95 over the window's requests: from the request's
due time (a backlog's request: when it joined the queue) to its first
token on the host. A request refused or failed is infinite: the line then
leaves the metric out, and the run's ``failed`` counts it."""

import math

from benchmarks.harness.core import percentile


def read(rec):
    vals = rec["window"].get("ttft_s")
    if not vals:
        return None
    p = percentile(vals, 95)
    return p * 1e3 if math.isfinite(p) else None
