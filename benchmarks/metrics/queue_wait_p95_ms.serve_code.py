"""Due time to seat, p95 over the window's requests: the submit's delay
after the due time plus the engine's "queued" span (submit to seat)."""

from benchmarks.harness.core import percentile


def read(rec):
    waits = rec["window"].get("queue_wait_s")
    if not waits:
        return None
    return percentile(waits, 95) * 1e3
