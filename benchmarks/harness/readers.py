"""Arithmetic the per-layer readers share: a kernel's share of its
roofline from the device trace, and the device's idle share."""

from __future__ import annotations

from benchmarks import counts


def _tile_rows(name: str) -> int | None:
    for key in sorted(counts.FWD_TILE_ROWS, key=len, reverse=True):
        if key in name:
            return counts.FWD_TILE_ROWS[key]
    return None


def flash_fwd_roofline(rec: dict) -> float | None:
    """#1's launches in the traced window: each launch's bound from its
    grid (x = ceil(T / tile rows), y = B H) over their device time, in %."""
    tr = rec["trace"]
    if tr is None:
        return None
    d = rec["config"]["n_embd"] // rec["config"]["n_head"]
    bound = secs = 0.0
    for name, _, dur, grid in tr.kernels("flash_fwd"):
        rows = _tile_rows(name)
        if rows is None or len(grid) < 2:
            continue
        ops, nbytes = counts.flash_fwd(int(grid[1]), int(grid[0]) * rows, d)
        bound += counts.bound_s(ops, nbytes)
        secs += dur / 1e6
    return 100.0 * bound / secs if secs > 0 else None


def idle_share(rec: dict) -> float | None:
    tr = rec["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu_serve(rec: dict) -> float | None:
    w = rec["window"]
    if not w.get("model_flops") or w["seconds"] <= 0:
        return None
    return 100.0 * w["model_flops"] / w["seconds"] / counts.PEAKS["bf16_flops"]
