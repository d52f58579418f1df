"""What every cell shares: finding a cell's files by name, the card check,
the JSON result line, the module check and the harness's own spans.

A cell is found by its name alone: ``BENCHMARK.json`` names it, and
``workloads/<cell>.json``, ``configs/<config>.json`` and
``traffic/<traffic>.json`` hold what it runs. A later cell adds files and
an entry and edits none of these.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"

#: modules no process of the benchmark may hold (top-level names, whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


def fix_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its kernels into ``deeplearning4j_tpu_torch/_build``
    on its own; these cover what PyTorch and Triton would write."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, seconds since the harness
    loaded."""
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry, its own file, its
    configuration and its traffic, each found by name. Raises KeyError for
    a name ``BENCHMARK.json`` does not list."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    bench = root / "benchmarks"
    cfg_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    return {
        "entry": entry,
        "cell": load_json(bench / "workloads" / f"{name}.json"),
        "config": load_json(root / cfg_entry["file"]),
        "traffic": load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        "end_to_end": [m for m in man["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in man["per_layer"]
                      if name in m.get("workloads", [name])],
        "run_seconds": man["run_seconds"],
    }


#: keys of a cell or mix file that only document it
NOTES = frozenset({"why", "measured", "knee", "tokens"})


def refuse_unknown(what: str, data: dict, known) -> None:
    """Raise for a key of ``data`` that the harness would not apply: a
    setting that is written down must be one that runs."""
    extra = set(data) - set(known) - NOTES
    if extra:
        raise ValueError(f"{what}: the harness applies no {sorted(extra)}")


def sources_digest() -> str:
    """A digest of the program's sources (Python and CUDA), for caches that
    a changed program must never read."""
    pkg = ROOT / "deeplearning4j_tpu_torch"
    h = hashlib.sha256()
    for p in sorted(pkg.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts:
            h.update(str(p.relative_to(pkg)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def card_or_exit(chips: int) -> None:
    """Exit 2 (and print no result) without the cards the cell asks for."""
    import torch

    why = None
    if not torch.cuda.is_available():
        why = ("no CUDA device; the benchmark measures the card and never "
               "falls back to the CPU")
    elif torch.cuda.device_count() < chips:
        why = (f"the cell needs {chips} CUDA devices, "
               f"{torch.cuda.device_count()} present")
    if why:
        print(f"benchmark: {why}", file=sys.stderr)
        sys.exit(2)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_loaded() -> list[str]:
    """Forbidden modules this process holds, by whole top-level name."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_block(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def percentile(values, q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least q% of
    the values at or below it (inf counts as a value, a missed request)."""
    vals = sorted(values)
    if not vals:
        return math.nan
    k = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
    return vals[k]


class Spans:
    """The harness's own spans around its calls into the program: kept in
    memory, and named in the profiler's trace while one records."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.profiling = False

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name, self.rf = owner, name, None

    def __enter__(self):
        if self.owner.profiling:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.owner.items.append((self.name, self.t0, time.perf_counter()))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False
