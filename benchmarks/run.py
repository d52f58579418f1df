#!/usr/bin/env python3
"""Run one benchmark cell once on the card and print its result line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is found by name (``BENCHMARK.json``, then
``benchmarks/workloads/<cell>.json`` and the configuration and traffic
files it names). The run makes its weights and inputs from ``--seed``,
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``check``: each number compared beside its limit, which also close
standard error. Without the CUDA cards the cell asks for it exits 2 and
prints no result; it never runs on the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks.harness import core  # noqa: E402

def reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    path = core.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The cell's mode, ``harness/<mode>.py``, runs it once; a key of the
    cell file that the mode does not read is refused first."""
    name = cell["cell"]["mode"]
    mode = importlib.import_module(f"benchmarks.harness.{name}")
    core.refuse_unknown(cell["entry"]["name"], cell["cell"], mode.CELL_KEYS)
    return mode.run(cell, seed, seconds, trace, device, t_start)


def _num(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell: dict, res: dict, trace: bool, device) -> dict:
    """The result object, ``check`` last."""
    chips = cell["entry"]["chips"]
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = reader(m["name"])(res["record"])
            if v is not None:
                metrics[m["name"]] = core.metric(v, m["unit"])
    else:
        for m in cell["end_to_end"]:
            v = (res["setup_s"] if m["name"] == "setup_s"
                 else res["e2e"].get(m["name"]))
            metrics[m["name"]] = core.metric(_num(v), m["unit"])
    dev = core.device_block(device, chips)
    dev["memory_peak_bytes"] = res["memory_peak_bytes"]
    tr = res["record"]["trace"]
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in res["check"].values())
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace and tr is not None:
        line["breakdown"] = {"device_ops": tr.top_ops(10),
                             "idle_gaps": tr.idle_gaps(10)}
    line["check"] = {k: {"value": _num(v), "limit": lim}
                     for k, (v, lim) in res["check"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core.fix_cache_dirs()
    cell = core.find_cell(args.workload)
    core.card_or_exit(cell["entry"]["chips"])

    import torch

    from benchmarks.reference.gpt2_plain import tf32_off

    tf32_off()
    device = torch.device("cuda", 0)
    print(f"card: {core.card_line()}", file=sys.stderr)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    line = result_line(cell, res, bool(args.trace), device)
    lat = res.get("lateness")
    if lat:
        print(f"load generator lateness over {len(lat)} requests: p50 "
              f"{core.percentile(lat, 50) * 1e3} ms, p95 "
              f"{core.percentile(lat, 95) * 1e3} ms, max {lat[-1] * 1e3} ms",
              file=sys.stderr)
    print(f"reference check took {res['reference_s']} s", file=sys.stderr)
    bad = core.forbidden_loaded()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for k, v in line["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
