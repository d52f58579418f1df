#!/usr/bin/env python3
"""Run a cell several times, each run its own process as the check runs
it, and report each metric's spread.

    python3 benchmarks/tools/spread.py --workload <cell> --seeds S1 ... S6
        [--sets 2] [--seconds 10] [--trace 0] [--out PATH]

Each set runs ``run.py`` once per seed, in order; every set uses the same
seeds. For each metric and set: the median and the spread, the distance
between the first and third quartiles (``statistics.quantiles(values,
n=4)``) over the median; then the wider of the sets' spreads, which a
bound is set from. Every result line goes to ``--out`` (JSONL).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    runs = []
    for k in range(args.sets):
        for seed in args.seeds:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "benchmarks/run.py", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True, timeout=1300)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
            except (IndexError, ValueError):
                res = None
            rec = {"set": k, "seed": seed, "rc": p.returncode, "wall_s": wall,
                   "result": res}
            if res is None:
                rec["stderr"] = p.stderr[-3000:]
            runs.append(rec)
            short = ({m: v["value"] for m, v in res["metrics"].items()}
                     if res else p.stderr[-800:])
            print(json.dumps({"set": k, "seed": seed, "rc": p.returncode,
                              "wall_s": round(wall, 1),
                              "correct": res and res["correct"],
                              "metrics": short,
                              "check": res and {c: v["value"] for c, v in
                                                res["check"].items()},
                              "peak": res and res["device"]["memory_peak_bytes"]}),
                  flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in runs))
    names = sorted({m for r in runs if r["result"]
                    for m in r["result"]["metrics"]})
    for m in names:
        per_set = []
        for k in range(args.sets):
            vals = [r["result"]["metrics"][m]["value"] for r in runs
                    if r["set"] == k and r["result"]
                    and r["result"]["metrics"].get(m, {}).get("value")
                    is not None]
            if len(vals) >= 2:
                per_set.append((statistics.median(vals), spread(vals), vals))
        if per_set:
            print(f"{m}: " + "; ".join(
                f"set {k}: median {med} spread {sp} values {vals}"
                for k, (med, sp, vals) in enumerate(per_set))
                + f"; widest spread {max(sp for _, sp, _ in per_set)}",
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
