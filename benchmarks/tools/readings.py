#!/usr/bin/env python3
"""The readings a cell's check limits are set from, many seeds in one
process.

    python3 benchmarks/tools/readings.py --workload <cell>
        --seeds S1 S2 ... [--control-seeds C1 C2 C3] [--seconds 3]
        [--out PATH]

For each seed, one run of the cell as ``run.py`` makes it (a training
cell with no window: its check reads the first three steps; a serving
cell with a short window at the cell's own load) and the numbers its
check compares. For each control seed also the control: the reference in
the program's place computed with fp8 operands (a serving cell reads, at
each position of the same prompts and served tokens, the gap of the token
the fp8 reference puts first), and for a training cell the fault that
drops half of each batch, planted in the reference. Prints one JSON line a
run, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmarks.harness import core, serve, train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    core.fix_cache_dirs()
    cell = core.find_cell(args.workload)
    core.card_or_exit(cell["entry"]["chips"])
    import torch

    from benchmarks.reference.gpt2_plain import tf32_off

    tf32_off()
    dev = torch.device("cuda", 0)
    print(f"card: {core.card_line()}", flush=True)
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    limits = cell["cell"]["check"]
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        ctl = seed in args.control_seeds
        t0 = time.perf_counter()
        if cell["cell"]["mode"] == "train":
            res = train.run(cell, seed, 0.0, False, dev, t0)
            rd = res["readings"]
            emit({"seed": seed, "side": "program",
                  "numbers": {k: v for k, (v, _) in res["check"].items()},
                  "losses": rd["program"]["losses"],
                  "ref_losses": rd["reference"]["losses"],
                  "worst_grad_leaf": _worst(rd["program"]["grad"],
                                            rd["reference"]["grad"]),
                  "worst_change_leaf": _worst(rd["program"]["change"],
                                              rd["reference"]["change"]),
                  "s": time.perf_counter() - t0})
            if ctl:
                for name, kw in (("fp8", {"prec": "fp8"}),
                                 ("half_batch", {"half_batch": True})):
                    low = train.reference_readings(cell, seed, dev, **kw)
                    nums = train.judge(low, rd["reference"], limits)
                    emit({"seed": seed, "side": name,
                          "numbers": {k: v for k, (v, _) in nums.items()},
                          "losses": low["losses"]})
        else:
            res = serve.run(cell, seed, args.seconds, False, dev, t0,
                            control=ctl)
            emit({"seed": seed, "side": "program",
                  "numbers": {k: v for k, (v, _) in res["check"].items()},
                  "control_max_gap": res["readings"]["control_max_gap"],
                  "tokens_compared": res["readings"]["tokens_compared"],
                  "e2e": res["e2e"], "attempted": res["attempted"],
                  "failed": res["failed"],
                  "peak": res["memory_peak_bytes"],
                  "s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


def _worst(prog: dict, ref: dict):
    name = max(ref, key=lambda n: abs(prog[n] - ref[n]) / max(ref[n], 1e-30))
    return [name, prog[name], ref[name]]


if __name__ == "__main__":
    sys.exit(main())
