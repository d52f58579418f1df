#!/usr/bin/env python3
"""Find an open-loop serving cell's knee: the highest offered rate at which
the engine's backlog does not grow across a window.

    python3 benchmarks/tools/knee_sweep.py --workload <serving cell>
        [--traffic <poisson mix>] --rates 40 60 80 100 --seconds 10
        [--seed N]

One engine, the cell's, warmed as a run warms it; then for each rate in
turn the cell's traffic (or ``--traffic``, a mix in ``traffic/``) at that
rate for ``--seconds`` (the same generator, the
rate replaced), an idle engine between rates. Prints per rate: requests
offered and completed a second, the backlog (queued + decoding) at each
quarter of the window, refusals, and TTFT p50/p95 from the due time. Run
once when a cell is defined; the cell's traffic file then fixes its rate.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmarks.harness import core  # noqa: E402
from benchmarks.harness.serve import (  # noqa: E402
    Driver, build_engine, warm_shapes)
from benchmarks.traffic.generator import RequestStream  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--traffic", default=None)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args()
    core.fix_cache_dirs()
    cell = core.find_cell(args.workload)
    if args.traffic:
        cell["traffic"] = core.load_json(core.BENCH / "traffic"
                                         / f"{args.traffic}.json")
    core.card_or_exit(cell["entry"]["chips"])
    import torch

    from benchmarks.reference.gpt2_plain import tf32_off

    tf32_off()
    dev = torch.device("cuda", 0)
    print(f"card: {core.card_line()}", flush=True)
    t0 = time.perf_counter()
    engine, _ = build_engine(cell, args.seed, dev, trace=False)
    spans = core.Spans()
    warm = warm_shapes(engine, cell, args.seed, spans)
    warm.run_until_idle()
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    for k, rate in enumerate(args.rates):
        mix = copy.deepcopy(cell["traffic"])
        mix["arrivals"]["rate"] = rate
        drv = Driver(engine, RequestStream(mix, args.seed + k + 1,
                                           cell["config"]["vocab_size"]),
                     spans)
        drv.start()
        marks, q = [], 1
        while True:
            now = time.perf_counter() - drv.origin
            if now >= q * args.seconds / 4:
                marks.append(len(engine.scheduler) + engine.pool.n_active)
                q += 1
                if q > 4:
                    break
            drv.tick()
        drv.run_until_idle()
        t_end = drv.origin + args.seconds
        due = [s for s in drv.sent if s.due < t_end]
        done = [s for s in due if s.rec.times and s.rec.times[-1] <= t_end]
        ttft = [s.rec.times[0] - s.due if s.rec.times else float("inf")
                for s in due]
        refused = sum(s.refused for s in due)
        print(f"rate {rate}: offered {len(due) / args.seconds:.2f}/s, "
              f"completed {len(done) / args.seconds:.2f}/s, backlog at "
              f"quarters {marks}, refused {refused}, TTFT p50 "
              f"{core.percentile(ttft, 50) * 1e3:.1f} ms p95 "
              f"{core.percentile(ttft, 95) * 1e3:.1f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
