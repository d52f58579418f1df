#!/usr/bin/env python3
"""Peak memory and step time of a training cell at several batch sizes.

    python3 benchmarks/tools/batch_probe.py --workload <train cell>
        --batches 8 10 12 [--remat]

For each batch: the cell's step and state from seed 0, two steps to warm,
then three timed on the host clock around a synchronize; prints the batch,
the peak device memory and ms a step, or that it ran out of memory. Used
once to choose a training cell's batch (the largest that fits).
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmarks.harness import core, weights  # noqa: E402
from benchmarks.harness.model import transformer_config  # noqa: E402
from benchmarks.traffic.generator import lm_batch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, nargs="+", required=True)
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args()
    core.fix_cache_dirs()
    cell = core.find_cell(args.workload)
    core.card_or_exit(1)
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer,
        param_shapes,
        transformer_train_step,
    )

    dev = torch.device("cuda", 0)
    cfg, mix = cell["config"], cell["traffic"]
    print(f"card: {core.card_line()}", flush=True)
    for b in args.batches:
        tcfg = transformer_config(cfg, dict(cell["cell"]["model"],
                                            remat=args.remat))
        opt = lm_optimizer(**cell["cell"]["trainer"]["optimizer"])
        step, _, _ = transformer_train_step(None, tcfg, optimizer=opt,
                                            device=dev)
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats()
        params = state = None
        try:
            params = weights.make_params(param_shapes(tcfg), 0, cfg["n_embd"],
                                         cfg["n_inner"], dev)
            state = opt.init(params)
            for i in range(5):
                if i == 2:
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                params, state, loss = step(
                    params, state, lm_batch(mix, 0, i, b, cfg["vocab_size"],
                                            dev))
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / 3 * 1e3
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"batch {b} remat {args.remat}: peak {peak} B "
                  f"({peak / 2**30:.2f} GiB), {ms:.1f} ms a step, "
                  f"{b * mix['seq'] / ms * 1e3:.0f} tokens/s, loss "
                  f"{float(loss):.4f}", flush=True)
        except torch.cuda.OutOfMemoryError:
            print(f"batch {b} remat {args.remat}: out of memory", flush=True)
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
