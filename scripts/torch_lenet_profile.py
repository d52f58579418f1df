#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's LeNet training step, on one
CUDA card.

    python3 scripts/torch_lenet_profile.py [--batch 256 1024] [--steps 16]
                                           [--out PATH]

For each batch size: LeNet-5 from seed 0 (``build_lenet``) on synthetic
MNIST, ``DataParallelTrainer`` with its default SGD, in f32, each step as
``train --model lenet`` takes it (the host batch uploaded, the step, the
loss read back):

- 3 warm-up steps, then ``--steps`` steps on the host clock: ms a step and
  samples a second;
- ``--steps`` more traced with ``torch.profiler``: the device's busy time
  a step (its kernels' and copies' time summed), its busy share of the
  traced wall time, the launches a step, and the device time a step by
  group (cuDNN conv, cuBLAS matmul, copies, everything else).

Prints a human summary and, with ``--out``, writes the numbers as JSON to
PATH. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _group(name: str) -> str:
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("conv", "cudnn", "implicit", "wgrad",
                              "dgrad", "fprop")):
        return "conv (cuDNN)"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    return "elementwise/other"


def _profile(batch: int, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch import rng
    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.models.lenet import build_lenet, lenet_loss
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        DataParallelTrainer,
    )

    net, params = build_lenet(0)
    trainer = DataParallelTrainer(lenet_loss(net))
    state = trainer.init(params)
    n = 3 + 2 * steps
    batches = list(fetchers.mnist(n=n * batch).batches(batch,
                                                      drop_last=True))
    it = iter(enumerate(batches))

    def run(k: int) -> list[float]:
        nonlocal state
        secs = []
        for _ in range(k):
            i, b = next(it)
            t0 = time.perf_counter()
            x, y = trainer.shard_batch(b.features, b.labels)
            state, loss = trainer.step(state, x, y, rng.key_for(i))
            float(loss)
            secs.append(time.perf_counter() - t0)
        return secs

    run(3)
    torch.cuda.reset_peak_memory_stats()
    secs = run(steps)
    ms = 1e3 * sum(secs) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    groups: dict[str, float] = {}
    launches = 0
    for ev in prof.key_averages():
        # device-side records only: the host-side aten:: records carry
        # their kernels' time again
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        g = _group(ev.key)
        groups[g] = groups.get(g, 0.0) + ev.self_device_time_total
        launches += ev.count
    busy_us = sum(groups.values())
    return {
        "batch": batch,
        "steps": steps,
        "ms_per_step": ms,
        "samples_per_s": 1e3 * batch / ms,
        "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20,
        "traced_ms_per_step": 1e3 * traced / steps,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / (traced * 1e6),
        "device_records_per_step": launches / steps,
        "device_ms_per_step": {g: us / steps / 1e3
                               for g, us in sorted(groups.items())},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the numbers as JSON to PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_lenet_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    out = {"card": card, "runs": []}
    for b in args.batch:
        r = _profile(b, args.steps)
        out["runs"].append(r)
        print(f"lenet batch {b}: {r['ms_per_step']:.3f} ms a step "
              f"({r['samples_per_s']:.0f} samples/s, host clock, loss read "
              f"each step), peak {r['peak_memory_mib']:.1f} MiB; traced "
              f"{r['traced_ms_per_step']:.3f} ms a step, device busy "
              f"{r['device_busy_ms_per_step']:.3f} ms "
              f"(share {r['device_busy_share']:.3f}), "
              f"{r['device_records_per_step']:.1f} device records a step")
        for g, ms in r["device_ms_per_step"].items():
            print(f"  {g}: {ms:.4f} device ms a step")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
