#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one CUDA
card.

    python3 scripts/torch_train_profile.py [--steps 4] [--out PATH]

Trains the reference bench's "transformer" preset of ``chip_smoke.py``
(GPT-2-small widths, 6 heads of 128, seq 1024, batch 24, flash, remat
``dots_no_batch``, bf16 compute, f32 params, ``lm_optimizer``; random
weights and one fixed batch from seed 0) through ``transformer_train_step``:

- 2 warm-up steps, then ``--steps`` steps timed on the host clock: ms per
  step, tokens/s, the share of the card's 989 TFLOP/s bf16 peak (the
  reference bench's FLOP count), and the peak device memory;
- ``--steps`` more traced with ``torch.profiler``: device time per step by
  kernel, grouped (flash forward kernel, flash backward kernel, cuBLAS
  matmuls, copies, everything else), and the device's busy share of the
  traced wall time.

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
    if "flash_fwd" in name:
        return "flash_attn_fwd kernel"
    if "flash_bwd" in name:
        return "flash_attn_bwd kernel"
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise/other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the numbers as JSON to PATH")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        BF16_FLOPS,
        TRAIN_BATCH,
        TRAIN_SEQ,
        bench_config,
        lm_flops_per_token,
    )
    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer,
        transformer_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cfg = bench_config()
    step, init_state, shard_tokens = transformer_train_step(
        None, cfg, optimizer=lm_optimizer(total_steps=2 + 2 * args.steps))
    params, opt_state = init_state(0)
    toks = shard_tokens(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)))
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, toks)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, opt_state, loss = step(params, opt_state, toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ms_step = wall / args.steps * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ * args.steps / wall
    share = lm_flops_per_token(cfg.d_model, cfg.n_layers, cfg.d_ff,
                               cfg.vocab_size, TRAIN_SEQ) * tok_s / BF16_FLOPS

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t1 = time.perf_counter()
        for _ in range(args.steps):
            params, opt_state, loss = step(params, opt_state, toks)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t1
    groups: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        # device-side kernel and copy records only: the host-side aten::
        # records carry their kernels' time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us <= 0:
            continue
        kernels.append((ev.key, dev_us, ev.count))
        g = _group(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us
    kernels.sort(key=lambda x: -x[1])
    busy_us = sum(groups.values())
    out = {
        "card": card,
        "config": f"bench 'transformer' preset: {cfg.d_model}d x "
                  f"{cfg.n_layers}L, {cfg.n_heads}x{cfg.head_dim} heads, "
                  f"vocab {cfg.vocab_size}, seq {TRAIN_SEQ}, batch "
                  f"{TRAIN_BATCH}, flash, remat {cfg.remat_policy}, bf16",
        "steps": args.steps,
        "ms_per_step": ms_step,
        "tokens_per_s": tok_s,
        "peak_share_bf16": share,
        "peak_memory_gib": peak_gib,
        "last_loss": float(loss),
        "traced_wall_s": traced_wall,
        "device_busy_share": busy_us / (traced_wall * 1e6),
        "device_ms_per_step": {g: us / args.steps / 1e3
                               for g, us in sorted(groups.items())},
        "top_kernels": [
            {"name": name[:120], "device_ms_per_step": us / args.steps / 1e3,
             "calls_per_step": cnt / args.steps}
            for name, us, cnt in kernels[:15]
        ],
    }
    print(f"card: {card}")
    print(f"train: {ms_step:.2f} ms/step, {tok_s:.1f} tokens/s, "
          f"{share:.4f} of peak bf16, peak memory {peak_gib:.2f} GiB "
          f"({args.steps} steps, host clock)")
    print(f"device busy share of the traced steps: "
          f"{out['device_busy_share']:.3f}")
    for g, ms in out["device_ms_per_step"].items():
        print(f"  {g}: {ms:.3f} device ms per step")
    for kr in out["top_kernels"]:
        print(f"    {kr['device_ms_per_step']:.3f} ms x"
              f"{kr['calls_per_step']:.1f}/step  {kr['name']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
