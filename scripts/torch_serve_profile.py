#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's steady-state decode, on one
CUDA card.

    python3 scripts/torch_serve_profile.py [--horizons 12] [--out PATH]
        [--int8 off|weights|full] [--paged [--block-size 8]]

Builds the GPT-2-small serving engine of ``chip_smoke.py`` (bf16, 8 slots,
max_total 640, K = 4, greedy, random weights from seed 0; ``--int8``
quantizes the weights, ``full`` also the KV cache; ``--paged`` block-pages
the cache), fills every slot with a 128-token prompt and a budget long
enough to stay in decode, then:

- times ``--horizons`` engine steps on the host clock (each step dispatches
  one K-substep horizon for 8 slots and reads back the previous one) and
  reports steady-state decode tokens/s and ms per substep;
- traces the same number of steps with ``torch.profiler`` and reports the
  device time by kernel, grouped (flash decode, matmuls, everything else),
  and the device's busy share of the traced wall time.

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
    if "flash_decode" in name:
        return "flash_decode kernel (#3 or #4)"
    if "flash_fwd" in name:
        return "flash_attn_fwd kernel"
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise/other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizons", type=int, default=12)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the numbers as JSON to PATH")
    ap.add_argument("--int8", default="off", choices=["off", "weights", "full"],
                    help="int8 weights over a bf16 cache, or with the int8 "
                    "KV cache too")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache")
    ap.add_argument("--block-size", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import gpt2s_config
    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
    )
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cfg = gpt2s_config(decode_int8=args.int8 == "full")
    params = init_params(cfg, seed=0)
    if args.int8 != "off":
        params = quantize_decode_params(params, cfg)
    engine = ServingEngine(cfg, params, n_slots=8, max_total=640,
                           decode_horizon=4, temperature=0.0,
                           paged=args.paged, block_size=args.block_size)
    if args.paged and not engine._paged:
        print("torch_serve_profile: the engine did not come up paged",
              file=sys.stderr)
        return 1
    mode = (f"int8 {args.int8}, " if args.int8 != "off" else "") + (
        f"paged bs {args.block_size}" if args.paged else "slab")
    rng = np.random.default_rng(0)
    budget = 4 * (3 * args.horizons + 8)
    for _ in range(8):
        engine.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 128),
                              max_new=budget))
    for _ in range(4):  # admissions + warm-up horizons
        engine.step()
    torch.cuda.synchronize()
    assert engine.pool.n_active == 8

    t0 = time.perf_counter()
    for _ in range(args.horizons):
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = engine.decode_horizon
    tok_s = 8 * k * args.horizons / wall
    ms_substep = wall / (args.horizons * k) * 1e3

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t1 = time.perf_counter()
        for _ in range(args.horizons):
            engine.step()
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
    n_sub = args.horizons * k
    out = {
        "card": card,
        "config": f"GPT-2-small bf16 ({mode}), 8 slots, max_total 640, K=4, "
                  f"greedy, prompts 128",
        "horizons": args.horizons,
        "decode_tok_per_s": tok_s,
        "ms_per_substep": ms_substep,
        "traced_wall_s": traced_wall,
        "device_busy_share": busy_us / (traced_wall * 1e6),
        "device_records_per_substep": sum(c for _, _, c in kernels) / n_sub,
        "device_ms_per_substep": {g: us / n_sub / 1e3
                                  for g, us in sorted(groups.items())},
        "top_kernels": [
            {"name": name[:120], "device_ms_per_substep": us / n_sub / 1e3,
             "calls_per_substep": cnt / n_sub}
            for name, us, cnt in kernels[:12]
        ],
    }
    print(f"card: {card}")
    print(f"mode: {mode}")
    print(f"steady decode: {tok_s:.1f} tok/s, {ms_substep:.3f} ms per "
          f"substep (8 slots, K={k}, {args.horizons} horizons, host clock)")
    print(f"device busy share of the traced steps: "
          f"{out['device_busy_share']:.3f}; "
          f"{out['device_records_per_substep']:.0f} kernels/copies per "
          f"substep")
    for g, ms in out["device_ms_per_substep"].items():
        print(f"  {g}: {ms:.4f} device ms per substep")
    for kr in out["top_kernels"]:
        print(f"    {kr['device_ms_per_substep']:.4f} ms x"
              f"{kr['calls_per_substep']:.1f}/substep  {kr['name']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
