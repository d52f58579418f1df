#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's steady-state decode, on one
CUDA card.

    python3 scripts/torch_serve_profile.py [--horizons 12] [--out PATH]
        [--int8 off|weights|full] [--paged [--block-size 8]]
        [--temperature 0] [--top-k 0] [--sampling-surface]
        [--lora-adapters N [--lora-rank 4]] [--tp N] [--dense] [--gqa]
        [--slots 8]

Builds the GPT-2-small serving engine of ``chip_smoke.py`` (bf16, 8 slots,
max_total 640, K = 4, random weights from seed 0; ``--gqa`` the geometry
of bench.py's serve rows instead, phase 22's: 6 query heads over 2 KV
heads, RoPE, max_len 577; ``--slots`` the slot count; greedy unless
``--temperature`` and ``--top-k`` ask for sampled decode, which draws
through the threefry draw kernel; ``--sampling-surface`` dispatches the
masked step; ``--int8`` quantizes the weights, ``full`` also the KV cache;
``--paged`` block-pages the cache; ``--lora-adapters N`` loads a LoRA bank
of N adapters, rank ``--lora-rank``, from ``threefry.key(0)``, and the
slots take adapters 1..N-1 in turn, so every dispatch carries the bank;
``--tp N`` serves tensor-parallel with every rank on cuda:0, which runs the
dense decode and prefill, and ``--dense`` runs those at tp 1, the TP
engines' single-device comparator),
fills every slot with a 128-token prompt and a budget long enough to stay
in decode, then:

- times ``--horizons`` engine steps on the host clock (each step dispatches
  one K-substep horizon for every slot and reads back the previous one) and
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
    if "threefry_draw" in name:
        return "threefry draw kernel"
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0, help="0 disables")
    ap.add_argument("--sampling-surface", action="store_true",
                    help="arm the sampling surface (the masked step)")
    ap.add_argument("--lora-adapters", type=int, default=0, metavar="N",
                    help="serve a batched-LoRA bank of N adapters, the "
                    "slots on adapters 1..N-1")
    ap.add_argument("--lora-rank", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width, every rank on cuda:0")
    ap.add_argument("--dense", action="store_true",
                    help="the dense decode and prefill (no kernel) at tp 1")
    ap.add_argument("--gqa", action="store_true",
                    help="6 query heads over 2 KV heads, RoPE, max_len 577 "
                    "(chip_smoke.py phase 22's model)")
    ap.add_argument("--slots", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import gpt2s_config, p22_config
    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
    )
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if args.gqa:
        import dataclasses

        cfg = dataclasses.replace(p22_config(),
                                  decode_int8=args.int8 == "full")
    else:
        cfg = gpt2s_config(decode_int8=args.int8 == "full")
    if args.dense:
        import dataclasses

        cfg = dataclasses.replace(cfg, decode_kernel=False, use_flash=False)
    params = init_params(cfg, seed=0)
    if args.int8 != "off":
        params = quantize_decode_params(params, cfg)
    # the surface flag only when asked: the script also profiles older
    # checkouts (copied into one), whose engine may not take it
    surface = {"sampling_surface": True} if args.sampling_surface else {}
    if args.lora_adapters:
        from deeplearning4j_tpu_torch.models.transformer import init_lora_bank
        from deeplearning4j_tpu_torch.ops import threefry

        surface["lora_bank"] = init_lora_bank(
            threefry.key(0), cfg, args.lora_adapters, args.lora_rank)
    if args.tp > 1:
        surface.update(tp=args.tp, tp_devices=["cuda:0"] * args.tp)
    max_total = min(640, cfg.max_len)
    engine = ServingEngine(cfg, params, n_slots=args.slots,
                           max_total=max_total,
                           decode_horizon=4, temperature=args.temperature,
                           top_k=args.top_k or None,
                           paged=args.paged, block_size=args.block_size,
                           **surface)
    if args.lora_adapters and engine.n_adapters != args.lora_adapters:
        print("torch_serve_profile: the LoRA probe failed", file=sys.stderr)
        return 1
    if getattr(engine, "tp", 1) != args.tp:
        print(f"torch_serve_profile: the tp parity probe declined "
              f"({engine.tp_probe_detail})", file=sys.stderr)
        return 1
    if args.paged and not engine._paged:
        print("torch_serve_profile: the engine did not come up paged",
              file=sys.stderr)
        return 1
    if args.sampling_surface and not engine._surface:
        print("torch_serve_profile: the masked parity probe failed",
              file=sys.stderr)
        return 1
    sampler = (f"T {args.temperature} top-k {args.top_k or 'none'}"
               if args.temperature else "greedy")
    mode = ((f"int8 {args.int8}, " if args.int8 != "off" else "")
            + (f"paged bs {args.block_size}" if args.paged else "slab")
            + f", {sampler}"
            + (", sampling surface" if args.sampling_surface else "")
            + (f", LoRA {args.lora_adapters} x rank {args.lora_rank}"
               if args.lora_adapters else "")
            + (f", tp {args.tp} on cuda:0" if args.tp > 1 else "")
            + (", dense" if args.dense else "")
            + (", GQA 6 over 2 + RoPE" if args.gqa else ""))
    rng = np.random.default_rng(0)
    budget = 4 * (3 * args.horizons + 8)
    n = args.slots
    for i in range(n):
        # the adapter only when asked, as the surface flag above
        lora = ({"adapter": 1 + i % (args.lora_adapters - 1)}
                if args.lora_adapters else {})
        engine.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 128),
                              max_new=budget, **lora))
    for _ in range(4):  # admissions + warm-up horizons
        engine.step()
    torch.cuda.synchronize()
    assert engine.pool.n_active == n

    t0 = time.perf_counter()
    for _ in range(args.horizons):
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = engine.decode_horizon
    tok_s = n * k * args.horizons / wall
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
        "config": f"GPT-2-small bf16 ({mode}), {n} slots, max_total "
                  f"{max_total}, K=4, prompts 128",
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
          f"substep ({n} slots, K={k}, {args.horizons} horizons, host "
          f"clock)")
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
