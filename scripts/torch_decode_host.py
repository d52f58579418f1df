#!/usr/bin/env python3
"""Host cost of one decode-kernel call (#3 and #4, bf16 and int8) on one
CUDA card.

    python3 scripts/torch_decode_host.py [--root DIR] [--calls 200]
        [--out PATH]

Imports ``deeplearning4j_tpu_torch`` from DIR (default: this checkout;
point it at an unpacked older commit to compare two versions of the
wrapper in one run of the card), builds the decode shape of
``chip_smoke.py`` phase 2 (B 8, G 1, Hkv*K 768, 12 layers, Tpad 640, layer
7, positions 0, 639 and six between; paged at block size 8 over shuffled
tables) and, for each of the four calls the serving path makes, prints:

- ``host_us``: host-clock microseconds per call, the median of 20 loops
  of ``--calls`` back-to-back calls, synchronized between loops only (a
  loop's launches fit in the card's queue, so it measures the wrapper,
  ctypes and the launch, not the kernel, even where the kernel is the
  longer of the two);
- ``eager_ms``: ``chip_smoke.time_ms`` of the call (CUDA events around 50
  calls, the ``ms`` of the kernels line);
- ``graph_ms``: device ms per call by CUDA-graph replay
  (``chip_smoke.graph_ms``).

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import random
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(fn, calls: int) -> float:
    import torch

    loops = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        loops.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(loops)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT), metavar="DIR",
                    help="checkout whose deeplearning4j_tpu_torch is timed")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_host: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    smoke = _smoke()
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    if not Path(fd.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"torch_decode_host: imported {fd.__file__}, not "
                         f"from {root}")
    card = smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, hkv, kd, nl, t, layer, bs = 8, 6, 128, 12, 640, 7, 8
    hk = hkv * kd
    q = torch.randn((b, 1, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache = torch.randn((nl, 2, b, t, hk), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    cache8, scales = smoke._int8_store(gen, (nl, 2, b, t, hk))
    bps = t // bs
    n_blocks = b * bps + 9
    perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * bps].reshape(b, bps).to(torch.int32).contiguous()
    shape = (nl, 2, n_blocks, bs, hk)
    blocks = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    blocks8, bscales = smoke._int8_store(gen, shape)
    rng = random.Random(0)
    pos = [0, 639] + [rng.randrange(1, 639) for _ in range(6)]
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    calls = {
        "#3 bf16": lambda: fd.flash_decode_attention(q, cache, p, hkv, layer),
        "#3 int8": lambda: fd.flash_decode_attention(
            q, cache8, p, hkv, layer, kv_scales=scales),
        "#4 bf16": lambda: fd.flash_decode_attention_paged(
            q, blocks, tables, p, hkv, layer),
        "#4 int8": lambda: fd.flash_decode_attention_paged(
            q, blocks8, tables, p, hkv, layer, block_scales=bscales),
    }
    rows = []
    for name, fn in calls.items():
        fn()
        row = {"call": name, "host_us": _host_us(fn, args.calls),
               "eager_ms": smoke.time_ms(fn), "graph_ms": smoke.graph_ms(fn)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"card": card, "root": str(root), "positions": pos, "rows": rows}
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
