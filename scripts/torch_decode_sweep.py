#!/usr/bin/env python3
"""The decode kernels (#3, slab, bf16 and int8) built with other constants,
on one CUDA card.

    python3 scripts/torch_decode_sweep.py [--variant NAME:CONST=V[,CONST=V]]...
        [--out PATH]

Builds copies of ``csrc/flash_decode.cu`` (into the package's ``_build/``
directory) that differ from the source only in the ``constexpr int``
constants a variant names. The default variants:

- ``source``: the source as it is;
- ``cluster4``, ``cluster16``: 4 or 16 blocks per cluster in both modes
  (``SPLITS``, the T splits of one (batch row, KV head) in bf16/f32 mode;
  ``CL8``, the blocks of one batch row in int8 mode); a cluster above 8
  blocks is launched as a non-portable one;
- ``scratch``: ``SCORES8 = 0``, so int8 mode keeps every tile's scores in
  the wrapper's scratch tensor instead of shared memory.

``--variant`` replaces the defaults (repeat it). For each build the script
prints ``ptxas``'s registers and spills of every kernel, then times both
modes at the decode shape of ``chip_smoke.py`` phase 2 (B 8, G 1, Hkv*K
768, 12 layers, Tpad 640, layer 7) at three sets of positions: phase 2's
(0, 639 and six between), every row at position 0 (one visible row: the
call's fixed cost) and every row at 639 (the whole cache). Times are
device times, by CUDA-graph replay (``chip_smoke.graph_ms``). The port
always runs the source's own constants; these copies only measure. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

from _sweep import build_variants, parse_variant

ROOT = Path(__file__).resolve().parent.parent

DEFAULT_VARIANTS = ("source:", "cluster4:SPLITS=4,CL8=4",
                    "cluster16:SPLITS=16,CL8=16", "scratch:SCORES8=0")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=None,
                    metavar="NAME:CONST=V[,CONST=V]")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from deeplearning4j_tpu_torch.ops import _build as b
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    card = smoke.card_line()
    variants = dict(parse_variant(v)
                    for v in (args.variant or DEFAULT_VARIANTS))
    try:
        libs = build_variants("flash_decode", variants)
    except ValueError as e:
        raise SystemExit(f"torch_decode_sweep: {e}") from None
    gen = torch.Generator(device="cuda").manual_seed(1)
    bsz, hkv, kd, nl, t, layer = 8, 6, 128, 12, 640, 7
    hk = hkv * kd
    q = torch.randn((bsz, 1, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache = torch.randn((nl, 2, bsz, t, hk), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    cache8, scales = smoke._int8_store(gen, (nl, 2, bsz, t, hk))
    rng = random.Random(0)
    sets = {
        "phase2": [0, 639] + [rng.randrange(1, 639) for _ in range(6)],
        "pos0": [0] * bsz,
        "pos639": [639] * bsz,
    }
    library = b.library
    rows = []
    try:
        for name, (lib, log) in libs.items():
            b.library = lambda stem, lib=lib: lib  # noqa: E731
            fd._needs_scratch.cache_clear()
            row = {"variant": name, "constants": variants[name],
                   "ptxas": [f"{k}: {u}; {f}"
                             for k, u, f in smoke._ptxas_entries(log)]}
            for pname, pos in sets.items():
                p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                row[f"bf16_{pname}_ms"] = smoke.graph_ms(
                    lambda: fd.flash_decode_attention(q, cache, p, hkv, layer))
                row[f"int8_{pname}_ms"] = smoke.graph_ms(
                    lambda: fd.flash_decode_attention(q, cache8, p, hkv, layer,
                                                      kv_scales=scales))
            row["int8_scores_in_scratch"] = fd._needs_scratch(1, hkv, t, t)
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        b.library = library
        fd._needs_scratch.cache_clear()
    out = {"card": card, "shape": "B 8, G 1, Hkv*K 768, 12 layers, Tpad 640",
           "timing": "device ms per call, CUDA-graph replay", "rows": rows}
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
