#!/usr/bin/env python3
"""Kernel #5 (the fused embedding dot) built with other constants, on one
CUDA card.

    python3 scripts/torch_emb_dot_sweep.py [--variant NAME:CONST=V[,CONST=V]]...
        [--out PATH]

Builds copies of ``csrc/emb_dot.cu`` (into the package's ``_build/``
directory) that differ from the source only in the ``constexpr int``
constants a variant names. The default variants:

- ``source``: the source as it is (4 warps a block, FLIGHT 4: four path
  rows in flight per warp at D 100);
- ``flight1``, ``flight2``, ``flight8``: 1, 2 or 8 row chunks in flight
  per lane (at D 100, one float4 chunk a row: that many path rows loaded
  together and their dots reduced together);
- ``warps2``, ``warps8``: 2 or 8 warps (batch rows) a block.

``--variant`` replaces the defaults (repeat it). For each build the script
prints ``ptxas``'s registers and spills of every kernel, then times, on
``chip_smoke.py`` phase 2's batches (B 4,096, D 100, phase 6's vocabulary
of 71,204 words), the fused mode as the HS step calls it (``dest`` from the
scatter plan) on phase 6's first batch and on the L 16 batch, and the
dense mode at phase 6's longest path (L 22). Times are device times, by
CUDA-graph replay (``chip_smoke.graph_ms``). The port always runs the
source's own constants; these copies only measure. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from _sweep import build_variants, parse_variant

ROOT = Path(__file__).resolve().parent.parent

DEFAULT_VARIANTS = ("source:", "flight1:FLIGHT=1", "flight2:FLIGHT=2",
                    "flight8:FLIGHT=8", "warps2:WARPS=2", "warps8:WARPS=8")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=None,
                    metavar="NAME:CONST=V[,CONST=V]")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_emb_dot_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from deeplearning4j_tpu_torch.models import word2vec as w2v
    from deeplearning4j_tpu_torch.ops import _build as b
    from deeplearning4j_tpu_torch.ops import emb_dot

    card = smoke.card_line()
    variants = dict(parse_variant(v)
                    for v in (args.variant or DEFAULT_VARIANTS))
    try:
        libs = build_variants("emb_dot", variants)
    except ValueError as e:
        raise SystemExit(f"torch_emb_dot_sweep: {e}") from None
    model, corpus = smoke.w2v_full_model()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {}
    for kind in ("phase6", "L16"):
        S, v, inputs, codes, points, mask, _ = smoke._emb_dot_hs_batch(
            kind, model, corpus, gen)
        rows = torch.cat([inputs, (v + points).reshape(-1)])
        keep = torch.cat([torch.ones_like(inputs, dtype=torch.bool),
                          mask.reshape(-1) > 0])
        dest = w2v._scatter_plan(rows, keep, S.shape[0], inverse=True).dest
        calls[f"fused_{kind}_ms"] = (
            lambda a=(S, v, inputs, codes, points, mask, smoke.W2V_LR),
            d=dest: emb_dot.fused_hs_rows(*a, dest=d))
    L = model.cache.max_code_length
    h = torch.randn((smoke.W2V_BATCH, smoke.W2V_DIM), generator=gen,
                    device="cuda") * 0.5
    w = torch.randn((smoke.W2V_BATCH, L, smoke.W2V_DIM), generator=gen,
                    device="cuda") * 0.5
    m = torch.ones((smoke.W2V_BATCH, L), device="cuda")
    calls[f"dense_L{L}_ms"] = lambda: emb_dot.fused_embedding_dot_range(
        h, w, m)
    library = b.library
    rows_out = []
    try:
        for name, (lib, log) in libs.items():
            b.library = lambda stem, lib=lib: lib  # noqa: E731
            row = {"variant": name, "constants": variants[name],
                   "ptxas": [f"{k}: {u}; {f}"
                             for k, u, f in smoke._ptxas_entries(log)]}
            for key, fn in calls.items():
                row[key] = smoke.graph_ms(fn)
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    finally:
        b.library = library
    out = {"card": card, "shape": f"B {smoke.W2V_BATCH}, D {smoke.W2V_DIM}, "
           f"V {len(model.cache)}, longest path {L}",
           "timing": "device ms per call, CUDA-graph replay",
           "rows": rows_out}
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
