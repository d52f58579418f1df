#!/usr/bin/env python3
"""Which products of the exact-TP serving programs give, on this device,
the matching part of the whole product bitwise.

    python3 scripts/torch_tp_products.py [--tp 2 3] [--out PATH]
        [--device cuda]

The exact-TP layout (``models/transformer.py``) holds TP=N to TP=1 bitwise
only where each rank's product is the matching slice of the single-device
product. A library may pick its kernel (and with it the reduction order)
by the output width, the row count or the batch count; this script asks
the device, at GPT-2-small's widths (d 768, 6 heads of 128, d_ff 3072,
vocab 50,304, bf16; the head in f32) and the serving engine's shapes
(decode at 8 slots over a 640-row cache, a batch-1 prefill of 8 and 128
rows, the 128-row chunk), for each width in ``--tp``:

- the column projections (wqkv, w1) and the f32 head, ``x @ W[:, part]``
  against the part's columns of ``x @ W``; the head also as the serving
  programs run it, in blocks of 8,384 vocab columns (``_head_cols``: the
  vocab over the 6 heads), a rank's blocks against the whole's;
- the decode and chunk attention's two batched products (the
  ``_chunk_attention`` einsums) over a rank's heads against those heads
  of the whole; the dense prefill's ``attention`` likewise.

Prints one line a product and shape (``exact`` or the largest absolute
difference) and, with ``--out``, the same as JSON. Random inputs from seed
0 at the weights' scales.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--out", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.ops.attention import attention, dtype_scalar

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    g = torch.Generator(device="cpu").manual_seed(0)
    bf = torch.bfloat16
    d, h, kd, f, v = 768, 6, 128, 3072, 50304

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    rows = []

    def check(name, shape, tp, whole, parts, dim):
        """``parts`` (rank order) against ``whole`` split on ``dim``."""
        want = torch.tensor_split(whole, tp, dim=dim)
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(parts, want)]
        same = all(torch.equal(a, b) for a, b in zip(parts, want))
        rows.append({"product": name, "shape": shape, "tp": tp,
                     "exact": same, "max_abs_diff": max(diffs)})
        print(f"tp {tp}  {name:<28} {shape:<34} "
              f"{'exact' if same else f'DIFFERS max |d| {max(diffs):.3e}'}")

    w = {"wqkv": rand(d, 3, h, kd, scale=d ** -0.5),
         "w1": rand(d, f, scale=d ** -0.5)}
    head = rand(d, v, scale=d ** -0.5)
    for tp in args.tp:
        for m in (1, 8, 128, 1024):
            x = rand(m, d)
            for name, wt in w.items():
                full = x @ wt.reshape(d, -1)
                axis = 2 if name == "wqkv" else 1
                parts = [x @ p.contiguous().reshape(d, -1)
                         for p in torch.tensor_split(wt, tp, dim=axis)]
                if name == "wqkv":
                    full = full.view(m, 3, h, kd)
                    parts = [p.view(m, 3, -1, kd) for p in parts]
                check(name, f"M {m}", tp, full, parts, 2 if name == "wqkv"
                      else 1)
            if m <= 128:
                xf = x.float()
                check("head (f32)", f"M {m}", tp, xf @ head.float(),
                      [xf @ p.contiguous().float()
                       for p in torch.tensor_split(head, tp, dim=1)], 1)

                def blocked(w):
                    return torch.cat([xf @ w[:, c:c + v // h].float()
                                      .contiguous() for c in range(
                                          0, w.shape[1], v // h)], dim=-1)
                check("head (f32, column blocks)", f"M {m}", tp,
                      blocked(head),
                      [blocked(p.contiguous())
                       for p in torch.tensor_split(head, tp, dim=1)], 1)
        # the dense decode / chunk attention of _chunk_attention
        for b, c, t in ((8, 1, 640), (1, 128, 640), (1, 8, 640)):
            q = rand(b, h, 1, c, kd)
            ck = rand(b, t, h, kd)
            cv = rand(b, t, h, kd)
            scale = dtype_scalar(math.sqrt(kd), bf)
            att = torch.einsum("bhgck,bthk->bhgct", q, ck) / scale
            qs = torch.tensor_split(q, tp, dim=1)
            cks = torch.tensor_split(ck, tp, dim=2)
            cvs = torch.tensor_split(cv, tp, dim=2)
            check("scores einsum", f"B {b} C {c} Tpad {t}", tp, att,
                  [torch.einsum("bhgck,bthk->bhgct", a.contiguous(),
                                k_.contiguous()) / scale
                   for a, k_ in zip(qs, cks)], 1)
            w_att = torch.softmax(att, dim=-1)
            check("weights @ V einsum", f"B {b} C {c} Tpad {t}", tp,
                  torch.einsum("bhgct,bthk->bhgck", w_att, cv),
                  [torch.einsum("bhgct,bthk->bhgck", a.contiguous(),
                                v_.contiguous())
                   for a, v_ in zip(torch.tensor_split(w_att, tp, dim=1),
                                    cvs)], 1)
        # the dense prefill attention
        for t in (8, 128):
            q, k_, v_ = (rand(1, h, t, kd) for _ in range(3))
            check("prefill attention", f"B 1 T {t}", tp,
                  attention(q, k_, v_, causal=True, layout="bhtd"),
                  [attention(a.contiguous(), b_.contiguous(), c_.contiguous(),
                             causal=True, layout="bhtd")
                   for a, b_, c_ in zip(*(torch.tensor_split(z, tp, dim=1)
                                          for z in (q, k_, v_)))], 1)
    print(f"card: {card}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
