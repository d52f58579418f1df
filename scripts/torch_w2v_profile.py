#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's Word2Vec training, on one CUDA
card.

    python3 scripts/torch_w2v_profile.py [--out PATH]

Builds ``chip_smoke.py``'s phase-6 full-width model (synthetic corpus of
text8's shape: 4,000 sentences of 1,000 tokens, Zipf(1.0) over 71,290 word
types, seed 0; D 100, window 5, batches of 4,096 pairs, HS) and trains it
in windows of sentences:

- ``Word2Vec.fit`` on 20 sentences to warm up, then on the next 400 timed on
  the host clock: pairs/s and host ms per batch, tokenizing and pair
  enumeration included;
- the batch updates alone (``_hs_math_merged`` over the pairs of the next
  400 sentences, already enumerated and on the card): pairs/s on the host
  clock and device ms per batch from CUDA events;
- ``Word2Vec.fit`` on the next 50 sentences traced with ``torch.profiler``:
  device ms per batch by kernel group (kernel #5, gathers, the scatter,
  reductions, matmuls, copies, elementwise), kernels per batch, and the
  device's busy share of the traced wall time.

Prints a summary and, with ``--out``, writes the numbers as JSON to PATH.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

WARMUP, TIMED, UPDATES, TRACED = 20, 400, 400, 50


def _group(name: str) -> str:
    low = name.lower()
    if "emb_dot" in low:
        return "kernel #5 (emb_dot)"
    if any(s in low for s in ("radix", "sort", "segment", "cummax", "scan",
                              "indexing_backward")):
        return "scatter (sort, run sums)"
    if "index" in low or "gather" in low:
        return "gathers and row writes"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions (grad_in, NS dots)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise/other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the numbers as JSON to PATH")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_w2v_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _counted_fit, w2v_full_model
    from deeplearning4j_tpu_torch import native_io
    from deeplearning4j_tpu_torch.models import word2vec as w2v
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )
    from deeplearning4j_tpu_torch.ops import emb_dot

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    model, corpus = w2v_full_model()
    b = model.batch_pairs
    windows = np.cumsum([0, WARMUP, TIMED, UPDATES, TRACED])
    part = [corpus[windows[i]:windows[i + 1]] for i in range(4)]

    def fit(sents) -> tuple[int, int, float]:
        """(pairs, batches, host seconds) of one fit over ``sents``."""
        emb_dot.reset_launches()
        t0 = time.perf_counter()
        pairs = _counted_fit(model, CollectionSentenceIterator(sents))
        torch.cuda.synchronize()
        return pairs, emb_dot.launches, time.perf_counter() - t0

    fit(part[0])
    pairs, batches, wall = fit(part[1])

    # the batch updates alone, on pairs enumerated ahead
    ids = [np.asarray(model.cache.encode(model.tokenize(s)), np.int32)
           for s in part[2]]
    ins, tgts = native_io.sg_pairs_chunk(ids, model.window, 0)
    n = len(ins) // b
    dev = model.device
    ins_d = torch.from_numpy(ins[:n * b].astype(np.int64)).to(dev)
    tgts_d = torch.from_numpy(tgts[:n * b].astype(np.int64)).to(dev)
    codes, points, mask = model._huffman()
    v = model.syn0.shape[0]
    S = torch.cat([model.syn0, model.syn1])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for k in range(n):
        sl = slice(k * b, (k + 1) * b)
        t = tgts_d[sl]
        w2v._hs_math_merged(S, v, ins_d[sl], codes[t], points[t], mask[t],
                            model.lr)
    end.record()
    torch.cuda.synchronize()
    upd_wall = time.perf_counter() - t0
    upd_dev_ms = start.elapsed_time(end)
    del S

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        tr_pairs, tr_batches, tr_wall = fit(part[3])
    groups: dict[str, float] = {}
    kernels = []
    n_kernels = 0
    for ev in prof.key_averages():
        # device-side kernel and copy records only: the host-side aten::
        # records carry their kernels' time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us <= 0:
            continue
        kernels.append((ev.key, dev_us, ev.count))
        n_kernels += ev.count
        g = _group(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us
    kernels.sort(key=lambda x: -x[1])
    busy_us = sum(groups.values())
    out = {
        "card": card,
        "config": f"V {len(model.cache)}, D {model.layer_size}, window "
                  f"{model.window}, batches of {b} pairs, HS, max code "
                  f"length {model.cache.max_code_length}",
        "fit": {"sentences": TIMED, "pairs": pairs, "batches": batches,
                "seconds": wall, "pairs_per_s": pairs / wall,
                "host_ms_per_batch": wall / batches * 1e3},
        "updates": {"batches": n, "pairs": n * b, "seconds": upd_wall,
                    "pairs_per_s": n * b / upd_wall,
                    "host_ms_per_batch": upd_wall / n * 1e3,
                    "device_ms_per_batch_events": upd_dev_ms / n},
        "traced": {"sentences": TRACED, "pairs": tr_pairs,
                   "batches": tr_batches, "seconds": tr_wall,
                   "device_busy_share": busy_us / (tr_wall * 1e6),
                   "kernels_per_batch": n_kernels / tr_batches,
                   "device_ms_per_batch": {
                       g: us / tr_batches / 1e3
                       for g, us in sorted(groups.items())}},
        "top_kernels": [
            {"name": name[:120], "device_ms_per_batch": us / tr_batches / 1e3,
             "calls_per_batch": cnt / tr_batches}
            for name, us, cnt in kernels[:15]
        ],
    }
    print(f"card: {card}")
    print(f"config: {out['config']}")
    f = out["fit"]
    print(f"fit ({TIMED} sentences, host clock): {f['pairs']} pairs in "
          f"{f['batches']} batches, {f['seconds']:.3f} s -> "
          f"{f['pairs_per_s']:.1f} pairs/s, {f['host_ms_per_batch']:.4f} "
          f"ms per batch")
    u = out["updates"]
    print(f"batch updates alone ({n} batches): {u['pairs_per_s']:.1f} "
          f"pairs/s, host {u['host_ms_per_batch']:.4f} ms per batch, "
          f"device {u['device_ms_per_batch_events']:.4f} ms per batch "
          f"(CUDA events)")
    tr = out["traced"]
    print(f"traced fit ({TRACED} sentences, {tr_batches} batches): device "
          f"busy share {tr['device_busy_share']:.3f}, "
          f"{tr['kernels_per_batch']:.1f} kernels per batch")
    for g, ms in tr["device_ms_per_batch"].items():
        print(f"  {g}: {ms:.4f} device ms per batch")
    for kr in out["top_kernels"]:
        print(f"    {kr['device_ms_per_batch']:.4f} ms x"
              f"{kr['calls_per_batch']:.2f}/batch  {kr['name']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
