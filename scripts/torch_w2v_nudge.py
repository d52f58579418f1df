#!/usr/bin/env python3
"""How far a last-bit nudge carries through the full-width Word2Vec fit on
one CUDA card, for one checkout or several.

    python3 scripts/torch_w2v_nudge.py [--root DIR]... [--perturb EPS]
        [--out PATH]

For each checkout (``--root``, repeatable, default this one; an older
commit unpacked with ``git archive <commit> | tar -x -C DIR``), one process
builds ``chip_smoke.py`` phase 6's full-width HS model and corpus with that
checkout's own code (D 100, window 5, batches of 4,096, lr 0.025, the
synthetic text8-shaped Zipf corpus), fits it from its seeded tables, then
again from syn0 * (1 + EPS) (default 2^-23, a last-bit nudge). Prints, as
one JSON line, max |syn0| and the seconds of every fit, and how far apart
the final syn0 tables are (max |difference|, rows apart by more than
1e-3) for every pair of fits: a checkout against its own nudge, and the
checkouts against each other. Where two checkouts' fits are as far apart
as one fit is from its nudge, their difference is what a last-bit change
does on this fit, not a fault of either. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _one(root: Path, eps: float, tmp: Path, tag: str) -> int:
    """In its own process: the checkout at ``root`` fits twice, each final
    syn0 saved to ``tmp`` as ``<tag>_<fit>.npy``; prints a JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from chip_smoke import w2v_full_model
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model, corpus = w2v_full_model()
    out = {}
    for fit in ("seeded", "nudged"):
        model.reset_weights()
        if fit == "nudged":
            model.syn0 = model.syn0 * torch.tensor(1 + eps,
                                                   dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(CollectionSentenceIterator(corpus))
        torch.cuda.synchronize()
        syn0 = model.syn0.cpu().numpy()
        np.save(tmp / f"{tag}_{fit}.npy", syn0)
        out[fit] = {"seconds": time.perf_counter() - t0,
                    "finite": bool(np.isfinite(syn0).all()),
                    "max_abs_syn0": float(np.abs(syn0).max())}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=None, metavar="DIR")
    ap.add_argument("--perturb", type=float, default=2.0 ** -23,
                    metavar="EPS")
    ap.add_argument("--out", default=None, metavar="PATH")
    ap.add_argument("--one", nargs=2, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return _one(Path(args.root[0]), args.perturb, Path(args.one[0]),
                    args.one[1])

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_w2v_nudge: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line

    roots = [Path(r).resolve() for r in (args.root or [ROOT])]
    result = {"card": card_line(), "perturb": args.perturb, "fits": {},
              "apart": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(roots):
            tag = f"{i}:{root.name}"
            r = subprocess.run(
                [sys.executable, __file__, "--root", str(root), "--perturb",
                 repr(args.perturb), "--one", tmp, str(i)],
                capture_output=True, text=True)
            if r.returncode:
                print(r.stdout, r.stderr, file=sys.stderr)
                raise SystemExit(f"torch_w2v_nudge: the fit of {root} "
                                 f"failed")
            result["fits"][tag] = json.loads(r.stdout.strip().splitlines()[-1])
        tables = {(f"{i}:{root.name}", fit): np.load(
            Path(tmp) / f"{i}_{fit}.npy")
            for i, root in enumerate(roots) for fit in ("seeded", "nudged")}
    for a, b in itertools.combinations(tables, 2):
        d = np.abs(tables[a] - tables[b])
        result["apart"][f"{a[0]} {a[1]} vs {b[0]} {b[1]}"] = {
            "max_abs_diff": float(d.max()),
            "rows_over_1e-3": int((d.max(1) > 1e-3).sum())}
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
