#!/usr/bin/env python3
"""Word2Vec's profile, an older checkout against this one, in turns on one
CUDA card.

    python3 scripts/torch_w2v_compare.py --parent DIR [--runs 10]
        [--out DIR]

Runs ``scripts/torch_w2v_profile.py`` of the checkout unpacked at DIR (the
parent commit, e.g. ``git archive <commit> | tar -x -C DIR``) and of this
checkout, each in its own process, ``--runs`` times a side in the order
parent, this, this, parent, ... (so neither side has the card's first or
last minutes to itself), then prints, per side, the median and the range
of every number the profile reports: pairs/s of the fit and of the batch
updates alone (host clock), device ms per batch (CUDA events), and from
the traced fit the device ms per batch by kernel group, kernels per batch
and the busy share. With ``--out`` each run's JSON and the summary go to
DIR. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _flat(prof: dict) -> dict[str, float]:
    """The profile's numbers under flat names."""
    tr = prof["traced"]
    out = {
        "fit_pairs_per_s": prof["fit"]["pairs_per_s"],
        "fit_host_ms_per_batch": prof["fit"]["host_ms_per_batch"],
        "updates_pairs_per_s": prof["updates"]["pairs_per_s"],
        "updates_device_ms_per_batch":
            prof["updates"]["device_ms_per_batch_events"],
        "traced_busy_share": tr["device_busy_share"],
        "traced_kernels_per_batch": tr["kernels_per_batch"],
        "traced_device_ms_per_batch":
            sum(tr["device_ms_per_batch"].values()),
    }
    for group, ms in tr["device_ms_per_batch"].items():
        out[f"group: {group}"] = ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, metavar="DIR",
                    help="an older checkout, unpacked")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--out", default=None, metavar="DIR")
    args = ap.parse_args()
    parent = Path(args.parent).resolve()
    roots = {"parent": parent, "this": ROOT}
    for side, root in roots.items():
        if not (root / "scripts" / "torch_w2v_profile.py").is_file():
            raise SystemExit(f"torch_w2v_compare: no profile script in "
                             f"{root}")
    # absolute: each profile runs from its own checkout
    out_dir = Path(args.out or tempfile.mkdtemp(prefix="w2v_compare_"))
    out_dir = out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    order = []
    for i in range(args.runs):
        pair = ("parent", "this") if i % 2 == 0 else ("this", "parent")
        order += [(side, i) for side in pair]
    runs: dict[str, list[dict[str, float]]] = {"parent": [], "this": []}
    card = None
    for side, i in order:
        path = out_dir / f"{side}_{i}.json"
        proc = subprocess.run(
            [sys.executable, str(roots[side] / "scripts" /
                                 "torch_w2v_profile.py"), "--out",
             str(path)], cwd=roots[side], capture_output=True, text=True,
            timeout=900)
        if proc.returncode:
            raise SystemExit(f"torch_w2v_compare: {side} run {i} failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        prof = json.loads(path.read_text())
        card = prof["card"]
        runs[side].append(_flat(prof))
        print(f"{side} run {i}: {json.dumps(runs[side][-1])}", flush=True)
    summary = {"card": card, "runs_a_side": args.runs,
               "order": "parent, this, this, parent, ...", "sides": {}}
    for side, rs in runs.items():
        keys = sorted({k for r in rs for k in r})
        summary["sides"][side] = {
            k: {"median": statistics.median([r.get(k, 0.0) for r in rs]),
                "min": min(r.get(k, 0.0) for r in rs),
                "max": max(r.get(k, 0.0) for r in rs)}
            for k in keys}
    print(f"card: {card}")
    keys = sorted(set(summary["sides"]["parent"])
                  | set(summary["sides"]["this"]))
    for k in keys:
        cells = []
        for side in ("parent", "this"):
            st = summary["sides"][side].get(k)
            cells.append("-" if st is None else
                         f"{st['median']:.6g} ({st['min']:.6g}-"
                         f"{st['max']:.6g})")
        print(f"  {k}: parent {cells[0]} | this {cells[1]}")
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
