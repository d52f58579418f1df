#!/usr/bin/env python3
"""ms a generate of ``chip_smoke.py`` phase 20a (int8-cache generate from
GPT-2-small on a (2, 3) layout over one card, and on the single device),
for one or more checkouts, in turns on one CUDA card.

    python3 scripts/torch_mesh_int8_generate.py [--root DIR ...]
        [--runs 5] [--out PATH]

Each ``--root`` (default: this checkout; point one at an unpacked older
commit, ``git archive <commit> | tar -x -C DIR``, to compare two versions)
runs in a process of its own, in the order given and then reversed (so
two roots run A, B, B, A). A process imports that root's ``chip_smoke.py``
and calls its ``phase20_mesh_int8`` ``--runs`` + 1 times (the first a
warm-up): each call builds the model, generates once on the single device
and once on the layout, checks the tokens and the launch counts, and logs
its ms both ways, which this script reads back. It prints one JSON line
per process (the root, the ms of every run both ways, the phase's own
lines of the last run), then, per root, the median ms over all its
processes, and the card's name and power limit.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: phase 20a's report: ms a generate on the layout, then single device
MS_LINE = re.compile(r"ms a generate \([^)]*\) ([\d.]+) on the layout, "
                     r"([\d.]+) single device")


def _worker(root: Path, runs: int) -> dict:
    import torch

    sys.path.insert(0, str(root))
    import chip_smoke

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise SystemExit(f"imported {chip_smoke.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    ms = {"layout": [], "single": []}
    for i in range(runs + 1):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            chip_smoke.phase20_mesh_int8(card, {})
        lines = buf.getvalue().splitlines()
        found = [m for m in map(MS_LINE.search, lines) if m]
        if len(found) != 1:
            raise SystemExit("phase 20a logged no ms line:\n" + buf.getvalue())
        if i:
            ms["layout"].append(float(found[0][1]))
            ms["single"].append(float(found[0][2]))
    return {"root": str(root), "ms_layout": ms["layout"],
            "ms_single": ms["single"], "last_run": lines}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", metavar="DIR",
                    help="a checkout to time (repeatable; default this one)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None, metavar="PATH")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(_worker(Path(args.worker).resolve(),
                                             args.runs)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_int8_generate: no CUDA device", file=sys.stderr)
        return 2
    roots = [str(Path(r).resolve()) for r in (args.root or [str(ROOT)])]
    results = []
    for root in roots + roots[::-1]:
        out = subprocess.run(
            [sys.executable, __file__, "--worker", root, "--runs",
             str(args.runs)], capture_output=True, text=True, timeout=1800)
        line = next((x for x in out.stdout.splitlines()
                     if x.startswith("RESULT ")), None)
        if out.returncode or line is None:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"worker for {root} failed ({out.returncode})")
        results.append(json.loads(line.split(" ", 1)[1]))
        print(json.dumps(results[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    summary = {root: {k: statistics.median(
        [x for r in results if r["root"] == root for x in r[k]])
        for k in ("ms_layout", "ms_single")} for root in roots}
    print(json.dumps({"median_ms": summary, "card": card}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "runs": results, "median_ms": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
