"""graftlint runner (the port's copy of
``deeplearning4j_tpu/analysis/lint.py``): walk the package, run every rule,
apply the baseline, exit nonzero on new findings.

Entry points: ``python -m deeplearning4j_tpu_torch lint`` (the CLI
subcommand) and ``python -m deeplearning4j_tpu_torch.analysis.lint``
(pure stdlib — usable before torch/numpy are installed, since rules never
import the code they lint). It lints the port package by default, against
the baseline ``lint_baseline.json`` in this package.
"""

from __future__ import annotations

import argparse
import os
import sys

from deeplearning4j_tpu_torch.analysis.baseline import DEFAULT_BASENAME, Baseline
from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo
from deeplearning4j_tpu_torch.analysis.rules import RULES, run_rules


def default_root() -> str:
    """The installed package directory (what ``lint`` scans when no
    paths are given)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_py_files(path: str):
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in ("__pycache__", ".git", ".github")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths, rules=None, rel_base: str | None = None):
    """Run ``rules`` over every .py file under ``paths``; returns
    (findings, errors) where errors are (path, message) pairs for
    files that failed to parse."""
    findings: list[Finding] = []
    errors: list[tuple[str, str]] = []
    base = rel_base or os.path.dirname(default_root())
    for path in paths:
        for fp in iter_py_files(path):
            rel = os.path.relpath(os.path.abspath(fp), base)
            try:
                with open(fp, encoding="utf-8") as f:
                    src = f.read()
                mod = ModuleInfo(fp, src, relpath=rel)
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                errors.append((rel, str(e)))
                continue
            findings.extend(run_rules(mod, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors


def default_baseline_path() -> str:
    """``lint_baseline.json`` in this package (``analysis/``)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DEFAULT_BASENAME)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch lint",
        description="static analysis for this repo's proven bug classes "
                    "(host-sync, zero-copy-alias, prng-reuse, "
                    "lock-discipline, retrace-hazard)",
    )
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the "
                        "deeplearning4j_tpu_torch package)")
    p.add_argument("--rules", default=None, metavar="R1,R2",
                   help=f"rule subset (default all: {','.join(RULES)})")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline JSON (default: analysis/lint_baseline.json "
                        "in the package)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept the current finding set into the baseline "
                        "(new entries get a TODO reason to edit)")
    p.add_argument("--strict", action="store_true",
                   help="also fail on stale baseline entries and "
                        "TODO reasons")
    args = p.parse_args(argv)

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(have: {', '.join(RULES)})", file=sys.stderr)
            return 2

    paths = args.paths or [default_root()]
    findings, errors = lint_paths(paths, rules=rules)
    for rel, msg in errors:
        print(f"{rel}: parse error: {msg}", file=sys.stderr)

    bl_path = args.baseline or default_baseline_path()
    if args.no_baseline:
        baseline = Baseline(None)
    else:
        baseline = Baseline(bl_path)
    if args.write_baseline:
        baseline.path = bl_path
        baseline.write(findings)
        print(f"wrote {len(findings)} accepted finding(s) to {bl_path}")
        return 0

    new, suppressed, stale = baseline.split(findings)
    for f in new:
        print(f.render())
    rc = 0
    if new:
        rc = 1
    if errors:
        rc = max(rc, 2)
    todo = [k for k in baseline.entries
            if baseline.entries[k].startswith("TODO")]
    if args.strict and (stale or todo):
        for k in stale:
            print(f"stale baseline entry (site no longer found): {k}",
                  file=sys.stderr)
        for k in todo:
            print(f"baseline entry without a real reason: {k}",
                  file=sys.stderr)
        rc = max(rc, 1)
    print(f"graftlint: {len(new)} finding(s), {len(suppressed)} "
          f"baselined, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'}, "
          f"{len(RULES) if rules is None else len(rules)} rule(s)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
