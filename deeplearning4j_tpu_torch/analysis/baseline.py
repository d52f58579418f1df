"""Checked-in baseline of accepted lint findings (the port's copy of
``deeplearning4j_tpu/analysis/baseline.py``).

The baseline is the escape hatch for sites that are correct but that a
rule cannot prove correct — each entry carries a one-line reason, so
the justification is reviewed like code. Keys are line-number
independent (rule, file, enclosing qualname, normalized source text),
so accepted sites survive unrelated edits; an entry whose site
disappears goes STALE and ``lint --strict`` fails on it, keeping the
file from accreting dead exemptions.

The port's baseline is ``lint_baseline.json`` in this package (the
``.graftlint.json`` at the repository root belongs to the JAX package).

Workflow::

    python -m deeplearning4j_tpu_torch lint                  # new findings
    python -m deeplearning4j_tpu_torch lint --write-baseline # accept them
    # then edit lint_baseline.json: replace each "TODO: justify" reason

Prefer the inline annotations (``# lint: sync-ok <reason>`` etc.) for
sites with a durable local justification; use the baseline for bulk
acceptance during a rule rollout.
"""

from __future__ import annotations

import json
import os

DEFAULT_BASENAME = "lint_baseline.json"


class Baseline:
    """Load/match/write the accepted-findings file."""

    def __init__(self, path: str | None):
        self.path = path
        self.entries: dict[str, str] = {}  # key -> reason
        if path and os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            for e in data.get("accepted", []):
                self.entries[e["key"]] = e.get("reason", "")

    def split(self, findings):
        """Partition ``findings`` into (new, suppressed) and compute
        the stale baseline keys no current finding matches."""
        new, suppressed = [], []
        seen: set[str] = set()
        for f in findings:
            if f.key in self.entries:
                suppressed.append(f)
                seen.add(f.key)
            else:
                new.append(f)
        stale = sorted(set(self.entries) - seen)
        return new, suppressed, stale

    def write(self, findings) -> None:
        """Accept the current finding set: existing reasons are kept,
        new entries get a TODO reason the author must edit."""
        accepted = []
        done: set[str] = set()
        for f in sorted(findings, key=lambda f: f.key):
            if f.key in done:
                continue
            done.add(f.key)
            accepted.append({
                "key": f.key,
                "reason": self.entries.get(f.key, "TODO: justify"),
            })
        with open(self.path, "w", encoding="utf-8") as out:
            json.dump({"version": 1, "accepted": accepted}, out, indent=2)
            out.write("\n")
        self.entries = {e["key"]: e["reason"] for e in accepted}
