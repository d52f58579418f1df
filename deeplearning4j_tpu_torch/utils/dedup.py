"""String-dedup utilities: fingerprint keying + grid clustering.

≙ reference util/FingerPrintKeyer.java + StringGrid.java (~1100 LoC of
OpenRefine-style text dedup used for corpus cleaning).

The port's copy of ``deeplearning4j_tpu/utils/dedup.py``.
"""

from __future__ import annotations

import string
import unicodedata
from collections import defaultdict


def fingerprint(s: str) -> str:
    """Normalized key: strip accents/punct, lowercase, unique sorted tokens
    (≙ FingerPrintKeyer.key)."""
    s = unicodedata.normalize("NFD", s)
    s = "".join(c for c in s if unicodedata.category(c) != "Mn")
    s = s.translate(str.maketrans("", "", string.punctuation)).lower()
    return " ".join(sorted(set(s.split())))


def ngram_fingerprint(s: str, n: int = 2) -> str:
    base = fingerprint(s).replace(" ", "")
    grams = sorted({base[i : i + n] for i in range(max(len(base) - n + 1, 1))})
    return "".join(grams)


class StringGrid:
    """Rows of string records with fingerprint-cluster dedup
    (≙ StringGrid's cluster-by-fingerprint columns)."""

    def __init__(self, rows: list[list[str]], sep: str = ","):
        self.rows = [list(r) for r in rows]
        self.sep = sep

    @classmethod
    def from_lines(cls, lines: list[str], sep: str = ",") -> "StringGrid":
        return cls([line.split(sep) for line in lines], sep)

    def get_column(self, i: int) -> list[str]:
        return [r[i] for r in self.rows]

    def clusters_by_fingerprint(self, column: int, keyer=fingerprint) -> dict[str, list[int]]:
        out: dict[str, list[int]] = defaultdict(list)
        for idx, row in enumerate(self.rows):
            out[keyer(row[column])].append(idx)
        return dict(out)

    def dedup_column(self, column: int, keyer=fingerprint) -> "StringGrid":
        """Keep the first row of each fingerprint cluster."""
        seen = set()
        kept = []
        for row in self.rows:
            k = keyer(row[column])
            if k not in seen:
                seen.add(k)
                kept.append(row)
        return StringGrid(kept, self.sep)
