"""Small collection/IO utilities.

≙ reference util leftovers with live call sites: MultiDimensionalMap
(util/MultiDimensionalMap.java:785 — used by RNTN's per-label parameter
tables), SummaryStatistics, ArchiveUtils (tar/gz/zip extraction for
dataset downloads), SetUtils.

The port's copy of ``deeplearning4j_tpu/utils/collections_util.py``.
"""

from __future__ import annotations

import math
import shutil
import tarfile
import zipfile
from pathlib import Path
from typing import Generic, Hashable, TypeVar

K1 = TypeVar("K1", bound=Hashable)
K2 = TypeVar("K2", bound=Hashable)
V = TypeVar("V")


class MultiDimensionalMap(Generic[K1, K2, V]):
    """Pair-keyed map (≙ MultiDimensionalMap with entrySet/get/put)."""

    def __init__(self):
        self._m: dict[tuple[K1, K2], V] = {}

    def put(self, k1: K1, k2: K2, v: V) -> None:
        self._m[(k1, k2)] = v

    def get(self, k1: K1, k2: K2, default: V | None = None) -> V | None:
        return self._m.get((k1, k2), default)

    def contains(self, k1: K1, k2: K2) -> bool:
        return (k1, k2) in self._m

    def remove(self, k1: K1, k2: K2) -> None:
        self._m.pop((k1, k2), None)

    def entries(self):
        return self._m.items()

    def __len__(self) -> int:
        return len(self._m)


class SummaryStatistics:
    """Streaming mean/variance (Welford) ≙ util/SummaryStatistics."""

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self._mean
        self._mean += d / self.n
        self._m2 += d * (x - self._mean)
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def variance(self) -> float:
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.variance)


def extract_archive(path: str | Path, dest: str | Path) -> Path:
    """≙ util/ArchiveUtils: unpack tar/tar.gz/tgz/zip/gz."""
    path, dest = Path(path), Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    name = path.name
    if name.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(path) as t:
            t.extractall(dest, filter="data")
    elif name.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
    elif name.endswith(".gz"):
        import gzip

        out = dest / path.stem
        with gzip.open(path, "rb") as f_in, open(out, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
    else:
        raise ValueError(f"Unknown archive format: {name}")
    return dest


def intersection(a, b) -> set:
    return set(a) & set(b)


def difference(a, b) -> set:
    return set(a) - set(b)
