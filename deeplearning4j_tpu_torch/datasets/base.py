"""DataSet container + utilities (the port's copy of the JAX package's
``datasets/base.py``).

≙ ND4J's ``DataSet``/``FeatureUtil``/``SplitTestAndTrain`` as consumed by
the reference (59 uses, SURVEY §1-L0).  Host-side data stays in numpy —
device transfer happens once per batch at the jit boundary, keeping the
input pipeline off the TPU's critical path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataSet:
    """A (features, labels) pair. ``labels`` may be None for unsupervised data."""

    features: np.ndarray
    labels: np.ndarray | None = None

    def __post_init__(self):
        self.features = np.asarray(self.features)
        if self.labels is not None:
            self.labels = np.asarray(self.labels)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def num_inputs(self) -> int:
        return int(np.prod(self.features.shape[1:]))

    def num_outcomes(self) -> int:
        return 0 if self.labels is None else int(self.labels.shape[-1])

    def get_range(self, start: int, end: int) -> "DataSet":
        return DataSet(
            self.features[start:end],
            None if self.labels is None else self.labels[start:end],
        )

    def shuffle(self, seed: int | None = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return DataSet(
            self.features[idx], None if self.labels is None else self.labels[idx]
        )

    def sample(self, n: int, seed: int | None = None, replace: bool = True) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.num_examples(), size=n, replace=replace)
        return DataSet(
            self.features[idx], None if self.labels is None else self.labels[idx]
        )

    def split_test_and_train(self, n_train: int) -> tuple["DataSet", "DataSet"]:
        """≙ SplitTestAndTrain: first n_train rows train, rest test."""
        return self.get_range(0, n_train), self.get_range(n_train, self.num_examples())

    def batches(self, batch_size: int, drop_last: bool = False) -> Iterator["DataSet"]:
        n = self.num_examples()
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            if drop_last and end - start < batch_size:
                return
            yield self.get_range(start, end)

    def binarize(self, threshold: float = 0.5) -> "DataSet":
        return DataSet((self.features > threshold).astype(np.float32), self.labels)

    def normalize_zero_mean_unit_variance(self) -> "DataSet":
        mean = self.features.mean(axis=0, keepdims=True)
        std = self.features.std(axis=0, keepdims=True) + 1e-8
        return DataSet(((self.features - mean) / std).astype(np.float32), self.labels)

    def scale_min_max(self) -> "DataSet":
        lo = self.features.min(axis=0, keepdims=True)
        hi = self.features.max(axis=0, keepdims=True)
        return DataSet(
            ((self.features - lo) / np.maximum(hi - lo, 1e-8)).astype(np.float32),
            self.labels,
        )


def to_one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """≙ FeatureUtil.toOutcomeMatrix."""
    labels = np.asarray(labels, dtype=np.int64).reshape(-1)
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def merge(datasets: list[DataSet]) -> DataSet:
    feats = np.concatenate([d.features for d in datasets], axis=0)
    if datasets[0].labels is None:
        return DataSet(feats, None)
    return DataSet(feats, np.concatenate([d.labels for d in datasets], axis=0))
