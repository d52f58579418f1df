"""DataSet iterators: the port's copy of the JAX package's
``datasets/iterators.py`` (numpy only), without its
``PrefetchDataSetIterator`` (the native loader's bridge).

≙ reference ``datasets/iterator`` — DataSetIterator interface
(DataSetIterator.java), BaseDatasetIterator.java:104,
SamplingDataSetIterator.java:107, ReconstructionDataSetIterator.java:156,
MultipleEpochsIterator.java:187, ListDataSetIterator.java:123, and the
TestDataSetIterator fixture (datasets/test/TestDataSetIterator.java:102).

Python iterators double as the host-side input pipeline for SPMD training:
per-host shard selection happens here (deterministic by host id), keeping
device code purely functional.
"""

from __future__ import annotations

from typing import Callable, Iterator, Protocol

import numpy as np

from deeplearning4j_tpu_torch.datasets.base import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import BaseDataFetcher


class DataSetIterator(Protocol):
    def __iter__(self) -> Iterator[DataSet]: ...
    def reset(self) -> None: ...
    def batch(self) -> int: ...
    def total_examples(self) -> int: ...
    def input_columns(self) -> int: ...
    def total_outcomes(self) -> int: ...


class BaseDatasetIterator:
    """Iterate a fetcher in minibatches (≙ BaseDatasetIterator.java:104)."""

    def __init__(self, batch_size: int, num_examples: int | None, fetcher: BaseDataFetcher):
        self.batch_size = batch_size
        self.num_examples = num_examples or fetcher.total_examples()
        self.fetcher = fetcher
        self.preprocessor: Callable[[DataSet], DataSet] | None = None

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.fetcher.has_more() and self.fetcher.cursor < self.num_examples:
            batch = self.fetcher.fetch(min(self.batch_size, self.num_examples - self.fetcher.cursor))
            if batch.num_examples() == 0:
                return
            yield self.preprocessor(batch) if self.preprocessor else batch

    def reset(self) -> None:
        self.fetcher.reset()

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return self.num_examples

    def input_columns(self) -> int:
        return self.fetcher.input_columns()

    def total_outcomes(self) -> int:
        return self.fetcher.total_outcomes()


class ListDataSetIterator:
    """Iterate an in-memory DataSet (≙ ListDataSetIterator.java:123)."""

    def __init__(self, dataset: DataSet, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.preprocessor: Callable[[DataSet], DataSet] | None = None

    def __iter__(self) -> Iterator[DataSet]:
        for b in self.dataset.batches(self.batch_size):
            yield self.preprocessor(b) if self.preprocessor else b

    def reset(self) -> None:
        pass

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return self.dataset.num_examples()

    def input_columns(self) -> int:
        return self.dataset.num_inputs()

    def total_outcomes(self) -> int:
        return self.dataset.num_outcomes()


class SamplingDataSetIterator:
    """Sample-with-replacement batches (≙ SamplingDataSetIterator.java:107)."""

    def __init__(self, dataset: DataSet, batch_size: int, total_batches: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.total_batches = total_batches
        self.seed = seed

    def __iter__(self) -> Iterator[DataSet]:
        for i in range(self.total_batches):
            yield self.dataset.sample(self.batch_size, seed=self.seed + i)

    def reset(self) -> None:
        pass

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return self.batch_size * self.total_batches

    def input_columns(self) -> int:
        return self.dataset.num_inputs()

    def total_outcomes(self) -> int:
        return self.dataset.num_outcomes()


class ReconstructionDataSetIterator:
    """Labels := features (≙ ReconstructionDataSetIterator.java:156)."""

    def __init__(self, inner):
        self.inner = inner

    def __iter__(self) -> Iterator[DataSet]:
        for d in self.inner:
            yield DataSet(d.features, d.features)

    def reset(self) -> None:
        self.inner.reset()

    def batch(self) -> int:
        return self.inner.batch()

    def total_examples(self) -> int:
        return self.inner.total_examples()

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.input_columns()


class MultipleEpochsIterator:
    """Replay an iterator N times (≙ MultipleEpochsIterator.java:187)."""

    def __init__(self, epochs: int, inner):
        self.epochs = epochs
        self.inner = inner

    def __iter__(self) -> Iterator[DataSet]:
        for _ in range(self.epochs):
            self.inner.reset()
            yield from self.inner

    def reset(self) -> None:
        self.inner.reset()

    def batch(self) -> int:
        return self.inner.batch()

    def total_examples(self) -> int:
        return self.epochs * self.inner.total_examples()

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.total_outcomes()


class ShardedDataSetIterator:
    """Deterministic per-host shard of an underlying iterator.

    The TPU-native replacement for the reference's job-queue data
    distribution (BatchActor routing jobs to workers): each host takes
    every ``num_shards``-th batch by index — no coordinator needed.
    """

    def __init__(self, inner, shard: int, num_shards: int):
        self.inner = inner
        self.shard = shard
        self.num_shards = num_shards

    def __iter__(self) -> Iterator[DataSet]:
        for i, d in enumerate(self.inner):
            if i % self.num_shards == self.shard:
                yield d

    def reset(self) -> None:
        self.inner.reset()

    def batch(self) -> int:
        return self.inner.batch()

    def total_examples(self) -> int:
        return self.inner.total_examples() // self.num_shards

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.total_outcomes()


class TestDataSetIterator:
    """Wrapping iterator counting invocations (test fixture; ≙
    datasets/test/TestDataSetIterator.java:102 — a fake that ships in the
    main tree because downstream modules reuse it)."""

    def __init__(self, inner):
        self.inner = inner
        self.batches_served = 0
        self.resets = 0

    def __iter__(self) -> Iterator[DataSet]:
        for d in self.inner:
            self.batches_served += 1
            yield d

    def reset(self) -> None:
        self.resets += 1
        self.inner.reset()

    def batch(self) -> int:
        return self.inner.batch()

    def total_examples(self) -> int:
        return self.inner.total_examples()

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.total_outcomes()


def moving_window(
    matrix: np.ndarray, window_rows: int, window_cols: int
) -> np.ndarray:
    """All (window_rows x window_cols) tiles of a 2-D array
    (≙ util/MovingWindowMatrix.java)."""
    r, c = matrix.shape
    out = []
    for i in range(0, r - window_rows + 1):
        for j in range(0, c - window_cols + 1):
            out.append(matrix[i : i + window_rows, j : j + window_cols])
    return np.stack(out)
