"""Data pipeline of the port (numpy only): DataSet container, fetchers,
iterators (the JAX package's ``datasets/``)."""

from deeplearning4j_tpu_torch.datasets.base import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    BaseDatasetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    PrefetchDataSetIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
    TestDataSetIterator,
)
