"""The port's copies of the reference's data pipeline (``datasets/``) and
evaluation give the JAX package's arrays and reports bit for bit: every
fetcher (MNIST's and LFW's synthetic stand-ins, Iris, CSV, curves), the
DataSet utilities, every iterator, and ``Evaluation``."""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import base as jbase
from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.datasets import iterators as jiterators
from deeplearning4j_tpu.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu_torch.datasets import base, fetchers, iterators
from deeplearning4j_tpu_torch.evaluation import Evaluation


def _same(a, b):
    assert a.features.dtype == b.features.dtype
    np.testing.assert_array_equal(a.features, b.features)
    if b.labels is None:
        assert a.labels is None
    else:
        assert a.labels.dtype == b.labels.dtype
        np.testing.assert_array_equal(a.labels, b.labels)


FETCHES = {
    "mnist_train": lambda m: m.mnist(n=300),
    "mnist_test_binarized": lambda m: m.mnist(train=False, n=100,
                                              binarize=True),
    "mnist_synthetic": lambda m: m.synthetic_mnist(64, seed=5, image_size=20),
    "lfw": lambda m: m.lfw(n=60),
    "lfw_default": lambda m: m.lfw(),
    "iris": lambda m: m.iris(),
    "iris_raw": lambda m: m.iris(one_hot=False, shuffle_seed=None),
    "curves": lambda m: m.curves(n=40, dim=50, seed=2),
}


@pytest.mark.parametrize("name", sorted(FETCHES))
def test_fetchers_give_the_reference_arrays(name, monkeypatch, tmp_path):
    # no local data: both packages take their synthetic stand-ins
    monkeypatch.setenv(fetchers.DATA_DIR_ENV, str(tmp_path))
    _same(FETCHES[name](fetchers), FETCHES[name](jfetchers))


def test_csv_and_idx_readers(tmp_path):
    rs = np.random.default_rng(0)
    rows = np.concatenate([rs.random((20, 3)), rs.integers(0, 4, (20, 1))], 1)
    path = tmp_path / "d.csv"
    np.savetxt(path, rows, delimiter=",", header="a,b,c,y", comments="")
    _same(fetchers.csv(path, label_column=3, skip_header=True),
          jfetchers.csv(path, label_column=3, skip_header=True))
    _same(fetchers.csv(path, skip_header=True),
          jfetchers.csv(path, skip_header=True))
    # MNIST idx files under the data directory are read as the reference's
    mnist_dir = tmp_path / "mnist"
    mnist_dir.mkdir()
    imgs = rs.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rs.integers(0, 10, 5, dtype=np.uint8)
    with open(mnist_dir / "train-images-idx3-ubyte", "wb") as f:
        f.write(bytes([0, 0, 8, 3]) + np.array([5, 28, 28], ">u4").tobytes()
                + imgs.tobytes())
    with open(mnist_dir / "train-labels-idx1-ubyte", "wb") as f:
        f.write(bytes([0, 0, 8, 1]) + np.array([5], ">u4").tobytes()
                + labels.tobytes())
    import os

    old = os.environ.get(fetchers.DATA_DIR_ENV)
    os.environ[fetchers.DATA_DIR_ENV] = str(tmp_path)
    try:
        _same(fetchers.mnist(), jfetchers.mnist())
    finally:
        if old is None:
            os.environ.pop(fetchers.DATA_DIR_ENV)
        else:
            os.environ[fetchers.DATA_DIR_ENV] = old


def _pair(n=37):
    rs = np.random.default_rng(3)
    x = rs.normal(size=(n, 6)).astype(np.float32)
    y = base.to_one_hot(rs.integers(0, 3, n), 3)
    return base.DataSet(x, y), jbase.DataSet(x, y)


def test_dataset_utilities():
    ds, jds = _pair()
    np.testing.assert_array_equal(base.to_one_hot(np.arange(5) % 3, 3),
                                  jbase.to_one_hot(np.arange(5) % 3, 3))
    for fn in (lambda d: d.shuffle(4), lambda d: d.sample(9, seed=2),
               lambda d: d.sample(9, seed=2, replace=False),
               lambda d: d.get_range(3, 11), lambda d: d.binarize(0.1),
               lambda d: d.normalize_zero_mean_unit_variance(),
               lambda d: d.scale_min_max(),
               lambda d: d.split_test_and_train(20)[1]):
        _same(fn(ds), fn(jds))
    for a, b in zip(ds.batches(8, drop_last=True), jds.batches(8, drop_last=True)):
        _same(a, b)
    _same(base.merge([ds, ds.get_range(0, 4)]),
          jbase.merge([jds, jds.get_range(0, 4)]))
    assert (ds.num_examples(), ds.num_inputs(), ds.num_outcomes()) == (
        jds.num_examples(), jds.num_inputs(), jds.num_outcomes())


ITERATORS = {
    "list": lambda m, d: m.ListDataSetIterator(d, 8),
    "sampling": lambda m, d: m.SamplingDataSetIterator(d, 5, 4, seed=1),
    "reconstruction": lambda m, d: m.ReconstructionDataSetIterator(
        m.ListDataSetIterator(d, 10)),
    "epochs": lambda m, d: m.MultipleEpochsIterator(
        2, m.ListDataSetIterator(d, 16)),
    "sharded": lambda m, d: m.ShardedDataSetIterator(
        m.ListDataSetIterator(d, 4), 1, 3),
    "counting": lambda m, d: m.TestDataSetIterator(m.ListDataSetIterator(d, 7)),
    "fetcher": lambda m, d: m.BaseDatasetIterator(
        6, 30, m.BaseDataFetcher(d)),
}


@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_iterators_give_the_reference_batches(name):
    ds, jds = _pair()
    it, jit = ITERATORS[name](iterators, ds), ITERATORS[name](jiterators, jds)
    for _ in range(2):  # a second pass after reset
        got, ref = list(it), list(jit)
        assert len(got) == len(ref) > 0
        for a, b in zip(got, ref):
            _same(a, b)
        it.reset()
        jit.reset()
    assert (it.batch(), it.total_examples(), it.input_columns(),
            it.total_outcomes()) == (jit.batch(), jit.total_examples(),
                                     jit.input_columns(), jit.total_outcomes())
    if name == "counting":
        assert (it.batches_served, it.resets) == (jit.batches_served,
                                                  jit.resets)


def test_moving_window():
    m = np.arange(30, dtype=np.float32).reshape(5, 6)
    np.testing.assert_array_equal(iterators.moving_window(m, 2, 3),
                                  jiterators.moving_window(m, 2, 3))


def test_evaluation_reports_are_the_reference():
    rs = np.random.default_rng(6)
    labels = base.to_one_hot(rs.integers(0, 4, 50), 4)
    probs = rs.random((50, 4)).astype(np.float32)
    ev, jev = Evaluation(4), JEvaluation(4)
    ev.eval(labels, probs)
    jev.eval(labels, probs)
    assert ev.stats() == jev.stats()
    assert (ev.accuracy(), ev.f1(), ev.precision(2), ev.recall(1)) == (
        jev.accuracy(), jev.f1(), jev.precision(2), jev.recall(1))
    np.testing.assert_array_equal(ev.confusion.counts, jev.confusion.counts)
    ev2, jev2 = Evaluation(), JEvaluation()
    ev2.eval(np.array([0, 2, 1, 2]), np.array([0, 1, 1, 2]))
    jev2.eval(np.array([0, 2, 1, 2]), np.array([0, 1, 1, 2]))
    assert ev2.stats() == jev2.stats()
