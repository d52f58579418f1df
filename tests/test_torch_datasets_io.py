"""The rest of the port's data pipeline against the JAX package's:
``datasets/records.py``, ``datasets/cloud.py``, ``datasets/image_loader.py``
(host IO, bitwise the reference's outputs), and ``native_io``'s loaders
(``read_idx``, ``shuffled_order``, ``NativeBatchAssembler``,
``PrefetchingLoader``) with ``PrefetchDataSetIterator``, held bit for bit
against the reference's NATIVE loader (``native/libdl4jtpu_io.so``) in
order, epoch labels and content, the exact-boundary epoch case included.
Where the native library cannot be built the reference comparisons skip;
the port's own cases still run against hard-coded orders of small seeds.
"""

import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import native_io as ref_io
from deeplearning4j_tpu.datasets import cloud as ref_cloud
from deeplearning4j_tpu.datasets import records as ref_records
from deeplearning4j_tpu.datasets.base import DataSet as RefDataSet
from deeplearning4j_tpu.datasets.image_loader import (
    ImageLoader as RefImageLoader,
)
from deeplearning4j_tpu.datasets.iterators import (
    PrefetchDataSetIterator as RefPrefetchIterator,
)
from deeplearning4j_tpu_torch import native_io
from deeplearning4j_tpu_torch.datasets.base import DataSet, to_one_hot
from deeplearning4j_tpu_torch.datasets.cloud import (
    CloudDataSetIterator,
    FlakyBucketClient,
    LocalBucketClient,
    RetryingBucketClient,
    TransientStorageError,
    upload_dataset_shards,
)
from deeplearning4j_tpu_torch.datasets.image_loader import ImageLoader
from deeplearning4j_tpu_torch.datasets.iterators import (
    PrefetchDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.records import (
    CSVRecordReader,
    ImageRecordReader,
    RecordReaderDataSetIterator,
    SVMLightRecordReader,
)

torch.set_num_threads(1)

native = pytest.mark.skipif(
    not ref_io.available(),
    reason="the reference's native loader does not build here (no g++); "
    "the port's own cases below still run")


def _same_batches(mine, theirs):
    mine, theirs = list(mine), list(theirs)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert np.asarray(a.features).dtype == np.asarray(b.features).dtype
        np.testing.assert_array_equal(a.features, b.features)
        if b.labels is None:
            assert a.labels is None
        else:
            np.testing.assert_array_equal(a.labels, b.labels)


# -- records (≙ RecordReaderDataSetIterator.java:48) -----------------------

_CSV = "f1,f2,label\n1.0,2.0,0\n3.0,4.0,1\n5.0,6.0,2\n7.0,8.0,1\n9.0,10.0,0\n"


def test_csv_record_reader_batches_and_one_hot(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text(_CSV)
    it = RecordReaderDataSetIterator(CSVRecordReader(p, skip_lines=1),
                                     batch_size=2, label_index=-1,
                                     num_classes=3)
    batches = list(it)
    assert [len(b.features) for b in batches] == [2, 2, 1]  # short tail
    np.testing.assert_array_equal(batches[0].features, [[1.0, 2.0],
                                                        [3.0, 4.0]])
    np.testing.assert_array_equal(batches[0].labels, [[1, 0, 0], [0, 1, 0]])
    it.reset()
    np.testing.assert_array_equal(next(iter(it)).features,
                                  batches[0].features)
    _same_batches(batches, ref_records.RecordReaderDataSetIterator(
        ref_records.CSVRecordReader(p, skip_lines=1), batch_size=2,
        label_index=-1, num_classes=3))


def test_csv_label_column_in_middle_and_unsupervised(tmp_path):
    p = tmp_path / "mid.csv"
    p.write_text("1,1,9\n0,2,8\n")
    for label_index, num_classes in ((0, 2), (None, None)):
        mine = RecordReaderDataSetIterator(
            CSVRecordReader(p), batch_size=2, label_index=label_index,
            num_classes=num_classes)
        _same_batches(mine, ref_records.RecordReaderDataSetIterator(
            ref_records.CSVRecordReader(p), batch_size=2,
            label_index=label_index, num_classes=num_classes))
    u = next(iter(RecordReaderDataSetIterator(CSVRecordReader(p),
                                              batch_size=2,
                                              label_index=None)))
    np.testing.assert_array_equal(u.features, u.labels)


def test_label_requires_num_classes():
    with pytest.raises(ValueError, match="num_classes"):
        RecordReaderDataSetIterator(CSVRecordReader("x.csv"), label_index=-1)


def test_svmlight_record_reader(tmp_path):
    p = tmp_path / "s.txt"
    p.write_text("1 1:0.5 3:2.0  # comment\n0 2:1.5\n\n")
    mine = RecordReaderDataSetIterator(
        SVMLightRecordReader(p, n_features=3), batch_size=2, label_index=-1,
        num_classes=2)
    b = next(iter(mine))
    np.testing.assert_allclose(b.features, [[0.5, 0, 2.0], [0, 1.5, 0]])
    np.testing.assert_array_equal(b.labels, [[0, 1], [1, 0]])
    _same_batches(mine, ref_records.RecordReaderDataSetIterator(
        ref_records.SVMLightRecordReader(p, n_features=3), batch_size=2,
        label_index=-1, num_classes=2))


def test_image_record_reader_directory_labels(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    for cls, shade in (("cats", 40), ("dogs", 200)):
        d = tmp_path / cls
        d.mkdir()
        for i in range(2):
            PIL.new("L", (4, 4), shade + i).save(d / f"{i}.png")
    reader = ImageRecordReader(tmp_path, width=4, height=4)
    assert reader.labels == ["cats", "dogs"]
    mine = RecordReaderDataSetIterator(reader, batch_size=4, label_index=-1,
                                       num_classes=2)
    b = next(iter(mine))
    assert b.features.shape == (4, 16)
    np.testing.assert_array_equal(np.argmax(b.labels, -1), [0, 0, 1, 1])
    _same_batches(mine, ref_records.RecordReaderDataSetIterator(
        ref_records.ImageRecordReader(tmp_path, width=4, height=4),
        batch_size=4, label_index=-1, num_classes=2))


# -- the image loader (≙ util/ImageLoader.java:21) -------------------------


def test_image_loader_roundtrip_equals_the_reference(tmp_path):
    pytest.importorskip("PIL.Image")
    img = np.linspace(0, 255, 28 * 28, dtype=np.float32).reshape(28, 28)
    path, ref_path = tmp_path / "x.png", tmp_path / "ref.png"
    ImageLoader.to_image(img, path)
    RefImageLoader.to_image(img, ref_path)
    assert path.read_bytes() == ref_path.read_bytes()
    loader, ref = ImageLoader(), RefImageLoader()
    m = loader.as_matrix(path)
    assert m.shape == (28, 28) and m.dtype == np.float32
    np.testing.assert_allclose(m, img, atol=1.0)
    np.testing.assert_array_equal(m, ref.as_matrix(path))
    np.testing.assert_array_equal(loader.as_row_vector(path),
                                  ref.as_row_vector(path))
    resized = ImageLoader(width=14, height=14).as_matrix(path)
    assert resized.shape == (14, 14)
    np.testing.assert_array_equal(
        resized, RefImageLoader(width=14, height=14).as_matrix(path))
    batches = loader.as_mini_batches(path, 4, 7)
    assert len(batches) == 4 and all(b.shape == (7, 28) for b in batches)
    for a, b in zip(batches, ref.as_mini_batches(path, 4, 7)):
        np.testing.assert_array_equal(a, b)


# -- cloud datasets (≙ BucketIterator / BaseS3DataSetIterator) -------------


def _ds(seed, n, d, k):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, d)).astype(np.float32),
                   to_one_hot(rng.integers(0, k, n), k))


def test_cloud_dataset_iterator_roundtrip(tmp_path):
    ds = _ds(4, 40, 6, 3)
    client = LocalBucketClient(tmp_path / "bucket")
    keys = upload_dataset_shards(client, ds, batch_size=10)
    assert len(keys) == 4
    it = CloudDataSetIterator(client)
    parts = list(it)
    assert len(parts) == 4
    np.testing.assert_array_equal(
        np.concatenate([p.features for p in parts]), ds.features)
    it2 = CloudDataSetIterator(
        client, preprocessor=lambda d: DataSet(d.features * 2.0, d.labels))
    np.testing.assert_array_equal(next(iter(it2)).features,
                                  ds.features[:10] * 2.0)
    it2.reset()
    assert it2.has_next()


def test_cloud_blobs_cross_the_packages_bitwise(tmp_path):
    """The port's npz shards are the reference's: each package reads the
    other's bucket, and the two uploads are the same objects."""
    ds = _ds(6, 25, 4, 2)
    mine = LocalBucketClient(tmp_path / "port")
    theirs = ref_cloud.LocalBucketClient(tmp_path / "ref")
    keys = upload_dataset_shards(mine, ds, batch_size=10)
    ref_keys = ref_cloud.upload_dataset_shards(
        theirs, RefDataSet(ds.features, ds.labels), batch_size=10)
    assert keys == ref_keys
    for k in keys:
        assert mine.get(k) == theirs.get(k)
    _same_batches(CloudDataSetIterator(theirs),
                  ref_cloud.CloudDataSetIterator(theirs))
    _same_batches(CloudDataSetIterator(mine),
                  ref_cloud.CloudDataSetIterator(mine))


def test_retrying_client_survives_faults_and_partial_reads(tmp_path):
    ds = _ds(5, 30, 5, 2)
    naps = []
    store = LocalBucketClient(tmp_path / "b")
    writer = RetryingBucketClient(FlakyBucketClient(store, fail_times=2),
                                  sleep=naps.append)
    keys = upload_dataset_shards(writer, ds, batch_size=10)
    assert len(keys) == 3 and len(naps) >= 2
    reader_a = RetryingBucketClient(
        FlakyBucketClient(store, fail_times=0, truncate_first=True),
        sleep=naps.append)
    before = reader_a.attempts
    parts = list(CloudDataSetIterator(reader_a))
    np.testing.assert_array_equal(
        np.concatenate([p.features for p in parts]), ds.features)
    assert reader_a.attempts - before >= 2 * len(keys)
    reader = RetryingBucketClient(
        FlakyBucketClient(store, fail_times=1, truncate_first=True),
        sleep=naps.append)
    assert reader.list_keys() == keys  # sidecars hidden
    parts = list(CloudDataSetIterator(reader))
    np.testing.assert_array_equal(
        np.concatenate([p.features for p in parts]), ds.features)
    dead = RetryingBucketClient(FlakyBucketClient(store, fail_times=99),
                                retries=2, sleep=naps.append)
    with pytest.raises(ConnectionError):
        dead.get(keys[0])
    store.put(keys[0], b"garbage-not-the-original")
    corrupt = RetryingBucketClient(store, retries=1, sleep=naps.append)
    with pytest.raises(TransientStorageError, match="checksum"):
        corrupt.get(keys[0])


# -- read_idx --------------------------------------------------------------


def _idx(path, arr, dtype=0x08):
    with open(path, "wb") as fh:
        fh.write(struct.pack(">HBB", 0, dtype, arr.ndim))
        fh.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        fh.write(arr.tobytes())


@pytest.mark.parametrize("shape", [(50, 12), (7,), (3, 4, 5)])
def test_read_idx_reads_uint8_payloads(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "f-idx-ubyte"
    _idx(p, arr)
    got = native_io.read_idx(p)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, arr)
    if ref_io.available():
        np.testing.assert_array_equal(got, ref_io.read_idx(p))


def test_read_idx_refuses_what_the_native_reader_refuses(tmp_path):
    p = tmp_path / "f32"
    _idx(p, np.zeros((2, 2), np.float32), dtype=0x0D)
    with pytest.raises(OSError, match="rc=-3"):
        native_io.read_idx(p)
    if ref_io.available():
        with pytest.raises(OSError, match="rc=-3"):
            ref_io.read_idx(p)
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01")
    with pytest.raises(OSError, match="rc=-2"):
        native_io.read_idx(bad)


# -- the loaders' order, labels and content --------------------------------


def test_shuffled_order_hard_coded():
    """The Fisher-Yates pass on splitmix64 of the C loader, for small
    seeds (the native library's outputs, written down)."""
    assert native_io.shuffled_order(10, 7).tolist() == [
        8, 1, 5, 9, 0, 4, 3, 2, 6, 7]
    assert native_io.shuffled_order(12, 2024).tolist() == [
        3, 10, 9, 6, 4, 5, 0, 2, 7, 11, 8, 1]
    assert native_io.shuffled_order(1, 5).tolist() == [0]


def test_prefetcher_order_hard_coded():
    """Six rows, batch 4, seed 3: the C prefetcher's rows (each row's
    label is its index) and epoch labels, written down."""
    f = np.arange(12, dtype=np.uint8).reshape(6, 2)
    loader = native_io.PrefetchingLoader(f, np.arange(6, dtype=np.uint8), 6,
                                         4, seed=3, depth=2, device="cpu")
    got = []
    for _ in range(4):
        x, y, e = loader.next_batch()
        got.append((y.argmax(1).tolist(), e))
    loader.close()
    assert got == [([2, 1, 0, 3], 0), ([5, 4, 2, 3], 0), ([1, 4, 0, 5], 1),
                   ([0, 2, 5, 3], 2)]


@native
@pytest.mark.parametrize("n,seed", [(50, 7), (2, 0), (1000, 123456789)])
def test_shuffled_order_equals_the_native_loader(n, seed):
    np.testing.assert_array_equal(native_io.shuffled_order(n, seed),
                                  ref_io.shuffled_order(n, seed))


@native
def test_batch_assembler_equals_the_native_loader():
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 256, (50, 12), dtype=np.uint8)
    labels = rng.integers(0, 4, 50, dtype=np.uint8)
    asm = native_io.NativeBatchAssembler(feats, labels, num_classes=4,
                                         seed=7, device="cpu")
    ref = ref_io.NativeBatchAssembler(feats, labels, num_classes=4, seed=7)
    np.testing.assert_array_equal(asm.order, ref.order)
    for start, size in ((0, 8), (8, 8), (45, 5)):
        x, y = asm.batch(start, size)
        rx, ry = ref.batch(start, size)
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), rx)
        np.testing.assert_array_equal(y.numpy(), ry)


def test_batch_assembler_content():
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 256, (50, 12), dtype=np.uint8)
    labels = rng.integers(0, 4, 50, dtype=np.uint8)
    asm = native_io.NativeBatchAssembler(feats, labels, num_classes=4,
                                         seed=7, device="cpu")
    x, y = asm.batch(0, 8)
    sel = asm.order[:8]
    np.testing.assert_array_equal(
        x.numpy(), feats[sel].astype(np.float32) / np.float32(255))
    assert (y.numpy().argmax(1) == labels[sel]).all()


@native
@pytest.mark.parametrize("n,row,batch,steps,depth", [
    (20, 6, 8, 12, 2),      # wraps mid-batch, > 4 epochs
    (40, 2, 10, 8, 2),      # the exact-boundary case
    (7, 3, 5, 9, 1),        # a batch spanning two epoch boundaries
    (300, 784, 64, 12, 4),  # MNIST's row width
])
def test_prefetching_loader_equals_the_native_loader(n, row, batch, steps,
                                                     depth):
    rng = np.random.default_rng(n)
    feats = rng.integers(0, 256, (n, row), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    mine = native_io.PrefetchingLoader(feats, labels, 10, batch, seed=5,
                                       depth=depth, device="cpu")
    ref = ref_io.PrefetchingLoader(feats, labels, 10, batch, seed=5,
                                   depth=depth)
    try:
        for _ in range(steps):
            x, y, e = mine.next_batch()
            rx, ry, re = ref.next_batch()
            assert e == re
            np.testing.assert_array_equal(x.numpy(), rx)
            np.testing.assert_array_equal(y.numpy(), ry)
    finally:
        mine.close()
        ref.close()


def test_prefetcher_epoch_label_at_exact_boundary():
    """n divisible by batch: every batch is labeled with the epoch its
    rows came from; a closed loader raises."""
    feats = np.arange(40 * 2, dtype=np.uint8).reshape(40, 2)
    loader = native_io.PrefetchingLoader(feats, np.zeros(40, np.uint8), 2,
                                         10, seed=0, depth=2, device="cpu")
    eps = [loader.next_batch()[2] for _ in range(8)]
    assert eps == [0, 0, 0, 0, 1, 1, 1, 1], eps
    loader.close()
    with pytest.raises(RuntimeError):
        loader.next_batch()


def test_prefetching_loader_epochs_and_content():
    rng = np.random.default_rng(1)
    feats = rng.integers(0, 256, (20, 6), dtype=np.uint8)
    labels = rng.integers(0, 3, 20, dtype=np.uint8)
    loader = native_io.PrefetchingLoader(feats, labels, num_classes=3,
                                         batch_size=8, seed=3, depth=2,
                                         device="cpu")
    label_of = {feats[i].tobytes(): labels[i] for i in range(20)}
    seen_epochs, per_epoch = set(), {}
    for _ in range(12):  # 12*8 rows > 4 epochs of 20
        x, y, ep = loader.next_batch()
        x, y = x.numpy(), y.numpy()
        assert x.shape == (8, 6) and y.shape == (8, 3)
        assert x.min() >= 0.0 and x.max() <= 1.0
        seen_epochs.add(ep)
        for r in range(8):
            row_u8 = np.round(x[r] * 255.0).astype(np.uint8).tobytes()
            assert y[r].argmax() == label_of[row_u8] and y[r].sum() == 1.0
    loader.close()
    assert len(seen_epochs) >= 2, "epoch counter never advanced"


def test_out_of_range_labels_one_hot_to_zeros():
    feats = np.zeros((4, 2), np.uint8)
    loader = native_io.PrefetchingLoader(
        feats, np.array([0, 1, 7, 2], np.uint8), 3, 4, device="cpu")
    y = loader.next_batch()[1].numpy()
    assert sorted(y.sum(1).tolist()) == [0.0, 1.0, 1.0, 1.0]


@native
def test_prefetch_iterator_equals_the_reference():
    rng = np.random.default_rng(9)
    feats = rng.integers(0, 256, (45, 3, 4), dtype=np.uint8)
    labels = rng.integers(0, 5, 45, dtype=np.uint8)
    mine = PrefetchDataSetIterator(feats, labels, 5, 10, seed=2, depth=2,
                                   device="cpu")
    ref = RefPrefetchIterator(feats, labels, 5, 10, seed=2, depth=2)
    try:
        for _ in range(2):  # two passes: the stream wraps and reshuffles
            got = list(mine)
            assert len(got) == 4
            _same_batches([DataSet(d.features.numpy(), d.labels.numpy())
                           for d in got], list(ref))
    finally:
        mine.close()
        ref.close()
    assert (mine.batch(), mine.total_examples(), mine.input_columns(),
            mine.total_outcomes()) == (10, 45, 12, 5)


def test_prefetch_iterator_feeds_a_network_on_its_device():
    """The iterator's device batches go straight into
    ``MultiLayerNetwork.fit`` (a DataSet keeps torch tensors)."""
    from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import conf as C

    rng = np.random.default_rng(3)
    feats = rng.integers(0, 256, (64, 8), dtype=np.uint8)
    labels = rng.integers(0, 3, 64, dtype=np.uint8)
    it = PrefetchDataSetIterator(feats, labels, 3, 16, device="cpu")
    conf = C.list_builder(C.LayerConfig(activation="tanh"), sizes=[6],
                          n_in=8, n_out=3, pretrain=False, backward=True)
    net = MultiLayerNetwork(conf, seed=0, device="cpu")
    net.init()
    before = np.array(net.params_vector())
    net.fit(it)
    it.close()
    assert not np.array_equal(before, np.asarray(net.params_vector()))
    ds = next(iter(PrefetchDataSetIterator(feats, labels, 3, 16,
                                           device="cpu")))
    assert isinstance(ds.features, torch.Tensor) and ds.num_examples() == 16
