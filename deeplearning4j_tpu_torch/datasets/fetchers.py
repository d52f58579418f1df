"""Dataset fetchers: Iris, MNIST, LFW, CSV, synthetic curves (the port's
copy of the JAX package's ``datasets/fetchers.py``: the same arrays, bit
for bit).

≙ reference ``datasets/fetchers`` + ``base`` loaders
(IrisDataFetcher.java:40, MnistDataFetcher.java:152 + idx readers in
datasets/mnist/, LFWDataFetcher.java:75 + base/LFWLoader.java:198,
CSVDataSetFetcher, CurvesDataFetcher).  Fetchers produce host-side
``DataSet``s; downloads are *gated* (this environment has zero egress —
readers accept local paths via ``DL4J_TPU_DATA_DIR`` and fall back to
deterministic synthetic data so every pipeline stays testable offline).
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.datasets.base import DataSet, to_one_hot

DATA_DIR_ENV = "DL4J_TPU_DATA_DIR"


def data_dir() -> Path:
    return Path(os.environ.get(DATA_DIR_ENV, Path.home() / ".dl4j_tpu" / "data"))


class BaseDataFetcher:
    """≙ datasets/fetchers/BaseDataFetcher.java:113 — cursor over a DataSet."""

    def __init__(self, dataset: DataSet):
        self._data = dataset
        self.cursor = 0

    def total_examples(self) -> int:
        return self._data.num_examples()

    def input_columns(self) -> int:
        return self._data.num_inputs()

    def total_outcomes(self) -> int:
        return self._data.num_outcomes()

    def has_more(self) -> bool:
        return self.cursor < self.total_examples()

    def fetch(self, num: int) -> DataSet:
        batch = self._data.get_range(self.cursor, min(self.cursor + num, self.total_examples()))
        self.cursor += batch.num_examples()
        return batch

    def reset(self) -> None:
        self.cursor = 0


# -- Iris ---------------------------------------------------------------------

def iris(one_hot: bool = True, shuffle_seed: int | None = 123) -> DataSet:
    """The Iris dataset (real data via sklearn's bundled copy).

    ≙ IrisDataFetcher.java:40 + IrisUtils — the reference's de-facto
    acceptance dataset (MultiLayerTest.java:79-116).
    """
    from sklearn.datasets import load_iris

    raw = load_iris()
    x = raw["data"].astype(np.float32)
    y = raw["target"]
    ds = DataSet(x, to_one_hot(y, 3) if one_hot else y)
    if shuffle_seed is not None:
        ds = ds.shuffle(shuffle_seed)
    return ds


class IrisDataFetcher(BaseDataFetcher):
    NUM_EXAMPLES = 150

    def __init__(self):
        super().__init__(iris())


# -- MNIST --------------------------------------------------------------------

def _read_idx(path: Path) -> np.ndarray:
    """idx-format reader (≙ datasets/mnist/MnistManager.java:130 + db readers)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad idx magic")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {
            0x08: np.uint8,
            0x09: np.int8,
            0x0B: np.int16,
            0x0C: np.int32,
            0x0D: np.float32,
            0x0E: np.float64,
        }[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


def synthetic_mnist(
    n: int = 2048, seed: int = 0, image_size: int = 28
) -> DataSet:
    """Deterministic MNIST-shaped stand-in for offline environments.

    Ten structured class prototypes (oriented bar/blob patterns) plus
    pixel noise — enough signal that a correct model separates classes
    and a broken one does not.  Not a replacement for real MNIST numbers;
    benchmarks measure throughput, which is data-independent.
    """
    rng = np.random.default_rng(seed)
    s = image_size
    protos = np.zeros((10, s, s), dtype=np.float32)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / (s - 1)
    for c in range(10):
        angle = c * np.pi / 10
        stripe = np.sin(2 * np.pi * (np.cos(angle) * xx + np.sin(angle) * yy) * (2 + c % 3))
        cx, cy = 0.3 + 0.4 * ((c * 7) % 10) / 9, 0.3 + 0.4 * ((c * 3) % 10) / 9
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
        protos[c] = np.clip(0.5 * (stripe * 0.5 + 0.5) + blob, 0, 1)
    labels = rng.integers(0, 10, n)
    imgs = protos[labels] + rng.normal(0, 0.15, (n, s, s)).astype(np.float32)
    imgs = np.clip(imgs, 0, 1).astype(np.float32)
    return DataSet(imgs.reshape(n, s * s), to_one_hot(labels, 10))


def mnist(
    train: bool = True,
    n: int | None = None,
    binarize: bool = False,
    allow_synthetic: bool = True,
) -> DataSet:
    """MNIST from local idx files, else deterministic synthetic fallback.

    ≙ MnistDataFetcher.java:152 (which downloads via MnistFetcher; this
    environment has no egress, so files must be pre-placed under
    ``$DL4J_TPU_DATA_DIR/mnist/``).
    """
    d = data_dir() / "mnist"
    stem = "train" if train else "t10k"
    img_candidates = [d / f"{stem}-images-idx3-ubyte", d / f"{stem}-images-idx3-ubyte.gz"]
    lbl_candidates = [d / f"{stem}-labels-idx1-ubyte", d / f"{stem}-labels-idx1-ubyte.gz"]
    img_path = next((p for p in img_candidates if p.exists()), None)
    lbl_path = next((p for p in lbl_candidates if p.exists()), None)
    if img_path and lbl_path:
        imgs = _read_idx(img_path).astype(np.float32) / 255.0
        labels = _read_idx(lbl_path)
        ds = DataSet(imgs.reshape(imgs.shape[0], -1), to_one_hot(labels, 10))
    elif allow_synthetic:
        ds = synthetic_mnist(n or (8192 if train else 2048), seed=0 if train else 1)
    else:
        raise FileNotFoundError(
            f"MNIST idx files not found under {d}; set ${DATA_DIR_ENV} or pass allow_synthetic=True"
        )
    if n is not None:
        ds = ds.get_range(0, n)
    if binarize:
        ds = ds.binarize()
    return ds


class MnistDataFetcher(BaseDataFetcher):
    def __init__(self, binarize: bool = False, n: int | None = None):
        super().__init__(mnist(train=True, n=n, binarize=binarize))


# -- LFW (faces) --------------------------------------------------------------

def lfw(
    n: int | None = None, image_size: int = 28, allow_synthetic: bool = True
) -> DataSet:
    """LFW faces from a local directory tree (person-per-subdir), else
    synthetic face-like blobs.  ≙ LFWDataFetcher.java:75 / base/LFWLoader.java:198.
    """
    d = data_dir() / "lfw"
    if d.exists():
        from PIL import Image

        people = sorted(p for p in d.iterdir() if p.is_dir())
        feats, labels = [], []
        for idx, person in enumerate(people):
            for img_file in sorted(person.glob("*.jpg")):
                img = Image.open(img_file).convert("L").resize((image_size, image_size))
                feats.append(np.asarray(img, dtype=np.float32).reshape(-1) / 255.0)
                labels.append(idx)
        ds = DataSet(np.stack(feats), to_one_hot(np.array(labels), len(people)))
    elif allow_synthetic:
        rng = np.random.default_rng(7)
        classes = 5
        s = image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / (s - 1)
        protos = []
        for c in range(classes):
            cx = 0.35 + 0.3 * c / classes
            face = np.exp(-(((xx - cx) ** 2 + (yy - 0.45) ** 2) / 0.06))
            eyes = np.exp(-(((xx - cx + 0.1) ** 2 + (yy - 0.35) ** 2) / 0.004))
            eyes += np.exp(-(((xx - cx - 0.1) ** 2 + (yy - 0.35) ** 2) / 0.004))
            protos.append(np.clip(face + 0.8 * eyes, 0, 1))
        protos = np.stack(protos)
        total = n or 500
        labels = rng.integers(0, classes, total)
        imgs = protos[labels] + rng.normal(0, 0.1, (total, s, s)).astype(np.float32)
        ds = DataSet(
            np.clip(imgs, 0, 1).reshape(total, -1).astype(np.float32),
            to_one_hot(labels, classes),
        )
    else:
        raise FileNotFoundError(f"LFW directory not found under {d}")
    if n is not None:
        ds = ds.get_range(0, min(n, ds.num_examples()))
    return ds


class LFWDataFetcher(BaseDataFetcher):
    def __init__(self, n: int | None = None):
        super().__init__(lfw(n=n))


# -- CSV ----------------------------------------------------------------------

def csv(
    path: str | Path,
    label_column: int | None = None,
    num_classes: int | None = None,
    skip_header: bool = False,
    delimiter: str = ",",
) -> DataSet:
    """CSV loader (≙ CSVDataSetFetcher / datasets/canova record reading)."""
    raw = np.genfromtxt(
        path, delimiter=delimiter, skip_header=1 if skip_header else 0, dtype=np.float64
    )
    if raw.ndim == 1:
        raw = raw[None, :]
    if label_column is None:
        return DataSet(raw.astype(np.float32), None)
    labels = raw[:, label_column].astype(np.int64)
    feats = np.delete(raw, label_column, axis=1).astype(np.float32)
    k = num_classes or int(labels.max()) + 1
    return DataSet(feats, to_one_hot(labels, k))


class CSVDataFetcher(BaseDataFetcher):
    def __init__(self, path, label_column=None, num_classes=None, **kw):
        super().__init__(csv(path, label_column, num_classes, **kw))


# -- Curves (synthetic, ≙ CurvesDataFetcher) ---------------------------------

def curves(n: int = 1000, dim: int = 784, seed: int = 0) -> DataSet:
    """Smooth random curves rasterized to vectors — unsupervised pretraining
    fodder (≙ CurvesDataFetcher.java:87, which downloads a fixed file)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, dim, dtype=np.float32)
    coeffs = rng.normal(0, 1, (n, 4)).astype(np.float32)
    x = (
        coeffs[:, 0:1] * np.sin(2 * np.pi * t)
        + coeffs[:, 1:2] * np.cos(2 * np.pi * t)
        + coeffs[:, 2:3] * np.sin(4 * np.pi * t)
        + coeffs[:, 3:4] * np.cos(4 * np.pi * t)
    )
    x = (x - x.min(axis=1, keepdims=True)) / (np.ptp(x, axis=1).reshape(-1, 1) + 1e-8)
    return DataSet(x.astype(np.float32), None)
