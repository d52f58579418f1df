"""Generic record-reader bridge — arbitrary record sources to DataSets.

≙ the reference's Canova bridge
(deeplearning4j-core/datasets/canova/RecordReaderDataSetIterator.java:48
adapting org.canova RecordReader implementations): any iterator of flat
records becomes a batched :class:`~deeplearning4j_tpu_torch.datasets.base.
DataSet` stream with an optional label column one-hot encoded
(FeatureUtil.toOutcomeVector). Readers provided for the three formats
the Canova ecosystem covered in practice: CSV, SVMLight sparse text,
and directory-per-class image trees.

Unlike the reference (whose next(num) crashes mid-batch when the source
drains — recordReader.next() past the end), the iterator returns a
short final batch.

The port's copy of ``deeplearning4j_tpu/datasets/records.py`` (host IO: no torch).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Protocol, Sequence, runtime_checkable

import numpy as np

from deeplearning4j_tpu_torch.datasets.base import DataSet, to_one_hot


@runtime_checkable
class RecordReader(Protocol):
    """A resettable source of flat numeric records.

    ≙ org.canova.api.records.reader.RecordReader (next/hasNext/reset),
    pythonified: iteration yields one record (a 1-D float sequence) at a
    time; ``reset()`` rewinds to the first record.
    """

    def __iter__(self) -> Iterator[Sequence[float]]: ...

    def reset(self) -> None: ...


class CSVRecordReader:
    """Comma/char-separated text records (≙ canova CSVRecordReader).

    ``skip_lines`` drops a header; blank lines are ignored. Values must
    be numeric — a labelled column is still numeric (the class index),
    exactly as the reference's Writable.toString -> Double path required.
    """

    def __init__(self, path: str | Path, delimiter: str = ",",
                 skip_lines: int = 0):
        self.path = Path(path)
        self.delimiter = delimiter
        self.skip_lines = skip_lines

    def __iter__(self):
        with open(self.path) as f:
            for i, line in enumerate(f):
                if i < self.skip_lines:
                    continue
                line = line.strip()
                if not line:
                    continue
                yield [float(v) for v in line.split(self.delimiter)]

    def reset(self) -> None:  # stateless: __iter__ reopens the file
        pass


class SVMLightRecordReader:
    """SVMLight / LibSVM sparse text records (``label idx:val ...``).

    ≙ canova SVMLightRecordReader. Indices are 1-based per the format;
    the label is emitted as the LAST element so the default
    ``label_index=-1`` convention picks it up. The standard LibSVM
    binary convention labels classes -1/+1: -1 maps to class 0 (a raw
    -1 would silently one-hot into the LAST class via negative
    indexing). ``label_map`` overrides for other schemes.
    """

    def __init__(self, path: str | Path, n_features: int,
                 label_map: dict[float, float] | None = None):
        self.path = Path(path)
        self.n_features = n_features
        self.label_map = {-1.0: 0.0} if label_map is None else label_map

    def __iter__(self):
        with open(self.path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                row = np.zeros(self.n_features + 1, np.float32)
                raw = float(parts[0])
                row[-1] = self.label_map.get(raw, raw)
                for kv in parts[1:]:
                    idx, val = kv.split(":")
                    j = int(idx) - 1
                    if not 0 <= j < self.n_features:
                        # an unchecked index would silently overwrite
                        # the label slot (0-based files, or indices past
                        # n_features)
                        raise ValueError(
                            f"feature index {idx} outside 1..="
                            f"{self.n_features} (SVMLight indices are "
                            "1-based)"
                        )
                    row[j] = float(val)
                yield row

    def reset(self) -> None:
        pass


class ImageRecordReader:
    """Directory-per-class image tree records (≙ canova ImageRecordReader:
    features are the flattened pixels, the label — appended last — is the
    sorted index of the containing directory).

    ``loader`` defaults to the framework's
    :class:`~deeplearning4j_tpu_torch.datasets.image_loader.ImageLoader`
    (optionally resizing); any object with ``as_row_vector(path)`` works.
    """

    def __init__(self, root: str | Path, width: int | None = None,
                 height: int | None = None,
                 extensions: tuple = (".png", ".jpg", ".jpeg", ".bmp"),
                 loader=None):
        from deeplearning4j_tpu_torch.datasets.image_loader import ImageLoader

        self.root = Path(root)
        self.loader = loader or ImageLoader(width=width, height=height)
        self.labels = sorted(
            d.name for d in self.root.iterdir() if d.is_dir()
        )
        self._files = [
            (p, li)
            for li, lbl in enumerate(self.labels)
            for p in sorted((self.root / lbl).iterdir())
            if p.suffix.lower() in extensions
        ]

    def __iter__(self):
        for path, label_idx in self._files:
            vec = np.asarray(
                self.loader.as_row_vector(path), np.float32
            ).ravel()
            yield np.concatenate([vec, [np.float32(label_idx)]])

    def reset(self) -> None:
        pass


class RecordReaderDataSetIterator:
    """Batched DataSets from any :class:`RecordReader`.

    ≙ RecordReaderDataSetIterator.java:48-90: ``label_index`` (or -1 for
    the last column; None for unsupervised — the reference's labelIndex
    < 0 path, where labels = features) is popped from each record and
    one-hot encoded over ``num_classes``.
    """

    def __init__(self, reader: RecordReader, batch_size: int = 10,
                 label_index: int | None = -1,
                 num_classes: int | None = None):
        if label_index is not None and not num_classes:
            raise ValueError(
                "num_classes must be >= 1 when a label column is set "
                "(reference: 'Number of possible labels invalid')"
            )
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self._it = iter(reader)

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        feats, labels = [], []
        for _ in range(self.batch_size):
            try:
                rec = np.asarray(next(self._it), np.float32).ravel()
            except StopIteration:
                break
            if self.label_index is None:
                feats.append(rec)
            else:
                if not -len(rec) <= self.label_index < len(rec):
                    # the reference java iterator throws on an invalid
                    # label index; a silent modulo wrap would train on a
                    # wrong column
                    raise IndexError(
                        f"label_index {self.label_index} out of range "
                        f"for a {len(rec)}-column record"
                    )
                li = self.label_index % len(rec)
                label = int(rec[li])
                if not 0 <= label < self.num_classes:
                    raise ValueError(
                        f"label {label} outside [0, {self.num_classes}) "
                        "— check label_index/num_classes (and label "
                        "conventions: SVMLightRecordReader maps -1 -> 0)"
                    )
                labels.append(label)
                feats.append(np.delete(rec, li))
        if not feats:
            raise StopIteration
        x = np.stack(feats)
        if self.label_index is None:
            # unsupervised: labels mirror features (the reference's
            # labelIndex < 0 branch builds DataSet(features, features))
            return DataSet(x, x)
        return DataSet(x, to_one_hot(np.asarray(labels), self.num_classes))

    def reset(self) -> None:
        self.reader.reset()
        self._it = iter(self.reader)
