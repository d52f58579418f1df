"""The data loaders and the text helpers of the JAX package's
``native_io.py`` (its C++ library ``native/libdl4jtpu_io.so`` with numpy
fallbacks), in the port's own form.

- The Word2Vec helpers: ``sg_pairs_chunk`` (vectorized numpy that yields
  the C++ pass's pairs element for element) and ``count_vocab`` (the
  reference's pure-Python path, which yields the native counter's
  vocabulary).
- The batch loaders: ``read_idx``, ``shuffled_order``,
  ``NativeBatchAssembler`` and ``PrefetchingLoader``. Their order and
  content are the reference's NATIVE loader's, bit for bit (not its numpy
  fallback's): the Fisher-Yates shuffle on splitmix64
  (``native/dataloader.cpp:80-86``), each epoch of the prefetcher
  reshuffled from ``seed + epoch * 0x9E3779B97F4A7C15 + 1``
  (``native/pipeline.cpp:49-53``), batches that wrap across epochs, and
  the epoch label of a batch's first row after any wrap
  (``pipeline.cpp:62-69``). The design is the card's: the uint8 table
  goes to the loader's device once; each batch is a gather of its rows, a
  lookup of ``i / 255`` (the C loader's float division) and a one-hot, on
  that device, queued up to ``depth`` batches ahead in stream order, so
  the next batch is ready while the step runs. There is one code path:
  the device is ``resolve_device``'s, the card unless the caller names
  the CPU.
"""

from __future__ import annotations

import re
from collections import Counter, deque
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device, upload

# splitmix64 (native/splitmix64.h): state += GOLD, then two xor-shift
# multiplies and a final xor-shift
_GOLD = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def splitmix64(seed: int, n: int) -> np.ndarray:
    """The first ``n`` draws of the splitmix64 stream seeded with ``seed``.
    The generator is counter-based: draw k (from 1) mixes seed + k * GOLD,
    so the whole stream is one vectorized pass (uint64 arithmetic wraps
    modulo 2**64, as in C)."""
    z = np.uint64(seed) + np.arange(1, n + 1, dtype=np.uint64) * _GOLD
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def sg_pairs_chunk(
    sentences: list[np.ndarray], window: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Skip-gram (input, target) pairs for a chunk of encoded sentences.

    For word i of a sentence of n >= 2 words, b = draw % window and
    span = window - b; every other word j of the sentence with
    |j - i| <= span gives the pair (word j, word i), in order of i, then j.
    Every word of the chunk takes one draw, those of sentences shorter than
    2 included, so the pairs equal the reference's C++ pass (and its numpy
    fallback) element for element.
    """
    if not sentences or window <= 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    ids = np.concatenate(sentences).astype(np.int32)
    lens = np.array([len(s) for s in sentences], np.int64)
    starts = np.cumsum(lens) - lens
    n = len(ids)
    span = window - (splitmix64(seed, n) % np.uint64(window)).astype(np.int64)
    sent = np.repeat(np.arange(len(sentences)), lens)
    start, slen = starts[sent], lens[sent]
    pos = np.arange(n) - start
    lo = np.maximum(0, pos - span)
    hi = np.minimum(slen, pos + span + 1)
    # pairs per centre word: its window minus itself
    cnt = np.where(slen >= 2, hi - lo - 1, 0)
    centre = np.repeat(np.arange(n), cnt)
    k = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    j = lo[centre] + k
    j += j >= pos[centre]  # step over the centre itself
    return ids[start[centre] + j], ids[centre]


# the native counter's token characters: ASCII alphanumerics, the
# apostrophe and any non-ASCII codepoint; only A-Z are lowercased
_TOKEN = re.compile(r"[A-Za-z0-9'\u0080-\U0010ffff]+")
_ASCII_LOWER = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz"
)


def count_vocab(
    texts, min_count: int = 1, lowercase: bool = True
) -> tuple[list[str], np.ndarray, int]:
    """Tokenize and count words. Returns (words sorted by count, then by
    word; their counts; the total token count)."""
    c: Counter = Counter()
    total = 0
    for t in texts:
        toks = _TOKEN.findall(t.translate(_ASCII_LOWER) if lowercase else t)
        total += len(toks)
        c.update(toks)
    items = sorted(
        ((w, n) for w, n in c.items() if n >= min_count),
        key=lambda kv: (-kv[1], kv[0]),
    )
    words = [w for w, _ in items]
    return words, np.array([n for _, n in items], np.int64), total


# -- the batch loaders --------------------------------------------------------

def read_idx(path: str | Path) -> np.ndarray:
    """An IDX file's uint8 payload in its shape: the native reader's
    contract (``native/dataloader.cpp`` ``read_idx``): uint8 data (type
    0x08) of rank at most 8, else ``OSError`` with the native code."""
    with open(path, "rb") as f:
        head = f.read(4)
        if len(head) != 4 or head[0] != 0 or head[1] != 0:
            raise OSError(f"read_idx({path}) failed rc=-2")
        dtype, rank = head[2], head[3]
        if rank > 8 or dtype != 0x08:
            raise OSError(f"read_idx({path}) failed rc=-3")
        raw = f.read(4 * rank)
        if len(raw) != 4 * rank:
            raise OSError(f"read_idx({path}) failed rc=-4")
        dims = tuple(int.from_bytes(raw[4 * i:4 * i + 4], "big")
                     for i in range(rank))
        count = int(np.prod(dims, dtype=np.int64))
        data = f.read(count)
        if len(data) != count:
            raise OSError(f"read_idx({path}) failed rc=-6")
    return np.frombuffer(data, dtype=np.uint8).reshape(dims).copy()


def _fisher_yates(order: np.ndarray, state: int) -> np.ndarray:
    """The C loader's in-place Fisher-Yates pass (``shuffle_indices``):
    for i from n-1 down to 1, j = next splitmix64 draw % (i + 1), swap."""
    n = len(order)
    if n < 2:
        return order
    draws = splitmix64(state, n - 1)
    js = (draws % np.arange(n, 1, -1, dtype=np.uint64)).tolist()
    out = order.tolist()
    for i, j in zip(range(n - 1, 0, -1), js):
        out[i], out[j] = out[j], out[i]
    return np.asarray(out, dtype=np.int64)


def shuffled_order(n: int, seed: int) -> np.ndarray:
    """The native loader's shuffled row order of ``n`` rows (int64)."""
    return _fisher_yates(np.arange(n, dtype=np.int64), int(seed))


def _epoch_state(seed: int, epoch: int) -> int:
    """The prefetcher's shuffle state of ``epoch``: ``seed + epoch *
    0x9E3779B97F4A7C15 + 1`` modulo 2**64."""
    return (int(seed) + int(epoch) * int(_GOLD) + 1) % (1 << 64)


class _DeviceTables:
    """The uint8 table, its labels and the 1/255 lookup on one device,
    and the batch each row index list makes there."""

    def __init__(self, features_u8: np.ndarray, labels_u8: np.ndarray,
                 num_classes: int, device=None):
        if features_u8.dtype != np.uint8 or labels_u8.dtype != np.uint8:
            raise TypeError("features and labels must be uint8 arrays")
        self.device = resolve_device(device)
        feats = np.ascontiguousarray(
            features_u8.reshape(features_u8.shape[0], -1))
        self.n, self.row_len = feats.shape
        self.num_classes = int(num_classes)
        self.features = upload(feats, self.device)
        self.labels = upload(np.ascontiguousarray(
            labels_u8.reshape(-1)).astype(np.int64), self.device)
        # i / 255 in f32, the C loader's ``(float)i / 255.0f``
        self.lut = upload(np.arange(256, dtype=np.float32) / np.float32(255),
                          self.device)
        self.classes = torch.arange(self.num_classes, device=self.device)

    def batch(self, rows: np.ndarray):
        """(x (B, row_len) f32 in [0, 1], y (B, num_classes) one-hot f32)
        for the rows ``rows`` (a label outside the classes one-hots to
        zeros, as the C loader's)."""
        idx = upload(rows, self.device)
        x = self.lut[self.features[idx].long()]
        y = (self.labels[idx][:, None] == self.classes[None]).float()
        return x, y


class NativeBatchAssembler:
    """Shuffled float32/one-hot minibatches straight from uint8 arrays on
    the device (≙ the fetch/assembly path of BaseDataFetcher +
    MnistDataFetcher; the reference's ``assemble_batch``): ``order`` is
    ``shuffled_order(n, seed)``."""

    def __init__(self, features_u8: np.ndarray, labels_u8: np.ndarray,
                 num_classes: int, seed: int = 0, device=None):
        self._tables = _DeviceTables(features_u8, labels_u8, num_classes,
                                     device)
        self.device = self._tables.device
        self.num_classes = int(num_classes)
        self.row_len = self._tables.row_len
        self.order = shuffled_order(self._tables.n, seed)

    def batch(self, start: int, size: int):
        """Rows ``order[start:start + size]`` as (x, y) on the device."""
        return self._tables.batch(
            np.ascontiguousarray(self.order[start:start + size]))


class PrefetchingLoader:
    """The reference's background-threaded batch pipeline (≙ BatchActor's
    job dispensing, BatchActor.java:31, plus ND4J's native DataSet
    assembly) on the device: up to ``depth`` assembled batches queued
    ahead in stream order; every row is served once an epoch, batches wrap
    across the epoch boundary, each epoch reshuffles (the order and epoch
    labels of ``native/pipeline.cpp``). Iterate forever via
    :meth:`next_batch`; :meth:`close` ends it."""

    def __init__(self, features_u8: np.ndarray, labels_u8: np.ndarray,
                 num_classes: int, batch_size: int, seed: int = 0,
                 depth: int = 4, device=None):
        if batch_size <= 0 or depth <= 0:
            raise ValueError("batch_size and depth must be positive")
        self._tables = _DeviceTables(features_u8, labels_u8, num_classes,
                                     device)
        self.device = self._tables.device
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        self.row_len = self._tables.row_len
        self.depth = int(depth)
        self._seed = int(seed)
        self._epoch = 0
        self._cursor = 0
        self._order = _fisher_yates(np.arange(self._tables.n, dtype=np.int64),
                                    _epoch_state(seed, 0))
        self._ready: deque = deque()
        self._closed = False
        while len(self._ready) < self.depth:
            self._ready.append(self._assemble())

    def _rows(self) -> tuple[np.ndarray, int]:
        """The next batch's rows in stream order and its epoch label (the
        epoch of its first row, after any wrap)."""
        n, out, label = self._tables.n, [], None
        need = self.batch_size
        while need:
            if self._cursor >= n:  # epoch boundary: reshuffle, wrap
                self._epoch += 1
                self._cursor = 0
                self._order = _fisher_yates(
                    self._order, _epoch_state(self._seed, self._epoch))
            if label is None:
                label = self._epoch
            take = min(need, n - self._cursor)
            out.append(self._order[self._cursor:self._cursor + take])
            self._cursor += take
            need -= take
        return np.concatenate(out), label

    def _assemble(self):
        rows, epoch = self._rows()
        x, y = self._tables.batch(rows)
        return x, y, epoch

    def next_batch(self):
        """(x (B, row_len) in [0, 1], y one-hot, epoch); the batch after
        the queued ones is assembled behind it."""
        if self._closed:
            raise RuntimeError("prefetcher already closed")
        out = self._ready.popleft()
        self._ready.append(self._assemble())
        return out

    def close(self) -> None:
        self._closed = True
        self._ready.clear()
