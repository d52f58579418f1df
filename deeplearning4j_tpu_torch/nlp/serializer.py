"""Word-vector serialization: the word2vec text and Google binary formats
and the t-SNE CSV (the port's copy of ``deeplearning4j_tpu/nlp/serializer.py``;
for the same words and vectors the files are byte-equal to the reference's).

Vectors may be numpy arrays or tensors on any device; they are written from
a host copy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _host(vectors) -> np.ndarray:
    if isinstance(vectors, torch.Tensor):
        return vectors.detach().cpu().numpy()
    return np.asarray(vectors)


def write_text(path: str | Path, words: list[str], vectors) -> None:
    """word2vec .txt format: header 'V D', then 'word v0 v1 ...'."""
    vectors = _host(vectors)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(words)} {vectors.shape[1]}\n")
        for w, vec in zip(words, vectors):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")


def read_text(path: str | Path) -> tuple[list[str], np.ndarray]:
    words, rows = [], []
    with open(path, encoding="utf-8", errors="replace") as f:
        header = f.readline().split()
        v, d = int(header[0]), int(header[1])
        for line in f:
            parts = line.rstrip().split(" ")
            words.append(parts[0])
            rows.append(np.array(parts[1 : d + 1], dtype=np.float32))
    return words, np.stack(rows) if rows else np.zeros((0, d), np.float32)


def write_binary(path: str | Path, words: list[str], vectors) -> None:
    """Google word2vec .bin format."""
    vectors = _host(vectors).astype(np.float32, copy=False)
    with open(path, "wb") as f:
        f.write(f"{len(words)} {vectors.shape[1]}\n".encode())
        for w, vec in zip(words, vectors):
            f.write(w.encode("utf-8") + b" ")
            f.write(vec.tobytes())
            f.write(b"\n")


def read_binary(path: str | Path) -> tuple[list[str], np.ndarray]:
    words, rows = [], []
    with open(path, "rb") as f:
        header = f.readline().split()
        v, d = int(header[0]), int(header[1])
        for _ in range(v):
            w = bytearray()
            while True:
                ch = f.read(1)
                if ch in (b" ", b""):
                    break
                w.extend(ch)
            vec = np.frombuffer(f.read(4 * d), dtype=np.float32)
            nl = f.read(1)
            if nl not in (b"\n", b""):
                f.seek(-1, 1)
            words.append(w.decode("utf-8", errors="replace"))
            rows.append(vec.copy())
    return words, np.stack(rows) if rows else np.zeros((0, d), np.float32)


def from_word2vec(model) -> tuple[list[str], np.ndarray]:
    return model.cache.words(), _host(model.syn0)


def load_into_word2vec(model_cls, words: list[str], vectors, device=None):
    """Rebuild a queryable model of ``model_cls`` from saved vectors, its
    table on ``device`` (``cuda`` unless the caller names another)."""
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord

    vectors = _host(vectors)
    model = model_cls(layer_size=vectors.shape[1], device=device)
    cache = VocabCache()
    for i, w in enumerate(words):
        cache.vocab[w] = VocabWord(w, 1.0, index=i)
        cache.index_to_word.append(w)
    cache.total_word_count = float(len(words))
    model.cache = cache
    model.syn0 = torch.tensor(vectors, dtype=torch.float32,
                              device=model.device)
    return model


def write_tsne_csv(path: str | Path, words: list[str], coords) -> None:
    """2-D coordinates CSV, one 'x,y,word' line per word."""
    with open(path, "w", encoding="utf-8") as f:
        for w, (x, y) in zip(words, _host(coords)):
            f.write(f"{x:.6f},{y:.6f},{w}\n")
