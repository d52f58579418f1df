"""Vocabulary cache and Huffman coding (the port's copy of
``deeplearning4j_tpu/nlp/vocab.py``).

The Huffman codes and inner-node points of every word are kept as dense
(V, max_code_length) arrays, padding masked out, so the hierarchical-softmax
step is a batched gather of rows.
"""

from __future__ import annotations

import heapq
import itertools
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np


@dataclass
class VocabWord:
    """A word's frequency and Huffman metadata."""

    word: str
    count: float = 0.0
    index: int = -1
    codes: list[int] = field(default_factory=list)
    points: list[int] = field(default_factory=list)


class VocabCache:
    """Word <-> index store with counts and Huffman metadata."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency
        self.vocab: dict[str, VocabWord] = {}
        self.index_to_word: list[str] = []
        self.total_word_count = 0.0
        self.num_docs = 0
        self.max_code_length = 0

    # -- building ----------------------------------------------------------
    def fit(self, tokenized_sentences: Iterable[list[str]]) -> "VocabCache":
        counts: Counter = Counter()
        for sent in tokenized_sentences:
            counts.update(sent)
            self.num_docs += 1
        for word, c in counts.most_common():
            if c >= self.min_word_frequency:
                vw = VocabWord(word, float(c), index=len(self.index_to_word))
                self.vocab[word] = vw
                self.index_to_word.append(word)
                self.total_word_count += c
        return self

    def fit_texts(self, texts: Iterable[str], lowercase: bool = True) -> "VocabCache":
        """Build the vocabulary straight from raw strings through
        :func:`deeplearning4j_tpu_torch.native_io.count_vocab`."""
        from deeplearning4j_tpu_torch import native_io

        texts = list(texts)
        words, counts, _total = native_io.count_vocab(
            texts, min_count=self.min_word_frequency, lowercase=lowercase
        )
        self.num_docs += len(texts)
        for word, c in zip(words, counts.tolist()):
            vw = VocabWord(word, float(c), index=len(self.index_to_word))
            self.vocab[word] = vw
            self.index_to_word.append(word)
            self.total_word_count += c
        return self

    # -- lookups -----------------------------------------------------------
    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def __len__(self) -> int:
        return len(self.index_to_word)

    def word_for(self, index: int) -> str:
        return self.index_to_word[index]

    def index_of(self, word: str) -> int:
        vw = self.vocab.get(word)
        return vw.index if vw else -1

    def word_frequency(self, word: str) -> float:
        vw = self.vocab.get(word)
        return vw.count if vw else 0.0

    def words(self) -> list[str]:
        return list(self.index_to_word)

    def encode(self, tokens: list[str]) -> list[int]:
        out = []
        for t in tokens:
            i = self.index_of(t)
            if i >= 0:
                out.append(i)
        return out

    # -- Huffman -----------------------------------------------------------
    def build_huffman(self) -> None:
        """Assign binary codes and inner-node points by word frequency."""
        n = len(self)
        if n == 0:
            return
        counter = itertools.count()
        # heap of (count, tiebreak, node); leaves are word indices, inner
        # nodes numbered n, n+1, ... (points are inner-node ids - n, the
        # rows of syn1)
        heap: list[tuple[float, int, dict]] = []
        for w in self.index_to_word:
            vw = self.vocab[w]
            heapq.heappush(heap, (vw.count, next(counter), {"leaf": vw.index}))
        inner_id = itertools.count(n)
        while len(heap) > 1:
            c1, _, left = heapq.heappop(heap)
            c2, _, right = heapq.heappop(heap)
            node = {"id": next(inner_id), "left": left, "right": right}
            heapq.heappush(heap, (c1 + c2, next(counter), node))
        root = heap[0][2]

        def walk(node, code: list[int], points: list[int]):
            if "leaf" in node:
                vw = self.vocab[self.index_to_word[node["leaf"]]]
                vw.codes = list(code)
                vw.points = list(points)
                return
            pts = points + [node["id"] - n]
            walk(node["left"], code + [0], pts)
            walk(node["right"], code + [1], pts)

        walk(root, [], [])
        self.max_code_length = max(
            (len(v.codes) for v in self.vocab.values()), default=0
        )

    def huffman_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(codes, points, mask) dense arrays of shape (V, max_code_length),
        padding masked out."""
        v, L = len(self), self.max_code_length
        codes = np.zeros((v, L), dtype=np.int32)
        points = np.zeros((v, L), dtype=np.int32)
        mask = np.zeros((v, L), dtype=np.float32)
        for w in self.index_to_word:
            vw = self.vocab[w]
            k = len(vw.codes)
            codes[vw.index, :k] = vw.codes
            points[vw.index, :k] = vw.points
            mask[vw.index, :k] = 1.0
        return codes, points, mask

    def unigram_table(self, size: int = 1 << 17, power: float = 0.75) -> np.ndarray:
        """Negative-sampling table: each word index repeated in proportion
        to count^0.75."""
        counts = np.array(
            [self.vocab[w].count for w in self.index_to_word], dtype=np.float64
        )
        probs = counts**power
        probs /= probs.sum()
        return np.repeat(
            np.arange(len(self), dtype=np.int32),
            np.maximum(np.round(probs * size).astype(np.int64), 1),
        )
