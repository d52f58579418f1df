"""Bag-of-words / TF-IDF vectorizers + moving-window featurization
(the port's copy of ``deeplearning4j_tpu/nlp/vectorizers.py``).

≙ reference bagofwords/vectorizer (BaseTextVectorizer.java:265,
BagOfWordsVectorizer.java:137, TfidfVectorizer.java:133) and
text/movingwindow (Window.java:167, Windows.java:171,
WindowConverter.java:103).
"""

from __future__ import annotations

import math
import re
from typing import Iterable

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class BagOfWordsVectorizer:
    def __init__(self, tokenizer=None, min_word_frequency: int = 1):
        self.tokenizer = tokenizer or DefaultTokenizer()
        self.cache = VocabCache(min_word_frequency)
        self._fitted = False

    def fit(self, texts: Iterable[str]) -> "BagOfWordsVectorizer":
        self.cache.fit(self.tokenizer.tokens(t) for t in texts)
        self._fitted = True
        return self

    def transform(self, texts: Iterable[str]) -> np.ndarray:
        assert self._fitted, "call fit() first"
        v = len(self.cache)
        rows = []
        for t in texts:
            row = np.zeros(v, dtype=np.float32)
            for tok in self.tokenizer.tokens(t):
                i = self.cache.index_of(tok)
                if i >= 0:
                    row[i] += 1.0
            rows.append(row)
        return np.stack(rows) if rows else np.zeros((0, v), np.float32)

    def fit_transform(self, texts: list[str]) -> np.ndarray:
        return self.fit(texts).transform(texts)


class TfidfVectorizer(BagOfWordsVectorizer):
    def __init__(self, tokenizer=None, min_word_frequency: int = 1):
        super().__init__(tokenizer, min_word_frequency)
        self.idf: np.ndarray | None = None

    def fit(self, texts: Iterable[str]) -> "TfidfVectorizer":
        texts = list(texts)
        super().fit(texts)
        v = len(self.cache)
        df = np.zeros(v, dtype=np.float64)
        for t in texts:
            seen = {self.cache.index_of(tok) for tok in self.tokenizer.tokens(t)}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        n = len(texts)
        self.idf = np.log((n + 1) / (df + 1)).astype(np.float32) + 1.0
        return self

    def transform(self, texts: Iterable[str]) -> np.ndarray:
        counts = super().transform(texts)
        tf = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
        return tf * self.idf


def windows(tokens: list[str], window_size: int = 5, pad: str = "<NONE>") -> list[list[str]]:
    """Sliding context windows centered on each token (≙ Windows.java:171)."""
    half = window_size // 2
    padded = [pad] * half + tokens + [pad] * half
    return [padded[i : i + window_size] for i in range(len(tokens))]


def window_to_vector(
    window: list[str], embeddings, cache: VocabCache, dim: int
) -> np.ndarray:
    """Concat word vectors of a window (≙ WindowConverter.java:103)."""
    vecs = []
    for w in window:
        i = cache.index_of(w)
        vecs.append(np.asarray(embeddings[i]) if i >= 0 else np.zeros(dim, np.float32))
    return np.concatenate(vecs)


_BEGIN_LABEL = re.compile(r"<([A-Za-z]+|\d+)>$")
_END_LABEL = re.compile(r"</([A-Za-z]+|\d+)>$")


def string_with_labels(
    sentence: str,
) -> tuple[str, dict[tuple[int, int], str]]:
    """Strip inline ``<LABEL> ... </LABEL>`` markers from a sentence and
    return (clean sentence, {(start, end): label} token spans) —
    ≙ ContextLabelRetriever.stringWithLabels (reference:
    text/movingwindow/ContextLabelRetriever.java:34-95), including its
    error cases (unopened end label, unclosed begin label, mismatched
    label pair).

    Deviation from the parity surface (noted in PARITY.md): spans are
    *token-index* ranges into the whitespace-split clean sentence, not
    the reference's character offsets — token indices are what the
    moving-window vectorizer downstream consumes.
    """
    # whitespace split, not a word tokenizer: the repo's word-regex
    # tokenizers strip the <LABEL> markers before they can be matched
    tokens = sentence.split()
    spans: dict[tuple[int, int], str] = {}
    clean: list[str] = []
    curr_label: str | None = None
    start = 0
    for token in tokens:
        begin = _BEGIN_LABEL.match(token)
        end = _END_LABEL.match(token)
        if begin:
            if curr_label is not None:
                raise ValueError(
                    f"begin label <{begin.group(1)}> inside open label "
                    f"<{curr_label}>"
                )
            curr_label = begin.group(1)
            start = len(clean)
        elif end:
            if curr_label is None:
                raise ValueError(
                    f"end label </{end.group(1)}> with no begin label"
                )
            if end.group(1) != curr_label:
                raise ValueError(
                    f"label mismatch: <{curr_label}> closed by "
                    f"</{end.group(1)}>"
                )
            spans[(start, len(clean))] = curr_label
            curr_label = None
        else:
            clean.append(token)
    if curr_label is not None:
        raise ValueError(f"unclosed label <{curr_label}>")
    return " ".join(clean), spans
