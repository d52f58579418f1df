"""Host-side text helpers of the Word2Vec path: the skip-gram pair
enumerator and the vocabulary counter (the port's own versions of
``sg_pairs_chunk`` and ``count_vocab`` in ``deeplearning4j_tpu/native_io.py``).

The reference runs both in C++ (``native/corpus.cpp``, ``native/text.cpp``)
with Python fallbacks. The port needs no native library: the pair
enumerator is vectorized numpy that yields the C++ pass's pairs element for
element, and the counter is the reference's pure-Python path, which
yields the native counter's vocabulary.
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np

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
