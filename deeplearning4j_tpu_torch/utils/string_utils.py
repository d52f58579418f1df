"""String utilities.

≙ the useful surface of the reference's vendored Berkeley
``StringUtils`` (berkeley/StringUtils.java, ~1040 LoC): edit distance,
LCS, n-gram helpers. The bulk of the Java file (join/pad, argmax
maps, reflection helpers, CSV escaping) is stdlib Python
(str methods, csv, itertools) and is deliberately not re-implemented;
likewise berkeley ``PriorityQueue``/``Pair``/``Triple``/``Iterators``
are ``heapq``/tuples/``itertools``.

The port's copy of ``deeplearning4j_tpu/utils/string_utils.py``.
"""

from __future__ import annotations


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (unit costs), O(len(a)*len(b)) two-row DP."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(
                min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            )
        prev = cur
    return prev[-1]


def longest_common_substring(a: str, b: str) -> str:
    """Longest contiguous common substring (Berkeley StringUtils parity)."""
    best_len, best_end = 0, 0
    prev = [0] * (len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = [0] * (len(b) + 1)
        for j, cb in enumerate(b, 1):
            if ca == cb:
                cur[j] = prev[j - 1] + 1
                if cur[j] > best_len:
                    best_len, best_end = cur[j], i
        prev = cur
    return a[best_end - best_len : best_end]


def ngrams(tokens: list[str], n: int) -> list[tuple[str, ...]]:
    """All order-n contiguous token n-grams."""
    if n <= 0 or n > len(tokens):
        return []
    return [tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]
