"""Counter / CounterMap — vendored-Berkeley-utils parity.

≙ reference berkeley/Counter.java:598 + CounterMap.java:390 (used
throughout the NLP stack for counts and probabilities).

The port's copy of ``deeplearning4j_tpu/utils/counters.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Generic, Hashable, Iterable, TypeVar

K = TypeVar("K", bound=Hashable)
K2 = TypeVar("K2", bound=Hashable)


class Counter(Generic[K]):
    def __init__(self, items: Iterable[K] | None = None):
        self._m: dict[K, float] = defaultdict(float)
        if items:
            for i in items:
                self.increment(i)

    def increment(self, key: K, amount: float = 1.0) -> None:
        self._m[key] += amount

    def set_count(self, key: K, value: float) -> None:
        self._m[key] = value

    def get_count(self, key: K) -> float:
        return self._m.get(key, 0.0)

    def total_count(self) -> float:
        return sum(self._m.values())

    def normalize(self) -> None:
        total = self.total_count()
        if total:
            for k in self._m:
                self._m[k] /= total

    def arg_max(self) -> K | None:
        return max(self._m, key=self._m.get) if self._m else None

    def max_count(self) -> float:
        return max(self._m.values(), default=0.0)

    def sorted_keys(self) -> list[K]:
        return sorted(self._m, key=self._m.get, reverse=True)

    def keys(self):
        return self._m.keys()

    def items(self):
        return self._m.items()

    def __len__(self) -> int:
        return len(self._m)

    def __contains__(self, key: K) -> bool:
        return key in self._m


class CounterMap(Generic[K, K2]):
    def __init__(self):
        self._m: dict[K, Counter[K2]] = defaultdict(Counter)

    def increment_count(self, key: K, sub: K2, amount: float = 1.0) -> None:
        self._m[key].increment(sub, amount)

    def get_count(self, key: K, sub: K2) -> float:
        return self._m[key].get_count(sub) if key in self._m else 0.0

    def get_counter(self, key: K) -> Counter[K2]:
        return self._m[key]

    def normalize(self) -> None:
        for c in self._m.values():
            c.normalize()

    def total_count(self) -> float:
        return sum(c.total_count() for c in self._m.values())

    def keys(self):
        return self._m.keys()

    def __len__(self) -> int:
        return len(self._m)
