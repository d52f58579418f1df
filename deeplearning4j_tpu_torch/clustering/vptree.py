"""Vantage-point tree for metric nearest-neighbour search
(the port's copy of ``deeplearning4j_tpu/clustering/vptree.py``).

≙ reference clustering/vptree/VPTree.java:290 (used for wordsNearest-style
queries and BH-tSNE input neighbourhoods).
"""

from __future__ import annotations

import heapq

import numpy as np


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index, threshold, inside, outside):
        self.index = index
        self.threshold = threshold
        self.inside = inside
        self.outside = outside


class VPTree:
    def __init__(self, points: np.ndarray, distance: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, dtype=np.float64)
        self.distance = distance
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.points))))

    def _dist(self, a: np.ndarray, b: np.ndarray) -> float:
        if self.distance == "cosine":
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            return 1.0 - float(a @ b) / (na * nb + 1e-12)
        return float(np.linalg.norm(a - b))

    def _build(self, idx: list[int]):
        if not idx:
            return None
        vp = idx[self._rng.integers(len(idx))]
        rest = [i for i in idx if i != vp]
        if not rest:
            return _VPNode(vp, 0.0, None, None)
        dists = [self._dist(self.points[vp], self.points[i]) for i in rest]
        threshold = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d <= threshold]
        outside = [i for i, d in zip(rest, dists) if d > threshold]
        return _VPNode(vp, threshold, self._build(inside), self._build(outside))

    def nearest(self, query: np.ndarray, k: int = 1) -> list[tuple[float, int]]:
        query = np.asarray(query, dtype=np.float64)
        heap: list[tuple[float, int]] = []  # max-heap (−d)
        tau = [np.inf]

        def visit(node):
            if node is None:
                return
            d = self._dist(query, self.points[node.index])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if d <= node.threshold:
                visit(node.inside)
                if d + tau[0] > node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        return sorted((-nd, i) for nd, i in heap)
