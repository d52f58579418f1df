"""KD-tree (host-side spatial index; ≙ clustering/kdtree/KDTree.java:351)
(the port's copy of ``deeplearning4j_tpu/clustering/kdtree.py``)."""

from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("point", "index", "axis", "left", "right")

    def __init__(self, point, index, axis):
        self.point = point
        self.index = index
        self.axis = axis
        self.left = None
        self.right = None


class KDTree:
    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64)
        self.dims = self.points.shape[1]
        idx = np.arange(len(self.points))
        self.root = self._build(idx, 0)

    def _build(self, idx: np.ndarray, depth: int):
        if len(idx) == 0:
            return None
        axis = depth % self.dims
        order = idx[np.argsort(self.points[idx, axis])]
        mid = len(order) // 2
        node = _Node(self.points[order[mid]], int(order[mid]), axis)
        node.left = self._build(order[:mid], depth + 1)
        node.right = self._build(order[mid + 1 :], depth + 1)
        return node

    def nearest(self, query: np.ndarray, k: int = 1) -> list[tuple[float, int]]:
        """k nearest neighbours as (distance, index), closest first."""
        import heapq

        query = np.asarray(query, dtype=np.float64)
        heap: list[tuple[float, int]] = []  # max-heap via negative distance

        def visit(node):
            if node is None:
                return
            d = float(np.linalg.norm(node.point - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = query[node.axis] - node.point[node.axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        return sorted((-nd, i) for nd, i in heap)

    def range(self, lower: np.ndarray, upper: np.ndarray) -> list[int]:
        """Indices of points inside the axis-aligned box."""
        lower = np.asarray(lower)
        upper = np.asarray(upper)
        out: list[int] = []

        def visit(node):
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append(node.index)
            if node.point[node.axis] >= lower[node.axis]:
                visit(node.left)
            if node.point[node.axis] <= upper[node.axis]:
                visit(node.right)

        visit(self.root)
        return out
