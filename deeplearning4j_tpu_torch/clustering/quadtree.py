"""Quadtree for 2-D Barnes-Hut force approximation
(the port's copy of ``deeplearning4j_tpu/clustering/quadtree.py``).

≙ reference clustering/quadtree/QuadTree.java:475 — cell subdivision with
center-of-mass aggregation, used by BarnesHutTsne.
"""

from __future__ import annotations

import numpy as np


class QuadTree:
    __slots__ = (
        "center", "half", "com", "mass", "point_index", "children", "_point",
    )

    def __init__(self, center, half):
        self.center = np.asarray(center, dtype=np.float64)
        self.half = np.asarray(half, dtype=np.float64)
        self.com = np.zeros(2)
        self.mass = 0
        self.point_index: int | None = None
        self._point: np.ndarray | None = None
        self.children: list[QuadTree] | None = None

    @classmethod
    def build(cls, points: np.ndarray) -> "QuadTree":
        points = np.asarray(points, dtype=np.float64)
        lo, hi = points.min(0), points.max(0)
        center = (lo + hi) / 2
        half = np.maximum((hi - lo) / 2 * 1.001, 1e-9)
        tree = cls(center, half)
        for i, p in enumerate(points):
            tree.insert(p, i)
        return tree

    def contains(self, p) -> bool:
        return bool(np.all(np.abs(p - self.center) <= self.half + 1e-12))

    def _child_for(self, p) -> "QuadTree":
        i = (p[0] > self.center[0]) * 1 + (p[1] > self.center[1]) * 2
        return self.children[i]

    def _subdivide(self):
        h = self.half / 2
        self.children = [
            QuadTree(self.center + h * np.array(off), h)
            for off in ((-1, -1), (1, -1), (-1, 1), (1, 1))
        ]

    def insert(self, p, index: int):
        p = np.asarray(p, dtype=np.float64)
        self.com = (self.com * self.mass + p) / (self.mass + 1)
        self.mass += 1
        if self.children is None:
            if self.point_index is None and self.mass == 1:
                self.point_index = index
                self._point = p
                return
            # occupied leaf: split and reinsert
            self._subdivide()
            if self.point_index is not None:
                self._child_for(self._point).insert(self._point, self.point_index)
                self.point_index = None
        self._child_for(p).insert(p, index)

    def compute_non_edge_forces(
        self, point: np.ndarray, theta: float, neg_f: np.ndarray
    ) -> float:
        """Accumulate repulsive forces on ``point``; returns sum_Q term
        (≙ QuadTree.computeNonEdgeForces)."""
        if self.mass == 0:
            return 0.0
        diff = point - self.com
        d2 = float(diff @ diff)
        if self.children is None or (self.mass == 1 and d2 < 1e-18):
            if d2 < 1e-18:
                return 0.0
        node_size = float(self.half.max() * 2)
        if self.children is None or node_size / max(np.sqrt(d2), 1e-12) < theta:
            q = 1.0 / (1.0 + d2)
            mult = self.mass * q
            neg_f += mult * q * diff
            return mult
        return sum(
            c.compute_non_edge_forces(point, theta, neg_f) for c in self.children
        )
