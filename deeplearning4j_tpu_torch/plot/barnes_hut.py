"""Barnes-Hut t-SNE (host-side, quadtree-approximated)
(the port's copy of ``deeplearning4j_tpu/plot/barnes_hut.py``).

≙ reference plot/BarnesHutTsne.java:42-333: attractive forces over a
sparse kNN affinity graph, repulsive forces via quadtree pole expansion.
The exact t-SNE (:mod:`deeplearning4j_tpu_torch.plot.tsne`) runs on the
card; this variant trades exactness for O(N log N) on
large N where the dense N^2 no longer fits.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.plot.tsne import _hbeta


def knn_affinities(x: np.ndarray, perplexity: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse symmetric P over 3*perplexity nearest neighbours
    (≙ BarnesHutTsne's VPTree-based input similarity)."""
    n = x.shape[0]
    k = min(int(3 * perplexity), n - 1)
    tree = VPTree(x)
    rows, cols, vals = [], [], []
    log_u = np.log(perplexity)
    for i in range(n):
        nbrs = tree.nearest(x[i], k + 1)
        nbrs = [(d, j) for d, j in nbrs if j != i][:k]
        d2 = np.array([d * d for d, _ in nbrs])
        beta, lo, hi = 1.0, -np.inf, np.inf
        for _ in range(50):
            h, row = _hbeta(d2, beta)
            if abs(h - log_u) < 1e-5:
                break
            if h > log_u:
                lo, beta = beta, beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi, beta = beta, beta / 2 if lo == -np.inf else (beta + lo) / 2
        for (d, j), p in zip(nbrs, row):
            rows.append(i)
            cols.append(j)
            vals.append(p)
    # symmetrize
    p = {}
    for r, c, v in zip(rows, cols, vals):
        p[(r, c)] = p.get((r, c), 0.0) + v / (2 * n)
        p[(c, r)] = p.get((c, r), 0.0) + v / (2 * n)
    out_r = np.array([k[0] for k in p], dtype=np.int64)
    out_c = np.array([k[1] for k in p], dtype=np.int64)
    out_v = np.array(list(p.values()))
    return out_r, out_c, np.maximum(out_v, 1e-12)


class BarnesHutTsne:
    def __init__(
        self,
        n_components: int = 2,
        perplexity: float = 30.0,
        theta: float = 0.5,
        learning_rate: float = 200.0,
        n_iter: int = 300,
        seed: int = 0,
    ):
        assert n_components == 2, "quadtree variant is 2-D"
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.seed = seed

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        rows, cols, vals = knn_affinities(x, self.perplexity)
        rng = np.random.default_rng(self.seed)
        y = 1e-4 * rng.normal(size=(n, 2))
        y_inc = np.zeros_like(y)
        gains = np.ones_like(y)
        for it in range(self.n_iter):
            lie = 12.0 if it < 100 else 1.0
            tree = QuadTree.build(y)
            # repulsive via quadtree
            neg = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                f = np.zeros(2)
                sum_q += tree.compute_non_edge_forces(y[i], self.theta, f)
                neg[i] = f
            # attractive over sparse edges
            diff = y[rows] - y[cols]
            q = 1.0 / (1.0 + (diff**2).sum(1))
            coeff = (lie * vals) * q
            pos = np.zeros_like(y)
            np.add.at(pos, rows, coeff[:, None] * diff)
            grad = pos - neg / max(sum_q, 1e-12)
            momentum = 0.5 if it < 20 else 0.8
            same = np.sign(grad) == np.sign(y_inc)
            gains = np.maximum(np.where(same, gains * 0.8, gains + 0.2), 0.01)
            y_inc = momentum * y_inc - self.learning_rate * gains * grad
            y = y + y_inc
            y -= y.mean(0, keepdims=True)
        return y
