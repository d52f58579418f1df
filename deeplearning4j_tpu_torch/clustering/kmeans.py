"""KMeans with Lloyd iterations on the device (the port of
``deeplearning4j_tpu/clustering/kmeans.py``; ≙ reference
clustering/kmeans/KMeansClustering.java:112).

k-means++ seeding on the host (numpy, from the seed, as the reference's);
each Lloyd step on tensors: the distance matrix as one product (TF32 off),
the assignment by ``argmin`` (ties to the lowest centroid, as
``jnp.argmin``), and the centroid update as a one-hot (k, N) product where
the reference takes ``segment_sum``: deterministic on the card (no float
atomics) and exact enough at small k.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import resolve_device


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor, k: int):
    """(new centroids, assignment, inertia): one Lloyd iteration."""
    with dtypes.precision():
        d2 = (
            torch.sum(x**2, 1, keepdim=True)
            - 2 * x @ centroids.T
            + torch.sum(centroids**2, 1)[None, :]
        )
        assign = torch.argmin(d2, dim=1)
        onehot = (assign[None, :] == torch.arange(k, device=x.device)[:, None]
                  ).to(x.dtype)  # (k, N)
        sums = onehot @ x
    counts = onehot.sum(1)
    new_centroids = torch.where(
        counts[:, None] > 0,
        sums / torch.clamp(counts[:, None], min=1), centroids)
    inertia = torch.sum(torch.amin(d2, dim=1))
    return new_centroids, assign, inertia


class KMeans:
    """k-means on ``device`` (``cuda`` unless the caller names another;
    raises without a card)."""

    def __init__(self, k: int, max_iter: int = 100, tol: float = 1e-6,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.k = k
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.centroids: np.ndarray | None = None
        self.inertia: float = float("inf")

    def _init_pp(self, x: np.ndarray) -> np.ndarray:
        """k-means++ seeding."""
        rng = np.random.default_rng(self.seed)
        n = x.shape[0]
        centroids = [x[rng.integers(n)]]
        for _ in range(1, self.k):
            d2 = np.min(
                ((x[:, None, :] - np.stack(centroids)[None]) ** 2).sum(-1), axis=1
            )
            probs = d2 / (d2.sum() + 1e-12)
            centroids.append(x[rng.choice(n, p=probs)])
        return np.stack(centroids)

    def fit(self, x: np.ndarray) -> "KMeans":
        xh = np.asarray(x, np.float32)
        xd = torch.as_tensor(xh, device=self.device)
        centroids = torch.as_tensor(self._init_pp(xh), device=self.device)
        prev = float("inf")
        for _ in range(self.max_iter):
            centroids, assign, inertia = _lloyd_step(xd, centroids, self.k)
            now = float(inertia)
            if abs(prev - now) < self.tol:
                break
            prev = now
        self.centroids = centroids.cpu().numpy()
        self.labels_ = assign.cpu().numpy()
        self.inertia = float(inertia)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        d2 = ((np.asarray(x)[:, None, :] - self.centroids[None]) ** 2).sum(-1)
        return d2.argmin(1)
