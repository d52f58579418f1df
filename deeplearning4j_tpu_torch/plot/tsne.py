"""t-SNE (the port of ``deeplearning4j_tpu/plot/tsne.py``).

≙ reference plot/Tsne.java:261 (gains + momentum gradient loop, exact
pairwise affinities) and plot/BarnesHutTsne.java:333 (quadtree
approximation for large N, :mod:`deeplearning4j_tpu_torch.plot.barnes_hut`,
on the host).

The P matrix (the perplexity binary search) is built once on the host in
f64, as the reference's; the exact O(N^2) gradient loop runs on the device,
one step an iteration (:func:`_tsne_loop`, the reference's ``fori_loop``),
its product with TF32 off. t-SNE is chaotic and its gains read
``sign(grad)``, so runs that differ in the last bit part ways after some
hundred iterations; compare the first iterations, and a whole run by what
it separates.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch import rng as rng_lib
from deeplearning4j_tpu_torch.device import resolve_device


def _hbeta(d_row: np.ndarray, beta: float) -> tuple[float, np.ndarray]:
    p = np.exp(-d_row * beta)
    s = p.sum() + 1e-12
    h = np.log(s) + beta * (d_row * p).sum() / s
    return h, p / s


def p_affinities(x: np.ndarray, perplexity: float = 30.0, tol: float = 1e-5) -> np.ndarray:
    """Conditional -> joint affinities with per-point beta binary search
    (≙ Tsne's x2p)."""
    n = x.shape[0]
    d2 = np.square(x[:, None, :] - x[None, :, :]).sum(-1)
    p = np.zeros((n, n))
    log_u = np.log(perplexity)
    for i in range(n):
        idx = np.arange(n) != i
        beta, beta_min, beta_max = 1.0, -np.inf, np.inf
        for _ in range(50):
            h, row = _hbeta(d2[i, idx], beta)
            if abs(h - log_u) < tol:
                break
            if h > log_u:
                beta_min = beta
                beta = beta * 2 if beta_max == np.inf else (beta + beta_max) / 2
            else:
                beta_max = beta
                beta = beta / 2 if beta_min == -np.inf else (beta + beta_min) / 2
        p[i, idx] = row
    p = (p + p.T) / (2 * n)
    return np.maximum(p, 1e-12)


def _tsne_loop(p: torch.Tensor, y0: torch.Tensor, lr: float,
               momentum_0: float, momentum_f: float, n_iter: int,
               stop_lying_iter: int) -> torch.Tensor:
    """``n_iter`` gradient steps from ``y0`` (N, c) over the joint
    affinities ``p`` (N, N), f32, on their device: early exaggeration x4
    for the first ``stop_lying_iter`` steps, momentum ``momentum_0`` for
    the first 20, gains, re-centering."""
    n = y0.shape[0]
    p_lied = p * 4.0  # early exaggeration (≙ Tsne's lie factor)
    off_diag = 1.0 - torch.eye(n, device=y0.device)
    y = y0
    y_inc = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    for i in range(n_iter):
        pm = p_lied if i < stop_lying_iter else p
        d2 = torch.sum((y[:, None, :] - y[None, :, :]) ** 2, dim=-1)
        num = 1.0 / (1.0 + d2)
        num = num * off_diag
        q = torch.clamp(num / torch.sum(num), min=1e-12)
        pq = (pm - q) * num  # (N, N)
        with dtypes.precision():
            grad = (4.0 * (torch.diag(pq.sum(1)) - pq)) @ y
        momentum = momentum_0 if i < 20 else momentum_f
        same_sign = torch.sign(grad) == torch.sign(y_inc)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                            min=0.01)
        y_inc = momentum * y_inc - lr * gains * grad
        y = y + y_inc
        y = y - torch.mean(y, dim=0, keepdim=True)
    return y


class Tsne:
    """≙ Tsne.Builder: perplexity, learningRate, maxIter, momentum switch.
    Runs its gradient loop (and, with ``use_pca``, the PCA) on ``device``
    (``cuda`` unless the caller names another; raises without a card)."""

    def __init__(
        self,
        n_components: int = 2,
        perplexity: float = 30.0,
        learning_rate: float = 200.0,
        n_iter: int = 500,
        initial_momentum: float = 0.5,
        final_momentum: float = 0.8,
        stop_lying_iter: int = 100,
        seed: int = 0,
        use_pca: bool = False,
        pca_dims: int = 50,
        device=None,
    ):
        self.device = resolve_device(device)
        self.use_pca = use_pca
        self.pca_dims = pca_dims
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.stop_lying_iter = stop_lying_iter
        self.seed = seed

    def prepare(self, x: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """(P, y0) on the device: the affinities of ``x`` (after the PCA
        with ``use_pca``) in f32, and the initial map ``1e-4 *
        normal(key(seed), (N, n_components))``."""
        x = np.asarray(x, dtype=np.float32)
        if self.use_pca:  # ≙ Tsne.java:262-263: PCA.pca(X, min(50, D), norm)
            from deeplearning4j_tpu_torch.ops.pca import pca

            x = pca(x, min(self.pca_dims, x.shape[1]), normalize=True,
                    device=self.device)
        p = torch.as_tensor(p_affinities(x, self.perplexity).astype(
            np.float32), device=self.device)
        y0 = 1e-4 * rng_lib.normal(rng_lib.key_for(self.seed),
                                   (x.shape[0], self.n_components),
                                   device=self.device)
        return p, y0

    def calculate(self, x: np.ndarray) -> np.ndarray:
        """(N, D) -> (N, n_components) embedding (≙ Tsne.calculate:261)."""
        p, y0 = self.prepare(x)
        y = _tsne_loop(
            p, y0, self.learning_rate, self.initial_momentum,
            self.final_momentum, self.n_iter, self.stop_lying_iter,
        )
        return y.cpu().numpy()

    fit_transform = calculate
