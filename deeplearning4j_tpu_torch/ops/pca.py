"""PCA dimensionality reduction (the port of ``deeplearning4j_tpu/ops/
pca.py``).

≙ ND4J ``org.nd4j.linalg.dimensionalityreduction.PCA.pca(X, ndims,
normalize)`` — part of the reference's consumed API surface and used by
t-SNE preprocessing (reference plot/Tsne.java:262-263).

One thin SVD (``torch.linalg.svd(full_matrices=False)``) of the centered
(optionally standardized) matrix on the device, and the projection as one
product with TF32 off. Returns host numpy, as the reference. The port fixes
no sign convention: each singular vector is defined only up to its sign,
and LAPACK (the CPU, and the reference) and cuSOLVER (the card) may choose
differently, so a component and its projection may come out negated; compare
them up to sign.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import resolve_device


def _pca_project(x: torch.Tensor, n_dims: int, normalize: bool):
    mean = torch.mean(x, dim=0, keepdim=True)
    xc = x - mean
    if normalize:  # a zero std divides by 1
        std = torch.std(xc, dim=0, correction=0, keepdim=True)
        xc = xc / torch.where(std == 0, 1.0, std)
    # thin SVD of (N, D): the principal axes are the right singular vectors
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    components = vt[:n_dims]  # (n_dims, D)
    with dtypes.precision():
        return xc @ components.T, components


def pca_factor(x, n_dims: int, normalize: bool = False, device=None):
    """(projected, components) — components row-major (n_dims, D), for
    reuse on new data via ``x_new @ components.T``; computed on ``device``
    (``cuda`` unless the caller names another; raises without a card)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    projected, components = _pca_project(x, min(n_dims, *x.shape), normalize)
    return projected.cpu().numpy(), components.cpu().numpy()


def pca(x, n_dims: int, normalize: bool = False, device=None) -> np.ndarray:
    """Project ``x`` (N, D) onto its top ``n_dims`` principal components."""
    return pca_factor(x, n_dims, normalize, device)[0]
