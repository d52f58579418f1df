"""Tensor (model) parallelism hooks (the JAX package's
``parallel/tensor_parallel.py``): the Megatron building blocks over a
mesh's model axis.

- column-parallel dense: W split on its output dim; activations stay
  split, no collective;
- row-parallel dense: W split on its input dim; the ranks' partial
  products are summed (:meth:`mesh.Mesh.psum`, rank order on the first
  device);
- :func:`tp_mlp_block`: column -> nonlinearity -> row, one sum a block.

Serving keeps the byte-exact layout instead (the row-parallel halves
whole, their inputs gathered, so every sum keeps the single-device order):
:func:`serving_tp_shardings` and :func:`serving_tp_cache_sharding` are
``models.transformer``'s, kept next to the params they lay out.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.models.transformer import (
    serving_tp_cache_sharding,
    serving_tp_shardings,
)
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, Mesh, Shards

__all__ = ["serving_tp_cache_sharding", "serving_tp_shardings",
           "shard_dense_params", "tp_mlp_block"]


def _model_axis(mesh) -> Mesh:
    """The model-axis :class:`Mesh` of ``mesh`` (a ``(data, model)``
    mesh's first row: the block's input is replicated over the data
    axis)."""
    return mesh.model_row(0) if isinstance(mesh, DeviceMesh) else mesh


def tp_mlp_block(mesh, activation=torch.tanh):
    """``fn(x, w1, b1, w2, b2) -> y`` with ``w1``/``b1`` split column-wise
    and ``w2`` row-wise over the model axis (:func:`shard_dense_params`):
    rank ``m`` computes ``activation(x @ w1_m + b1_m) @ w2_m`` on its
    device and the partial products are summed, then ``b2`` is added; y on
    the first device."""
    model = _model_axis(mesh)

    def fn(x, w1, b1, w2, b2):
        partials = []
        with dtypes.precision():
            for dev, w1m, b1m, w2m in zip(model.devices, w1, b1, w2):
                h = activation(x.to(dev) @ w1m + b1m)
                partials.append(h @ w2m)
        return model.psum(partials) + b2

    return fn


def shard_dense_params(mesh, w1, b1, w2, b2):
    """The block's params placed for :func:`tp_mlp_block`: ``w1`` (D, H)
    and ``b1`` (H,) split on H, ``w2`` (H, D2) split on its rows, as
    :class:`Shards` over the model axis; ``b2`` whole on the first
    device."""
    model = _model_axis(mesh)
    n = model.size
    if w1.shape[1] % n:
        raise ValueError(f"hidden width {w1.shape[1]} does not split over "
                         f"{n} model ranks")

    def split(t, dim):
        t = torch.as_tensor(t)
        return Shards(p.to(d) for p, d in zip(t.chunk(n, dim=dim),
                                              model.devices))

    return (split(w1, 1), split(b1, 0), split(w2, 0),
            torch.as_tensor(b2).to(model.devices[0]))
