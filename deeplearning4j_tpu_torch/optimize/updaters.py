"""Gradient adjustment (the JAX package's ``optimize/updaters.py``):
AdaGrad or lr scaling, the momentum schedule (heavy-ball velocity ``v = m*v
+ g``), L2 as descent-direction weight decay, the unit-norm constraint and
the batch-size division, in the reference's order. The iteration count is
a host int (it depends on no device value)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.utils import tree_math as tm


class UpdaterState(NamedTuple):
    adagrad_hist: object  # tree like params
    velocity: object  # tree like params
    iteration: int


def init(params) -> UpdaterState:
    return UpdaterState(adagrad_hist=tm.zeros_like(params),
                        velocity=tm.zeros_like(params), iteration=0)


def _momentum_at(conf: LayerConfig, iteration: int) -> float:
    """Momentum with the momentum_after schedule applied (an f32 value)."""
    m = conf.momentum
    for thresh, value in sorted(conf.momentum_after.items()):
        if iteration >= thresh:
            m = value
    return float(torch.tensor(m, dtype=torch.float32))


def adjust(conf: LayerConfig, state: UpdaterState, grads, params,
           batch_size: int | None = None) -> tuple[object, UpdaterState]:
    """Adjusted (descent) update direction + new state, in the reference's
    order: adagrad-or-lr -> momentum -> L2 -> unit-norm clip -> divide by
    batch size."""
    it = state.iteration

    hist = state.adagrad_hist
    if (conf.reset_adagrad_iterations > 0 and it > 0
            and it % conf.reset_adagrad_iterations == 0):
        hist = tm.zeros_like(hist)

    if conf.use_adagrad:
        hist = tm.tree_map(lambda h, g: h + g * g, hist, grads)
        step = tm.tree_map(
            lambda g, h: conf.lr * g / (torch.sqrt(h) + 1e-6), grads, hist)
    else:
        step = tm.scale(grads, conf.lr)

    m = _momentum_at(conf, it)
    velocity = tm.tree_map(lambda v, s: m * v + s, state.velocity, step)
    step = velocity

    if conf.use_regularization and conf.l2 > 0:
        step = tm.tree_map(lambda s, p: s + conf.l2 * conf.lr * p, step, params)

    if conf.constrain_gradient_to_unit_norm:
        step = tm.scale(step, 1.0 / (tm.norm2(step) + 1e-12))

    if batch_size is not None and batch_size > 1:
        # scores are already batch means: only for reference parity
        step = tm.scale(step, 1.0 / batch_size)

    return step, UpdaterState(adagrad_hist=hist, velocity=velocity,
                              iteration=it + 1)
