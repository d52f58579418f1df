"""Per-step gradient-averaging data-parallel training (the JAX package's
``parallel/data_parallel.py`` ``DataParallelTrainer``, mode 1) over the
port's ``DeviceMesh`` and its data axis.

One controller drives the data ranks: a global batch splits into equal
contiguous row shards, one a rank; each rank takes the loss and gradient
of its shard on its device, and the gradients and losses are averaged on
the first rank's device (in rank order), where the optimizer updates the
one copy of the params. With equal shards the averages are the
whole-batch mean loss and its gradient, what the reference's step computes
over the sharded batch. Each rank runs its loss under ``rng.batch_rows``,
so its dropout masks and samples are its rows of the one draw over the
whole batch that the reference (and one rank) takes with the step's key;
a loss that takes statistics over the batch (the ``zero_mean``
preprocessors) sees its own shard's. The default optimizer is the reference's
``optax.sgd(1e-2, momentum=0.9)``: ``trace = g + 0.9 * trace``, then ``p
+= -lr * trace``, in f32.

The reference's ``donate`` and ``remat`` options, its local-SGD mode,
replica consensus and the data axis across processes for these nets come
in a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
from deeplearning4j_tpu_torch.utils import tree_math as tm

LossFn = Callable[..., torch.Tensor]  # (params, batch_x, batch_y, key) -> scalar


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


class SGD:
    """optax's ``sgd(learning_rate, momentum)`` (``trace`` then
    ``scale_by_learning_rate``) in the same f32 arithmetic: ``init``
    and ``update(grads, state, params) -> (updates, state)``."""

    def __init__(self, learning_rate: float, momentum: float | None = None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params):
        return tm.zeros_like(params) if self.momentum else ()

    def update(self, grads, state, params=None):
        if self.momentum:
            state = tm.tree_map(lambda g, t: g + self.momentum * t, grads,
                                state)
            grads = state
        return tm.scale(grads, -self.learning_rate), state


class DataParallelTrainer:
    """Per-step gradient-averaging trainer over a data-axis mesh (every
    card by default; ``data_parallel_mesh(devices=["cpu"])`` on the
    host)."""

    def __init__(self, loss_fn: LossFn, mesh=None, optimizer=None):
        self.loss_fn = loss_fn
        if mesh is None:
            resolve_device(None)  # raises without a card
            mesh = mesh_lib.data_parallel_mesh()
        self.mesh = mesh
        self.optimizer = optimizer or SGD(1e-2, momentum=0.9)
        self._value_and_grad = value_and_grad(loss_fn)

    @property
    def dp(self) -> int:
        return self.mesh.axis_size(mesh_lib.DATA_AXIS)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def init(self, params) -> TrainState:
        """The state on the first rank's device, the params copied (the
        caller's tensors are not updated)."""
        params = tm.tree_map(lambda t: t.detach().to(self.device, copy=True),
                             params)
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params), step=0)

    def shard_batch(self, x, y):
        """A host (numpy) or device batch on the first rank's device; the
        step splits it over the data axis."""
        def put(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device)
            return upload(a, self.device)

        return put(x), put(y)

    def _loss_and_grads(self, params, x, y, key):
        if self.dp == 1:
            return self._value_and_grad(params, x, y, key)
        if x.shape[0] % self.dp:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{self.dp} data ranks")
        losses, grads = [], []
        rows = x.shape[0] // self.dp
        for d, (xs, ys) in enumerate(zip(x.chunk(self.dp), y.chunk(self.dp))):
            dev = self.mesh.devices[d]
            p = tm.tree_map(lambda t: t.to(dev), params)
            with rng.batch_rows(d * rows, x.shape[0]):
                loss, g = self._value_and_grad(p, xs.to(dev), ys.to(dev),
                                               key)
            losses.append(loss.to(self.device))
            grads.append(tm.tree_map(lambda t: t.to(self.device), g))
        mean = tm.tree_map(lambda *gs: sum(gs) / self.dp, *grads)
        return sum(losses) / self.dp, mean

    def _apply_grads(self, state: TrainState, grads, loss):
        updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                                   state.params)
        return TrainState(tm.add(state.params, updates), opt_state,
                          state.step + 1), loss

    def step(self, state: TrainState, x, y, key) -> tuple[TrainState, torch.Tensor]:
        """One update from the batch; the loss a 0-dim tensor (no host
        sync)."""
        loss, grads = self._loss_and_grads(state.params, x, y, key)
        return self._apply_grads(state, grads, loss)

    def run_steps(self, state: TrainState, x, y, key,
                  n_steps: int) -> tuple[TrainState, torch.Tensor]:
        """``n_steps`` updates on one batch, keys ``split(key, n_steps)``;
        returns ``(state, losses[n_steps])``."""
        losses = []
        for k in rng.split(key, n_steps):
            state, loss = self.step(state, x, y, k)
            losses.append(loss)
        return state, torch.stack(losses)

    def fit_epoch(self, state: TrainState, xs, ys,
                  key) -> tuple[TrainState, torch.Tensor]:
        """One pass over staged minibatches ``xs[n, B, ...]``, keys
        ``split(key, n)``; returns ``(state, losses[n])``."""
        losses = []
        for x, y, k in zip(xs, ys, rng.split(key, xs.shape[0])):
            state, loss = self.step(state, x, y, k)
            losses.append(loss)
        return state, torch.stack(losses)

    def step_accumulate(self, state: TrainState, xs, ys,
                        key) -> tuple[TrainState, torch.Tensor]:
        """One update from the gradients averaged over the leading
        microbatch axis of ``xs[n_micro, B, ...]`` (keys ``split(key,
        n_micro)``); returns ``(state, mean_loss)``."""
        n = xs.shape[0]
        g_sum, loss_sum = tm.zeros_like(state.params), 0.0
        for x, y, k in zip(xs, ys, rng.split(key, n)):
            loss, g = self._loss_and_grads(state.params, x, y, k)
            g_sum = tm.add(g_sum, g)
            loss_sum = loss_sum + loss
        grads = tm.tree_map(lambda g: g / n, g_sum)
        return self._apply_grads(state, grads, loss_sum / n)
