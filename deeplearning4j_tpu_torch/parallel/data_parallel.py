"""Data-parallel training of the DL4J-era nets (the JAX package's
``parallel/data_parallel.py``) over the port's ``DeviceMesh`` and its data
axis: ``DataParallelTrainer`` (the reference's mode 1, per-step gradient
averaging), ``local_sgd_step`` (mode 2, local SGD with parameter averaging)
and ``replica_consensus``.

One controller drives the data ranks: a batch splits into equal contiguous
row shards, one a rank, each on its rank's device with its own copy of the
params. With more than one data rank the ranks run in lock-step
(``parallel/lockstep.py``): a statistic over the batch inside the loss (the
``zero_mean`` preprocessors, BatchNorm) is the whole batch's over the data
axis, combined at a barrier in rank order, as the reference's step over the
sharded batch takes it; each rank runs under ``rng.batch_rows``, so its
dropout masks and samples are its rows of the one draw over the whole batch
that the reference (and one rank) takes with the step's key; one backward of
the ranks' summed losses gives every rank's gradient, and the gradients and
losses are averaged in rank order on the first rank's device, where the
optimizer updates the one copy of the params. One data rank runs the loss
and its gradient as they are. The default optimizer is the reference's
``optax.sgd(1e-2, momentum=0.9)``: ``trace = g + 0.9 * trace``, then ``p +=
-lr * trace``, in f32.

A data axis may span processes (``mesh.hybrid_mesh`` under
``torch.distributed``): every process passes the same global batch to
:meth:`DataParallelTrainer.shard_global_batch`, which keeps the process's
rows (process ``p`` owns global data rows ``p * dp`` onward, and its ranks
draw at those global rows); the batch statistics go through one
``all_reduce`` a statistic, and the gradients and the loss through one
``all_reduce_mean`` bucket a step.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import time

import torch

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device, synchronize, upload
from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad
from deeplearning4j_tpu_torch.parallel import lockstep
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
    host).

    ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``):
    the port's draws are keyed, so the recomputed forward draws the same
    masks. ``donate`` (the reference's default) means here that each step
    updates the params in place and keeps no copy: a ``TrainState`` from an
    earlier step sees the new values, as the reference's donated buffers
    are no longer the old ones. ``stats`` holds the last step's cross-process
    ``bucket_bytes``, ``host_bytes`` and ``allreduce_s`` (all 0 in one
    process)."""

    def __init__(self, loss_fn: LossFn, mesh=None, optimizer=None,
                 donate: bool = True, remat: bool = False):
        self.loss_fn = loss_fn
        if mesh is None:
            resolve_device(None)  # raises without a card
            mesh = mesh_lib.data_parallel_mesh()
        self.mesh = mesh
        self.optimizer = optimizer or SGD(1e-2, momentum=0.9)
        self.donate = donate
        self.remat = remat
        self._value_and_grad = value_and_grad(loss_fn)
        self.stats = {"bucket_bytes": 0, "host_bytes": 0, "allreduce_s": 0.0}

    @property
    def dp(self) -> int:
        """The data ranks of this process."""
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

    def shard_global_batch(self, x, y):
        """:meth:`shard_batch` of this process's rows of the global batch
        every process passes (the batch divides over the global data
        axis); in one process, :meth:`shard_batch`."""
        nproc = self.mesh.num_processes

        def mine(a):
            if nproc == 1:
                return a
            if a.shape[0] % self.mesh.global_data_size:
                raise ValueError(
                    f"the batch ({a.shape[0]}) must divide over the data "
                    f"axis across processes ({self.mesh.global_data_size})")
            per = a.shape[0] // nproc
            p = self.mesh.process_index
            return a[p * per:(p + 1) * per]

        return self.shard_batch(mine(x), mine(y))

    def _loss_and_grads(self, params, x, y, key):
        if self.dp == 1 and self.mesh.num_processes == 1 and not self.remat:
            return self._value_and_grad(params, x, y, key)
        xs, ys = lockstep.shards(self.mesh, x), lockstep.shards(self.mesh, y)
        with dtypes.precision():
            loss, grads = lockstep.value_and_grad(
                self.loss_fn, self.mesh, params,
                [(a, b, key) for a, b in zip(xs, ys)], x.shape[0],
                remat=self.remat)
        if self.mesh.num_processes > 1:
            loss = loss.clone()
            parts = tm.leaves(grads) + [loss.reshape(1)]
            synchronize(loss.device)
            t0 = time.perf_counter()
            bucket, host = mesh_lib.all_reduce_mean(parts, self.mesh)
            synchronize(loss.device)
            self.stats = {"bucket_bytes": bucket, "host_bytes": host,
                          "allreduce_s": time.perf_counter() - t0}
        return loss, grads

    def _apply_grads(self, state: TrainState, grads, loss):
        updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                                   state.params)
        if self.donate:
            with torch.no_grad():
                for p, u in zip(tm.leaves(state.params), tm.leaves(updates)):
                    p.add_(u)
            params = state.params
        else:
            params = tm.add(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

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


def local_sgd_step(loss_fn: LossFn, mesh=None, local_steps: int = 1,
                   lr: float = 0.1, average_every_step: bool = True):
    """Local SGD with parameter averaging (the reference's mode 2):
    ``step(params, x, y, key) -> (params, mean_loss)``, ``x``/``y`` the
    global batch, split over the data ranks of ``mesh`` (every card by
    default). Each rank takes
    ``local_steps`` plain SGD steps (``p - lr * g``) on its shard with keys
    ``split(key, local_steps)``, then the params are averaged over the
    ranks and so is each rank's mean loss, both in rank order on the first
    rank's device (and, on a mesh across processes, over the processes
    with ``all_reduce_mean``). Without ``average_every_step`` the ranks'
    params are not averaged and rank 0's come back, as the reference's
    unaveraged output reads its first replica. ``step.replicas`` holds
    every rank's params after the last step, on its device.

    The reference runs this under ``shard_map``, where a rank sees only its
    shard and draws at its shard's shape with the step's key; so here each
    rank's loss runs as on one device, not under ``rng.batch_rows``: every
    rank takes the first rows' dropout masks (where the trainer takes each
    rank's rows of the whole-batch draw), and a statistic over the batch is
    its shard's."""
    if mesh is None:
        resolve_device(None)  # raises without a card
        mesh = mesh_lib.data_parallel_mesh()
    vg = value_and_grad(loss_fn)
    dp = mesh.axis_size(mesh_lib.DATA_AXIS)
    dev = mesh.devices[0]

    def step(params, x, y, key):
        keys = rng.split(key, local_steps)
        xs, ys = lockstep.shards(mesh, x), lockstep.shards(mesh, y)
        replicas, losses = [], []
        for r in range(dp):
            rdev = mesh.device_at(**{mesh_lib.DATA_AXIS: r})
            p = tm.tree_map(lambda t: t.detach().to(rdev), params)
            rank_losses = []
            for k in keys:
                loss, g = vg(p, xs[r], ys[r], k)
                p = tm.tree_map(lambda pi, gi: pi - lr * gi, p, g)
                rank_losses.append(loss)
            replicas.append(p)
            losses.append(torch.mean(torch.stack(rank_losses)).to(dev))
        loss = sum(losses) / dp
        if not average_every_step:
            step.replicas = replicas
            return replicas[0], loss
        avg = tm.tree_map(lambda *ps: sum(q.to(dev) for q in ps) / dp,
                          *replicas)
        if mesh.num_processes > 1:
            loss = loss.reshape(1)
            mesh_lib.all_reduce_mean(tm.leaves(avg) + [loss], mesh)
            loss = loss[0]
        step.replicas = [tm.tree_map(lambda t: t.to(
            mesh.device_at(**{mesh_lib.DATA_AXIS: r})), avg)
            for r in range(dp)]
        return avg, loss

    step.replicas = []
    return step


def replica_consensus(params_tree) -> torch.Tensor:
    """The largest absolute difference of any replica's parameter from the
    first replica's: ``params_tree``'s leaves carry a leading replica axis
    (a guard the reference's replicas, in separate JVMs, could not
    express). 0 after averaging."""
    leaves = tm.leaves(params_tree)
    dev = leaves[0].device
    return torch.stack([(leaf - leaf[0:1]).abs().max().to(dev)
                        for leaf in leaves]).max()
