"""Data ranks in lock-step, and batch statistics over the data axis.

The reference runs a data-parallel step as one SPMD program over the batch
sharded across its mesh: a mean over the batch inside the loss (the
``zero_mean`` preprocessors, ResNet's BatchNorm) is the whole batch's,
because XLA inserts the cross-replica reduction. The port drives the data
ranks from one controller, so it runs them in lock-step: :func:`run_ranks`
starts each local rank's function in a thread of its own, and every call of
:func:`batch_moments` inside them is a barrier at which the ranks' ``(count,
mean, M2)`` are combined in rank order on the first rank's device, by Chan's
pairwise update (which does not cancel, as the raw moments ``E[x^2] -
E[x]^2`` do), and handed back to each rank. Gradients flow through the
combination. Across processes (a mesh from ``mesh.hybrid_mesh``) the
process's combined statistic then goes through one autograd ``all_reduce``
(each process's row of a zeroed (processes, k) matrix, so the sum is a
gather) and the processes' rows are combined in process order, the same
arithmetic in every process; the backward sees the collective too.

Outside :func:`run_ranks`, :func:`batch_moments` is the batch's own
``torch.mean`` and ``torch.var``/``torch.std`` (population), so one rank
computes exactly what a plain forward does.

Each rank runs under ``rng.batch_rows`` of its global rows, so its dropout
masks and samples are its rows of the one draw over the whole batch.
``dtypes.precision`` sets process-wide switches: a caller wraps the whole
lock-step forward and backward in it, so the ranks' own scopes set and put
back the same values.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib

_local = threading.local()

#: a rank that finished its function; the others must have finished too
_DONE = "done"


class _Group:
    """The local data ranks of one lock-step run: one slot a rank, a
    barrier whose action combines the slots."""

    def __init__(self, mesh, n: int):
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.slots: list = [None] * n
        self.result = None
        self.barrier = threading.Barrier(n, action=self._combine)

    def _combine(self) -> None:
        kinds = {s is _DONE for s in self.slots}
        if len(kinds) > 1:
            raise RuntimeError("the data ranks took different numbers of "
                               "batch statistics")
        if kinds == {True}:
            return
        stats = [(n, m.to(self.device), q.to(self.device))
                 for n, m, q in self.slots]
        self.result = _across_processes(self.mesh, _chan(stats))

    def moments(self, index: int, stat):
        self.slots[index] = stat
        self.barrier.wait()
        return self.result

    def leave(self, index: int) -> None:
        self.slots[index] = _DONE
        self.barrier.wait()


def _chan(stats):
    """``(count, mean, M2)`` of the union, combined pairwise in order."""
    n, mean, m2 = stats[0]
    for nb, mb, m2b in stats[1:]:
        tot = n + nb
        delta = mb - mean
        mean = mean + delta * (nb / tot)
        m2 = m2 + m2b + delta * delta * (n * nb / tot)
        n = tot
    return n, mean, m2


def _across_processes(mesh, stat):
    """The processes' statistics combined in process order: one autograd
    ``all_reduce`` of a zeroed (processes, 2, ...) tensor holding this
    process's (mean, M2) in its row."""
    nproc = mesh.num_processes
    if nproc == 1:
        return stat
    import torch.distributed.nn.functional as dist_fn

    n, mean, m2 = stat
    rows = torch.stack([mean, m2])[None]

    def zeros(k: int) -> torch.Tensor:
        return rows.new_zeros((k, *rows.shape[1:]))

    p = mesh.process_index
    slab = dist_fn.all_reduce(torch.cat([zeros(p), rows,
                                         zeros(nproc - p - 1)]))
    return _chan([(n, slab[q, 0], slab[q, 1]) for q in range(nproc)])


def batch_moments(x: torch.Tensor, dims, std: bool = False):
    """``(mean, var)`` of ``x`` over ``dims`` (kept as size-1 dims), the
    population variance; ``(mean, std)`` with ``std``. Inside
    :func:`run_ranks` the statistics are the whole batch's over the data
    axis (every rank's rows, every process's); outside it they are
    ``torch.mean`` and ``torch.var``/``torch.std`` of ``x`` itself."""
    dims = tuple(d % x.dim() for d in dims)
    rank = getattr(_local, "rank", None)
    if rank is None:
        spread = torch.std if std else torch.var
        return (torch.mean(x, dim=dims, keepdim=True),
                spread(x, dim=dims, keepdim=True, unbiased=False))
    group, index = rank
    mean = torch.mean(x, dim=dims, keepdim=True)
    m2 = torch.sum(torch.square(x - mean), dim=dims, keepdim=True)
    count = math.prod(x.shape[d] for d in dims)
    stat = (count, mean, m2)
    if group is None:  # one local rank: the processes' statistics only
        total = _across_processes(_local.mesh, stat)
    else:
        total = group.moments(index, stat)
    n, mean, m2 = total
    var = (m2 / n).to(x.device)
    return mean.to(x.device), torch.sqrt(var) if std else var


def shards(mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """``t``'s rows split over the mesh's local data ranks, each on its
    rank's device."""
    dp = mesh.axis_size(mesh_lib.DATA_AXIS)
    if t.shape[0] % dp:
        raise ValueError(f"batch {t.shape[0]} does not split over {dp} data "
                         f"ranks")
    return [s.to(mesh.device_at(**{mesh_lib.DATA_AXIS: r}))
            for r, s in enumerate(t.chunk(dp))]


def run_ranks(mesh, fn: Callable[[int], Any], rows: int) -> list:
    """``fn(r)`` for each local data rank ``r`` of ``mesh``, in lock-step at
    :func:`batch_moments`, each under ``rng.batch_rows`` of its global rows
    of a batch of ``rows`` rows a process (process ``p``'s rank ``r`` is
    global data rank ``p * dp + r``); the results in rank order. One local
    rank runs in the calling thread; more run a thread each, with the
    caller's grad mode."""
    dp = mesh.axis_size(mesh_lib.DATA_AXIS)
    nproc = mesh.num_processes
    per = rows // dp
    first = mesh.process_index * dp
    total = per * dp * nproc

    def call(r: int, group):
        with rng.batch_rows((first + r) * per, total):
            if group is None and nproc == 1:  # the whole batch is here
                return fn(r)
            prev = (getattr(_local, "rank", None),
                    getattr(_local, "mesh", None))
            _local.rank, _local.mesh = (group, r), mesh
            try:
                return fn(r)
            finally:
                _local.rank, _local.mesh = prev

    if dp == 1:
        return [call(0, None)]
    group = _Group(mesh, dp)
    grad = torch.is_grad_enabled()
    out: list = [None] * dp
    errors: list = [None] * dp

    def work(r: int) -> None:
        try:
            with torch.set_grad_enabled(grad):
                out[r] = call(r, group)
            group.leave(r)
        except BaseException as e:  # handed to the caller below
            errors[r] = e
            group.barrier.abort()

    threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                name=f"data-rank-{r}") for r in range(dp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        # the first error that is not another rank's broken barrier
        raise next((e for e in raised
                    if not isinstance(e, threading.BrokenBarrierError)),
                   raised[0])
    return out


def value_and_grad(loss_fn: Callable, mesh, params, rank_args: list,
                   rows: int, has_aux: bool = False, remat: bool = False):
    """The mean over the local data ranks of ``loss_fn(params_r,
    *rank_args[r])`` and its gradient, each rank with its own copy of the
    params on its device, the ranks in lock-step (:func:`run_ranks`): one
    backward of the sum of the ranks' losses, then the losses and the
    gradients averaged in rank order on the first rank's device (detached).
    With ``has_aux`` the loss function returns ``(loss, aux)`` and rank 0's
    aux is returned too. ``remat`` recomputes the ranks' forward in the
    backward (``torch.utils.checkpoint``, the reentrant form: the forward
    runs in the ranks' threads, whose saved tensors a hook of the caller's
    thread would not see)."""
    dp = mesh.axis_size(mesh_lib.DATA_AXIS)
    dev = mesh.devices[0]
    leaves, spec = pytree.tree_flatten(params)
    devs = [mesh.device_at(**{mesh_lib.DATA_AXIS: r}) for r in range(dp)]
    lives = [[leaf.detach().to(d).requires_grad_(True) for leaf in leaves]
             for d in devs]
    aux_box: list = [None]

    def forward(*flat):
        def rank(r: int):
            p = pytree.tree_unflatten(
                list(flat[r * len(leaves):(r + 1) * len(leaves)]), spec)
            out = loss_fn(p, *rank_args[r])
            return out if has_aux else (out, None)

        outs = run_ranks(mesh, rank, rows)
        aux_box[0] = outs[0][1]
        return torch.stack([loss.to(dev) for loss, _ in outs])

    flat = [leaf for live in lives for leaf in live]
    with torch.enable_grad():
        if remat:
            from torch.utils.checkpoint import checkpoint

            losses = checkpoint(forward, *flat, use_reentrant=True,
                                preserve_rng_state=False)
            losses.sum().backward()
            grads = [leaf.grad for leaf in flat]
        else:
            losses = forward(*flat)
            grads = torch.autograd.grad(list(losses.unbind()), flat,
                                        allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g.detach()
             for leaf, g in zip(flat, grads)]
    n = len(leaves)
    mean = [sum(grads[r * n + i].to(dev) for r in range(dp)) / dp
            for i in range(n)]
    loss = sum(losses.detach().unbind()) / dp
    out = (loss, pytree.tree_unflatten(mean, spec))
    return (*out, aux_box[0]) if has_aux else out
