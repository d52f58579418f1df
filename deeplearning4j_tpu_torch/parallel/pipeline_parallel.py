"""Pipeline (stage) parallelism: the GPipe microbatch schedule (the JAX
package's ``parallel/pipeline_parallel.py``).

The network's trunk is ``n_stages`` identically shaped stage functions
``stage_fn(stage_params, h) -> h``, their params stacked on a leading stage
axis (:func:`stack_stage_params`) and placed one stage a device of a mesh's
``pipe`` axis (:func:`pipeline_mesh`; a device may repeat). A batch splits
into ``M`` microbatches (:func:`split_microbatches`). One controller runs
the ``M + S - 1`` ticks of the schedule: at tick ``t`` stage ``s`` applies
itself to microbatch ``t - s`` (stage 0 takes it from the input, a later
stage the activation stage ``s - 1`` sent it at tick ``t - 1``), sends its
activation to stage ``s + 1``'s device, and only the last stage writes the
output. Autograd through the ticks is the backward pipeline. The bubble is
GPipe's ``(S - 1) / (M + S - 1)``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
from deeplearning4j_tpu_torch.utils import tree_math as tm

PIPE_AXIS = "pipe"

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]  # (stage params, h) -> h


def pipeline_mesh(n_stages: int, devices=None) -> mesh_lib.DeviceMesh:
    """A 1-D mesh of ``n_stages`` devices on the ``pipe`` axis: the first
    ``n_stages`` cards (``ValueError`` with fewer, in the reference's
    words), or ``devices`` (a device may repeat)."""
    if devices is None:
        resolve_device(None)  # raises without a card
        have = torch.cuda.device_count()
        if have < n_stages:
            raise ValueError(f"pipeline needs {n_stages} devices, have "
                             f"{have}")
    return mesh_lib._mesh_1d(PIPE_AXIS, n_stages, devices)


def stack_stage_params(params_list: list[Any]) -> Any:
    """Per-stage param trees stacked on a new leading stage axis."""
    return tm.tree_map(lambda *xs: torch.stack(
        [torch.as_tensor(x) for x in xs]), *params_list)


def _stages(mesh, stacked) -> list:
    """Each stage's params on its device: ``stacked`` a tree with a
    leading stage axis, or the list :func:`pipeline_train_step`'s
    ``place`` makes."""
    n = mesh.axis_size(PIPE_AXIS)
    if isinstance(stacked, list):
        parts = stacked
    else:
        leading = {leaf.shape[0] for leaf in tm.leaves(stacked)}
        if leading != {n}:
            # a longer stack would drop stages, as the reference's
            # per-device block check guards
            raise ValueError(f"stage-param stack does not match pipe axis "
                             f"({n} devices, stacks of {sorted(leading)})")
        parts = [tm.tree_map(lambda a: a[s], stacked) for s in range(n)]
    if len(parts) != n:
        raise ValueError(f"stage-param stack does not match pipe axis ({n} "
                         f"devices, {len(parts)} stages)")
    return [tm.tree_map(lambda a: a.to(mesh.device_at(**{PIPE_AXIS: s})), p)
            for s, p in enumerate(parts)]


def _schedule(mesh, stage_fn: StageFn, stacked, x) -> torch.Tensor:
    stages = _stages(mesh, stacked)
    n, m = len(stages), x.shape[0]
    devs = [mesh.device_at(**{PIPE_AXIS: s}) for s in range(n)]
    sent: list = [None] * n  # stage s's activation of the previous tick
    out: list = [None] * m
    for t in range(m + n - 1):
        # the last stage first: each stage reads what the one before it
        # sent on the previous tick
        for s in reversed(range(n)):
            mb = t - s
            if not 0 <= mb < m:
                continue
            inp = x[mb].to(devs[0]) if s == 0 else sent[s - 1]
            h = stage_fn(stages[s], inp)
            if s == n - 1:
                out[mb] = h.to(devs[0])
            else:
                sent[s] = h.to(devs[s + 1])
    return torch.stack(out)


def pipeline_apply(mesh, stage_fn: StageFn):
    """``fn(stacked_params, x) -> y``: ``stacked_params``' leaves carry a
    leading stage axis as long as the mesh's pipe axis, ``x`` is ``(M,
    microbatch, ...)``; y ``(M, microbatch, ...)`` on the mesh's first
    device."""
    def fn(stacked, x):
        with dtypes.precision():
            return _schedule(mesh, stage_fn, stacked, x)

    return fn


def split_microbatches(x, n_micro: int):
    """(B, ...) -> (M, B/M, ...)."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} does not split into {n_micro} "
                         f"microbatches")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def pipeline_train_step(mesh, stage_fn: StageFn,
                        loss_fn: Callable[[Any, torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                        optimizer=None):
    """A training step through the pipeline: returns ``(step, init,
    place)``. ``loss_fn(head_params, h, y)`` takes the pipeline's output h
    ``(M, mb, D)``; params are ``(stages, head_params)`` as ``place((stacked,
    head))`` lays them out (each stage's params on its device, the head on
    the first); ``init(params)`` is the optimizer state and ``step(params,
    opt_state, x, y) -> (params, opt_state, loss)``, the loss a 0-dim
    tensor. The optimizer defaults to the reference's ``sgd(1e-2,
    momentum=0.9)`` (``data_parallel.SGD``)."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import SGD

    optimizer = optimizer or SGD(1e-2, momentum=0.9)
    dev = mesh.devices[0]

    def loss(params, x, y):
        stages, head = params
        return loss_fn(head, _schedule(mesh, stage_fn, stages, x.to(dev)),
                       y.to(dev))

    grad_fn = value_and_grad(loss)

    def place(params):
        stacked, head = params
        return (_stages(mesh, stacked),
                tm.tree_map(lambda a: torch.as_tensor(a).to(dev), head))

    def step(params, opt_state, x, y):
        value, grads = grad_fn(params, x, y)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return tm.add(params, updates), opt_state, value

    return step, optimizer.init, place
