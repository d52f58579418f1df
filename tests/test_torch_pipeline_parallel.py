"""Pipeline parallelism in the port (``parallel/pipeline_parallel.py``) on
``["cpu"] * 4``: the reference's ``tests/test_pipeline_parallel.py`` cases
(the schedule against the sequential stage stack, one microbatch, the
backward pipeline's gradients, training), each also held against the JAX
package's pipeline on its 4 virtual devices with the same stage params,
and the stage-stack check.

Tolerances: ``ATOL`` for f32 outputs and gradients (the reference's bar);
``LOSS_RTOL`` for losses over 30 SGD steps against the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.parallel import pipeline_parallel as jpp
from deeplearning4j_tpu_torch.parallel.data_parallel import SGD
from deeplearning4j_tpu_torch.parallel.pipeline_parallel import (
    pipeline_apply,
    pipeline_mesh,
    pipeline_train_step,
    split_microbatches,
    stack_stage_params,
)
from deeplearning4j_tpu_torch.utils import tree_math as tm

torch.set_num_threads(1)

N_STAGES = 4
D = 8
ATOL = 1e-5
LOSS_RTOL = 1e-4


def _mesh():
    return pipeline_mesh(N_STAGES, devices=["cpu"] * N_STAGES)


def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _jstage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _stage_params(n_stages=N_STAGES, d=D, seed=0):
    rs = np.random.default_rng(seed)
    return [{"w": rs.normal(size=(d, d)).astype(np.float32) * 0.5,
             "b": rs.normal(size=(d,)).astype(np.float32) * 0.1}
            for _ in range(n_stages)]


def _t(params_list):
    return [{k: torch.from_numpy(v) for k, v in p.items()}
            for p in params_list]


def _sequential(params_list, x):
    for p in params_list:
        x = _stage_fn(p, x)
    return x


def test_pipeline_matches_sequential():
    params_list = _stage_params()
    apply = pipeline_apply(_mesh(), _stage_fn)
    x = np.random.default_rng(1).normal(size=(24, D)).astype(np.float32)
    micro = split_microbatches(torch.from_numpy(x), 6)  # M=6 of 4
    y = apply(stack_stage_params(_t(params_list)), micro)
    torch.testing.assert_close(y.reshape(24, D), _sequential(
        _t(params_list), torch.from_numpy(x)), rtol=0, atol=ATOL)
    # microbatch by microbatch, the schedule is the stack's arithmetic
    for m in range(6):
        assert torch.equal(y[m], _sequential(_t(params_list), micro[m]))
    jy = jpp.pipeline_apply(jpp.pipeline_mesh(N_STAGES), _jstage_fn)(
        jpp.stack_stage_params(params_list),
        jpp.split_microbatches(jnp.asarray(x), 6))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)


def test_pipeline_single_microbatch():
    params_list = _t(_stage_params(seed=3))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 4, D)).astype(np.float32))
    y = pipeline_apply(_mesh(), _stage_fn)(stack_stage_params(params_list),
                                           x)
    torch.testing.assert_close(y[0], _sequential(params_list, x[0]), rtol=0,
                               atol=ATOL)


def test_pipeline_gradients_match_sequential():
    """Autograd through the ticks (the backward pipeline) == the
    sequential stack's gradients, and the reference's pipeline's."""
    params_list = _stage_params(seed=5)
    apply = pipeline_apply(_mesh(), _stage_fn)
    rs = np.random.default_rng(7)
    micro = rs.normal(size=(4, 2, D)).astype(np.float32)
    tgt = rs.normal(size=(4, 2, D)).astype(np.float32)

    def grads(loss):
        stacked = tm.tree_map(lambda a: a.requires_grad_(True),
                              stack_stage_params(_t(params_list)))
        g = torch.autograd.grad(loss(stacked), list(stacked.values()))
        return dict(zip(stacked, g))

    def loss_pipe(stacked):
        y = apply(stacked, torch.from_numpy(micro))
        return torch.mean((y - torch.from_numpy(tgt)) ** 2)

    def loss_seq(stacked):
        h = torch.from_numpy(micro).reshape(-1, D)
        for s in range(N_STAGES):
            h = _stage_fn(tm.tree_map(lambda a: a[s], stacked), h)
        return torch.mean((h.reshape(micro.shape) - torch.from_numpy(tgt))
                          ** 2)

    g_pipe, g_seq = grads(loss_pipe), grads(loss_seq)
    japply = jpp.pipeline_apply(jpp.pipeline_mesh(N_STAGES), _jstage_fn)
    jg = jax.grad(lambda st: jnp.mean((japply(st, jnp.asarray(micro))
                                       - jnp.asarray(tgt)) ** 2))(
        jpp.stack_stage_params(params_list))
    for k in ("w", "b"):
        torch.testing.assert_close(g_pipe[k], g_seq[k], rtol=0, atol=ATOL)
        np.testing.assert_allclose(g_pipe[k].numpy(), np.asarray(jg[k]),
                                   rtol=0, atol=ATOL)


def test_pipeline_training_reduces_loss():
    """30 steps of SGD 0.5 momentum 0.9 through the pipeline: the loss
    falls below 0.7 of the first; the losses are the reference's
    pipeline_train_step's from the same params."""
    stages = _stage_params(seed=9)
    head = {"w": np.zeros((D, 3), np.float32), "b": np.zeros((3,), np.float32)}

    def loss_fn(head, h, y):
        logits = h @ head["w"] + head["b"]
        return -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean()

    def jloss_fn(head, h, y):
        return optax.softmax_cross_entropy(h @ head["w"] + head["b"],
                                           y).mean()

    step, opt_init, place = pipeline_train_step(_mesh(), _stage_fn, loss_fn,
                                                SGD(0.5, momentum=0.9))
    params = place((stack_stage_params(_t(stages)),
                    {k: torch.from_numpy(v) for k, v in head.items()}))
    opt_state = opt_init(params)
    jmesh = jpp.pipeline_mesh(N_STAGES)
    jstep, jopt_init, jplace = jpp.pipeline_train_step(
        jmesh, _jstage_fn, jloss_fn, optax.sgd(0.5, momentum=0.9))
    jparams = jplace((jpp.stack_stage_params(stages),
                      jax.tree.map(jnp.asarray, head)))
    jopt = jopt_init(jparams)

    rs = np.random.default_rng(11)
    x = rs.normal(size=(32, D)).astype(np.float32)
    w_true = rs.normal(size=(D, 3))
    y = np.eye(3, dtype=np.float32)[(x @ w_true).argmax(1)]
    mx, my = (split_microbatches(torch.from_numpy(a), 8) for a in (x, y))
    jmx, jmy = (jpp.split_microbatches(jnp.asarray(a), 8) for a in (x, y))
    losses, ref = [], []
    for _ in range(30):
        params, opt_state, value = step(params, opt_state, mx, my)
        jparams, jopt, jl = jstep(jparams, jopt, jmx, jmy)
        losses.append(value.item())
        ref.append(float(jl))
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    np.testing.assert_allclose(losses[:10], ref[:10], rtol=LOSS_RTOL)


def test_stage_stack_must_match_the_pipe_axis():
    """The reference's check: a stack of 2 * S stages (or of S - 1) on an
    S-stage axis raises instead of dropping stages."""
    apply = pipeline_apply(_mesh(), _stage_fn)
    x = torch.zeros((2, 2, D))
    for n in (2 * N_STAGES, N_STAGES - 1):
        with pytest.raises(ValueError, match="does not match pipe axis"):
            apply(stack_stage_params(_t(_stage_params(n))), x)
