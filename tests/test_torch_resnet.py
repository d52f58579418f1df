"""ResNet with BatchNorm in the port (``models/resnet.py``), held against
the JAX package's on the CPU: the init on the reference's keys, the
forward and the train step from the reference's params (16 x 16 and odd 7 x
7 sides, where the count-corrected stage pool decides), sync-BN over a
data axis of ``["cpu"] * 8`` against one rank and the reference, and the
reference's ``tests/test_resnet.py`` cases (its CIFAR acceptance stays
``slow``, as the reference marks it).

Tolerances: ``ATOL`` for f32 logits, BN statistics and params after a step
against the reference's (sums and rsqrt in other orders); ``SYNC_TOL``
for dp 8 against dp 1 (the reference's bar); ``BF16_RTOL`` for MIXED_BF16
logits (norm-relative: bf16 convs round each product)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.models import resnet as jr
from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.models.resnet import (
    ResNetConfig,
    init_resnet,
    params_from_jax,
    params_to_jax,
    resnet_apply,
    resnet_run_steps,
    resnet_train_step,
)
from deeplearning4j_tpu_torch.parallel import lockstep
from deeplearning4j_tpu_torch.parallel.data_parallel import SGD
from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

torch.set_num_threads(1)

ATOL = 1e-5
SYNC_TOL = 1e-5
BF16_RTOL = 2e-2
KW = dict(num_classes=4, blocks_per_stage=1, stage_channels=(8, 16))
CFG, JCFG = ResNetConfig(**KW), jr.ResNetConfig(**KW)
#: the reference's init as one program (its eager ops compile one by one)
_JINIT = jax.jit(jr.init_resnet, static_argnums=1)


def _data(n=16, hw=16, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, hw, hw, 3)).astype(np.float32)
    labels = rs.integers(0, 4, n)
    x += labels[:, None, None, None] * 0.7
    return x, np.eye(4, dtype=np.float32)[labels]


def _mesh(dp):
    return data_parallel_mesh(devices=["cpu"] * dp)


@functools.lru_cache(maxsize=None)
def _reference_init(seed):
    return _JINIT(jax.random.key(seed), JCFG)


def _carried(seed=0):
    """The reference's init for ``seed`` and the port's params from it:
    (jparams, jstate, params, state)."""
    jp, js = _reference_init(seed)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return jp, js, *params_from_jax(to_np(jp), to_np(js), device="cpu")


def _assert_trees(got, want, atol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=atol)


def test_init_matches_the_reference_and_carries_both_ways():
    """The reference's key splits and draws (``normal`` within a few
    ulps of ``jax.random.normal``); ``params_to_jax`` of
    ``params_from_jax`` bitwise."""
    jp, js = _reference_init(3)
    p, s = init_resnet(rng.key_for(3), CFG, device="cpu")
    got_p, got_s = params_to_jax(p, s)
    _assert_trees(got_p, jp, 1e-6)
    _assert_trees(got_s, js, 0)
    back = params_to_jax(*params_from_jax(got_p, got_s, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves((got_p, got_s))):
        np.testing.assert_array_equal(a, b)
    assert p["stem"]["w"].shape == (8, 3, 3, 3)  # OIHW


def test_forward_and_step_match_the_reference():
    """From the reference's params: train- and eval-mode logits and the
    rolled BN state, then one SGD step's loss, params and state."""
    jp, js, p, s = _carried(1)
    x, y = _data(16, 16, seed=16)
    for train in (True, False):
        jl, jns = jr.resnet_apply(JCFG, train)(jp, js, jnp.asarray(x))
        logits, ns = resnet_apply(CFG, train)(p, s, torch.from_numpy(x))
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                                   rtol=0, atol=ATOL)
        _assert_trees(params_to_jax(p, ns)[1], jns, ATOL)
    jstep, _ = jr.resnet_train_step(JCFG)
    jo = optax.sgd(0.1, momentum=0.9).init(jp)
    jp2, js2, _, jloss = jstep(jax.tree.map(jnp.copy, jp),
                               jax.tree.map(jnp.copy, js), jo,
                               jnp.asarray(x), jnp.asarray(y))
    step, _ = resnet_train_step(CFG, device="cpu")
    p2, s2, _, loss = step(p, s, SGD(0.1, momentum=0.9).init(p), x, y)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=ATOL)
    got_p, got_s = params_to_jax(p2, s2)
    _assert_trees(got_p, jp2, ATOL)
    _assert_trees(got_s, js2, ATOL)


def test_stage_pool_divides_border_windows_by_their_count(monkeypatch):
    """On a 7 x 7 map the SAME 2 x 2 pool's last window holds one row or
    column: ``avg_pool2d(ceil_mode=True)`` divides it by its in-bounds
    count, as the reference's reduce_window quotient; a fixed divisor of 4
    moves the logits far off the reference's (this test sees it)."""
    rs = np.random.default_rng(4)
    h = rs.normal(size=(2, 3, 7, 7)).astype(np.float32)
    nhwc = jnp.asarray(h.transpose(0, 2, 3, 1))
    from jax import lax

    pooled = lax.reduce_window(nhwc, 0.0, lax.add, (1, 2, 2, 1),
                               (1, 2, 2, 1), "SAME")
    counts = lax.reduce_window(jnp.ones((1, 7, 7, 1)), 0.0, lax.add,
                               (1, 2, 2, 1), (1, 2, 2, 1), "SAME")
    want = np.asarray(pooled / counts).transpose(0, 3, 1, 2)
    got = resnet._avg_pool_same(torch.from_numpy(h))
    assert got.shape == (2, 3, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the whole net on 7 x 7 images (its stage pool over 7 x 7 maps), train
    # mode: the reference's logits; with a fixed divisor of 4, far off
    jp, js, p, s = _carried(2)
    x, _ = _data(4, 7, seed=6)
    ref = np.asarray(jr.resnet_apply(JCFG, True)(jp, js, jnp.asarray(x))[0])
    got = resnet_apply(CFG, True)(p, s, torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=ATOL)
    monkeypatch.setattr(resnet, "_avg_pool_same", lambda t: F.avg_pool2d(
        F.pad(t, (0, t.shape[-1] % 2, 0, t.shape[-2] % 2)), 2, 2))
    wrong = resnet_apply(CFG, True)(p, s, torch.from_numpy(x))[0]
    assert np.abs(wrong.detach().numpy() - ref).max() > 1e-3


def test_forward_shapes_and_state_update():
    params, state = init_resnet(rng.key_for(0), CFG, device="cpu")
    x = torch.from_numpy(_data()[0])
    logits, new_state = resnet_apply(CFG, train=True)(params, state, x)
    assert logits.shape == (16, 4)
    assert not torch.equal(new_state["stem"]["mean"], state["stem"]["mean"])
    l1, s1 = resnet_apply(CFG, train=False)(params, state, x)
    l2, _ = resnet_apply(CFG, train=False)(params, state, x)
    assert torch.equal(l1, l2)
    assert torch.equal(s1["stem"]["mean"], state["stem"]["mean"])


def test_trains_and_eval_mode_classifies():
    step, init = resnet_train_step(CFG, device="cpu")
    params, state, opt_state = init(rng.key_for(1))
    x, y = _data(n=32, seed=1)
    losses = []
    for _ in range(40):
        params, state, opt_state, loss = step(params, state, opt_state, x, y)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses[::10]
    logits, _ = resnet_apply(CFG, train=False)(params, state,
                                               torch.from_numpy(x))
    acc = (logits.argmax(-1) == torch.from_numpy(y).argmax(-1)).float()
    assert acc.mean().item() >= 0.75


def test_sync_bn_over_ranks_matches_full_batch():
    """BN over 8 lock-step ranks, each with its batch shard, is BN over the
    whole batch: outputs and the rolled state (the reference's sync-BN
    contract)."""
    rs = np.random.default_rng(3)
    x = torch.from_numpy(rs.normal(size=(32, 6, 4, 4)).astype(np.float32)
                         * 2 + 1)
    p = {"scale": torch.from_numpy(rs.normal(size=(6,)).astype(np.float32)),
         "bias": torch.from_numpy(rs.normal(size=(6,)).astype(np.float32))}
    s = {"mean": torch.zeros(6), "var": torch.ones(6)}
    y_ref, s_ref = resnet._batch_norm(x, p, s, True, 0.9, 1e-5)
    shards = x.chunk(8)
    outs = lockstep.run_ranks(_mesh(8), lambda r: resnet._batch_norm(
        shards[r], p, s, True, 0.9, 1e-5), 32)
    torch.testing.assert_close(torch.cat([o[0] for o in outs]), y_ref,
                               rtol=SYNC_TOL, atol=SYNC_TOL)
    for _, s_new in outs:
        for k in ("mean", "var"):
            torch.testing.assert_close(s_new[k], s_ref[k], rtol=SYNC_TOL,
                                       atol=1e-6)


def test_pjit_batch_norm_is_sync():
    """The whole train step over a batch split over 8 data ranks equals
    the one-rank step (loss, BN state) and the reference's step over its
    8-device-sharded batch."""
    jp, js, p, s = _carried(4)
    x, y = _data(n=32, seed=4)
    runs = {}
    for dp in (1, 8):
        step, _ = resnet_train_step(CFG, mesh=_mesh(dp))
        runs[dp] = step(p, s, SGD(0.1, momentum=0.9).init(p), x, y)
    np.testing.assert_allclose(runs[8][3].item(), runs[1][3].item(),
                               rtol=SYNC_TOL, atol=1e-6)
    for k in ("mean", "var"):
        torch.testing.assert_close(runs[8][1]["stem"][k],
                                   runs[1][1]["stem"][k], rtol=SYNC_TOL,
                                   atol=1e-6)
    _assert_trees(params_to_jax(runs[8][0], runs[8][1]),
                  params_to_jax(runs[1][0], runs[1][1]), SYNC_TOL)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    jstep, _ = jr.resnet_train_step(JCFG)
    jo = optax.sgd(0.1, momentum=0.9).init(jp)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    shard = NamedSharding(mesh, P("data"))
    _, js8, _, jl8 = jstep(jp, js, jo, jax.device_put(jnp.asarray(x), shard),
                           jax.device_put(jnp.asarray(y), shard))
    np.testing.assert_allclose(runs[8][3].item(), float(jl8), rtol=ATOL)
    _assert_trees(params_to_jax(runs[8][0], runs[8][1])[1], js8, ATOL)


def test_run_steps_is_the_stepwise_loop():
    step, init = resnet_train_step(CFG, device="cpu")
    params, state, opt_state = init(rng.key_for(5))
    x, y = _data(8, 8, seed=5)
    run = resnet_run_steps(CFG, device="cpu")
    rp, rs_, _, losses = run(params, state, opt_state, x, y, 3)
    for i in range(3):
        params, state, opt_state, loss = step(params, state, opt_state, x, y)
        assert loss.item() == losses[i].item()
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(rp),
                                                 jax.tree.leaves(params)))


def test_mixed_bf16_forward_is_the_references():
    """MIXED_BF16: bf16 convs, f32 BN statistics and head; the logits f32
    and within BF16_RTOL of the reference's under its MIXED_BF16."""
    jp, js, p, s = _carried(6)
    x, _ = _data(8, 8, seed=7)
    with jdtypes.policy(jdtypes.MIXED_BF16):
        jl, _ = jr.resnet_apply(JCFG, True)(jp, js, jnp.asarray(x))
    with dtypes.policy(dtypes.MIXED_BF16):
        logits, ns = resnet_apply(CFG, True)(p, s, torch.from_numpy(x))
    assert logits.dtype == torch.float32
    assert ns["stem"]["mean"].dtype == torch.float32
    jl = np.asarray(jl, np.float32)
    assert (np.linalg.norm(logits.detach().numpy() - jl)
            <= BF16_RTOL * np.linalg.norm(jl))


def test_projection_skips_only_on_channel_change():
    params, _ = init_resnet(rng.key_for(2), CFG, device="cpu")
    assert "proj" not in params["stages"][0][0]
    assert "proj" in params["stages"][1][0]
    assert params["stages"][1][0]["proj"].shape == (16, 8, 1, 1)  # OIHW


@pytest.mark.slow
def test_cifar_accuracy_acceptance():
    """The reference's acceptance on the port: ResNet on the synthetic
    CIFAR task, 70 steps of SGD 0.05 momentum 0.9 at batch 256, held-out
    accuracy in eval mode at least 0.85."""
    from deeplearning4j_tpu_torch.models.alexnet import synthetic_cifar

    ds = synthetic_cifar(n=1536, seed=7)
    x = ds.features.reshape(-1, 32, 32, 3)
    y = ds.labels
    cfg = ResNetConfig(num_classes=10, blocks_per_stage=1,
                       stage_channels=(8, 16, 32))
    step, init = resnet_train_step(cfg, SGD(0.05, momentum=0.9),
                                   device="cpu")
    params, state, opt_state = init(rng.key_for(5))
    rs = np.random.default_rng(5)
    for _ in range(70):
        idx = rs.integers(0, 1024, 256)
        params, state, opt_state, loss = step(params, state, opt_state,
                                              x[idx], y[idx])
    assert np.isfinite(loss.item())
    logits, _ = resnet_apply(cfg, train=False)(params, state,
                                               torch.from_numpy(x[1024:]))
    acc = (logits.argmax(-1).numpy() == y[1024:].argmax(-1)).mean()
    assert acc >= 0.85, f"held-out accuracy {acc:.3f} below the 0.85 gate"
