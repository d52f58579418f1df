"""Tensor parallelism, remat and the mixed-precision policy in the port,
held against the JAX package's on the CPU: the reference's
``tests/test_tp_mixed_precision.py`` cases but the slow driver dryrun
(``tests/test_torch_graft_modes.py`` runs its modes through the port).

Tolerances: ``TP_ATOL`` for the Megatron block against the dense block
(the reference's bar; the partial products are summed in another order)
and ``ATOL`` against the reference's block; ``LOSS_RTOL`` for f32 losses
after a few steps against the reference's trainer."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.parallel import DataParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel import data_parallel_mesh as jdp_mesh
from deeplearning4j_tpu.parallel.mesh import dp_mp_mesh as jdp_mp_mesh
from deeplearning4j_tpu.parallel.tensor_parallel import (
    shard_dense_params as jshard,
)
from deeplearning4j_tpu.parallel.tensor_parallel import tp_mlp_block as jblock
from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.models import lenet, transformer
from deeplearning4j_tpu_torch.models.multilayer import (
    MultiLayerNetwork,
    params_from_jax,
)
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tp
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    SGD,
    DataParallelTrainer,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    Shards,
    data_parallel_mesh,
    dp_mp_mesh,
)

torch.set_num_threads(1)

TP_ATOL = 1e-4
ATOL = 1e-5
LOSS_RTOL = 1e-4


def test_tp_mlp_block_matches_dense():
    """On a (4, 2) mesh of ``["cpu"] * 8``: the column -> tanh -> row
    block against the dense block (TP_ATOL) and the reference's (ATOL);
    the column and row halves split as Shards over the mesh's model
    axis."""
    mesh = dp_mp_mesh(4, 2, ["cpu"] * 8)
    rs = np.random.default_rng(0)
    d_in, hidden, d_out = 6, 8, 5
    w1, b1, w2, b2 = (rs.normal(size=s).astype(np.float32) for s in (
        (d_in, hidden), (hidden,), (hidden, d_out), (d_out,)))
    x = rs.normal(size=(3, d_in)).astype(np.float32)
    block = tp.tp_mlp_block(mesh)
    placed = tp.shard_dense_params(mesh, w1, b1, w2, b2)
    assert [type(p) for p in placed[:3]] == [Shards] * 3
    assert [tuple(p.shape) for p in placed[0]] == [(d_in, 4)] * 2
    y = block(torch.from_numpy(x), *placed)
    ref = np.tanh(x @ w1 + b1) @ w2 + b2
    assert np.abs(y.numpy() - ref).max() < TP_ATOL
    jmesh = jdp_mp_mesh(4, 2)
    jy = jblock(jmesh)(jnp.asarray(x), *jshard(jmesh, *(jnp.asarray(a) for a
                                                        in (w1, b1, w2, b2))))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    assert tp.serving_tp_shardings is transformer.serving_tp_shardings


def test_tp_mlp_block_sums_in_rank_order():
    """``Mesh.psum`` adds the partial products rank by rank: the block
    over tp 4 equals that sum of the four ranks' products bit for bit."""
    mesh = dp_mp_mesh(1, 4, ["cpu"] * 4)
    rs = np.random.default_rng(1)
    w1, b1, w2, b2 = (torch.from_numpy(rs.normal(size=s).astype(np.float32))
                      for s in ((5, 16), (16,), (16, 7), (7,)))
    x = torch.from_numpy(rs.normal(size=(4, 5)).astype(np.float32))
    row = mesh.model_row(0)
    y = tp.tp_mlp_block(row, torch.relu)(x, *tp.shard_dense_params(
        row, w1, b1, w2, b2))
    parts = [torch.relu(x @ a + b) @ c for a, b, c in zip(
        w1.chunk(4, 1), b1.chunk(4), w2.chunk(4, 0))]
    assert torch.equal(y, ((parts[0] + parts[1]) + parts[2]) + parts[3] + b2)
    assert row.psums == 1


def _mlp(cmod, activation="tanh"):
    return cmod.list_builder(cmod.LayerConfig(activation=activation),
                             sizes=[16], n_in=8, n_out=3, pretrain=False,
                             backward=True)


def test_remat_trainer_matches_plain():
    """The reference's case on 8 ranks: remat's losses are plain's
    (bitwise here: the recomputed forward is the same arithmetic), and the
    reference's remat trainer's within LOSS_RTOL."""
    jnet = JNet(_mlp(JC), seed=0)
    jparams = jnet.init()
    net = MultiLayerNetwork(_mlp(C), device="cpu")
    params = params_from_jax([{k: np.asarray(v) for k, v in layer.items()}
                              for layer in jparams], net.conf, device="cpu")
    rs = np.random.default_rng(1)
    x = rs.normal(size=(64, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.integers(0, 3, 64)]
    runs = {}
    for remat in (False, True):
        trainer = DataParallelTrainer(
            lambda p, xx, yy, key=None: net.supervised_score_fn(p, xx, yy),
            mesh=data_parallel_mesh(devices=["cpu"] * 8), optimizer=SGD(0.1),
            remat=remat)
        state, runs[remat] = trainer.init(params), []
        for i in range(3):
            state, value = trainer.step(state, *trainer.shard_batch(x, y),
                                        rng.key_for(i))
            runs[remat].append(value.item())
    jtrainer = JTrainer(lambda p, xx, yy, key=None: jnet.supervised_score_fn(
        p, xx, yy), mesh=jdp_mesh(8), optimizer=optax.sgd(0.1), remat=True)
    jstate, ref = jtrainer.init(jparams), []
    for i in range(3):
        jstate, jl = jtrainer.step(jstate, *jtrainer.shard_batch(
            jnp.asarray(x), jnp.asarray(y)), jax.random.key(i))
        ref.append(float(jl))
    assert runs[True] == runs[False]
    np.testing.assert_allclose(runs[True], ref, rtol=LOSS_RTOL)


def test_mixed_bf16_policy_forward():
    with dtypes.policy(dtypes.MIXED_BF16):
        net, params = lenet.build_lenet(seed=0, device="cpu")
        # params stay f32; compute casts to bf16
        assert params[0]["convweights"].dtype == torch.float32
        out = net.feed_forward_fn(params, torch.zeros((4, 784)))[-1]
    assert out.dtype in (torch.bfloat16, torch.float32)
    assert torch.isfinite(out.float()).all()


def test_mixed_bf16_loss_runs_in_accum_dtype():
    """Under MIXED_BF16 the score is f32, and 60 steps over 8 data ranks
    (run_steps) halve the loss."""
    with dtypes.policy(dtypes.MIXED_BF16):
        net = MultiLayerNetwork(_mlp(C, "relu"), device="cpu")
        params = net.init()
        rs = np.random.default_rng(0)
        x = torch.from_numpy(rs.normal(size=(16, 8)).astype(np.float32))
        y = torch.from_numpy(np.eye(3, dtype=np.float32)[
            rs.integers(0, 3, 16)])
        assert net.supervised_score_fn(params, x, y).dtype == torch.float32
        trainer = DataParallelTrainer(
            lambda p, xx, yy, key=None: net.supervised_score_fn(p, xx, yy),
            mesh=data_parallel_mesh(devices=["cpu"] * 8))
        _, losses = trainer.run_steps(trainer.init(params), x, y,
                                      rng.key_for(0), 60)
    assert torch.isfinite(losses).all() and losses[-1] < losses[0] * 0.5
