"""The driver's multi-device dryrun (``__graft_entry__.py``
``dryrun_multichip``), modes 1-5 and 8, run through the port on
``["cpu"] * 8``: per-step gradient averaging, local SGD, the Megatron
block on a (4, 2) mesh, ring attention, the pipeline's train step and
ResNet with sync-BN over the data axis. Each mode's result is finite, as
the dryrun asserts, and the modes with a plain counterpart are held to it
(``ATOL``, the dryrun's TP bar; ring attention at the reference's
``tests/test_sequence_parallel.py`` bar)."""

import numpy as np
import torch

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.models.lenet import build_lenet, lenet_loss
from deeplearning4j_tpu_torch.models.resnet import (
    ResNetConfig,
    resnet_train_step,
)
from deeplearning4j_tpu_torch.ops.attention import attention
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    SGD,
    DataParallelTrainer,
    local_sgd_step,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    data_parallel_mesh,
    dp_mp_mesh,
)
from deeplearning4j_tpu_torch.parallel.pipeline_parallel import (
    pipeline_mesh,
    pipeline_train_step,
    split_microbatches,
    stack_stage_params,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    ring_attention,
)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    shard_dense_params,
    tp_mlp_block,
)

torch.set_num_threads(1)

N = 8
ATOL = 1e-4


def _finite(t) -> bool:
    return bool(torch.isfinite(torch.as_tensor(t)).all())


def test_dryrun_modes_through_the_port():
    devices = ["cpu"] * N
    mesh = data_parallel_mesh(devices=devices)
    net, params = build_lenet(seed=0, device="cpu")
    loss = lenet_loss(net)
    rs = np.random.default_rng(0)
    batch = 2 * N
    x = torch.from_numpy(rs.normal(size=(batch, 784)).astype(np.float32))
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rs.integers(0, 10, batch)])

    # mode 1: per-step gradient averaging
    trainer = DataParallelTrainer(loss, mesh=mesh)
    state, l1 = trainer.step(trainer.init(params),
                             *trainer.shard_batch(x, y), rng.key_for(0))
    assert _finite(l1), "DP step produced non-finite loss"

    # mode 2: local SGD with parameter averaging
    _, l2 = local_sgd_step(loss, mesh, local_steps=2, lr=0.05)(
        params, x, y, rng.key_for(1))
    assert _finite(l2), "local-SGD step produced non-finite loss"

    # mode 3: the Megatron block on a (dp, mp) mesh
    mesh2 = dp_mp_mesh(N // 2, 2, devices)
    rs2 = np.random.default_rng(1)
    w1 = rs2.normal(size=(8, 8)).astype(np.float32)
    w2 = rs2.normal(size=(8, 8)).astype(np.float32)
    b1, b2 = np.zeros(8, np.float32), np.zeros(8, np.float32)
    xt = rs2.normal(size=(4, 8)).astype(np.float32)
    y_tp = tp_mlp_block(mesh2)(torch.from_numpy(xt), *shard_dense_params(
        mesh2, w1, b1, w2, b2))
    y_ref = np.tanh(xt @ w1 + b1) @ w2 + b2
    assert np.abs(y_tp.numpy() - y_ref).max() < ATOL, "TP block mismatch"

    # mode 4: ring attention over the data axis
    q, k, v = (rng.normal(kk, (2, 4 * N, 2, 8), device="cpu")
               for kk in rng.split(rng.key_for(2), 3))
    out = ring_attention(mesh)(q, k, v)
    assert _finite(out), "ring attention non-finite"
    assert (out - attention(q, k, v)).abs().max().item() < ATOL

    # mode 5: the pipeline's train step (forward and backward pipeline)
    rs3 = np.random.default_rng(3)
    stages = [{"w": torch.from_numpy(rs3.normal(size=(8, 8)).astype(
        np.float32) * 0.3), "b": torch.zeros(8)} for _ in range(N)]
    head = {"w": torch.zeros((8, 3)), "b": torch.zeros(3)}

    def head_loss(hp, h, yy):
        logits = h @ hp["w"] + hp["b"]
        return -(yy * torch.log_softmax(logits, dim=-1)).sum(-1).mean()

    pstep, popt_init, place = pipeline_train_step(
        pipeline_mesh(N, devices), lambda p, h: torch.tanh(h @ p["w"]
                                                           + p["b"]),
        head_loss)
    pparams = place((stack_stage_params(stages), head))
    xp = split_microbatches(torch.from_numpy(rs3.normal(
        size=(4 * N, 8)).astype(np.float32)), 2 * N)
    yp = split_microbatches(torch.from_numpy(np.eye(3, dtype=np.float32)[
        rs3.integers(0, 3, 4 * N)]), 2 * N)
    _, _, pl = pstep(pparams, popt_init(pparams), xp, yp)
    assert _finite(pl), "pipeline step produced non-finite loss"

    # mode 8: ResNet with BatchNorm over the dp-split batch (sync-BN)
    rcfg = ResNetConfig(num_classes=4, blocks_per_stage=1,
                        stage_channels=(8, 16))
    rstep, rinit = resnet_train_step(rcfg, SGD(0.1, momentum=0.9),
                                     mesh=mesh)
    rparams, rstate, ropt = rinit(rng.key_for(9))
    rs9 = np.random.default_rng(9)
    rx = rs9.normal(size=(2 * N, 8, 8, 3)).astype(np.float32)
    ry = np.eye(4, dtype=np.float32)[rs9.integers(0, 4, 2 * N)]
    *_, rl = rstep(rparams, rstate, ropt, rx, ry)
    assert _finite(rl), "sync-BN ResNet dp step loss non-finite"
