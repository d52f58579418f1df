"""Data-parallel training of the DL4J nets in the port, held against the
JAX package's on the CPU: batch statistics over the data axis (the
``zero_mean`` preprocessors over two ranks are the whole batch's, as the
reference's sharded step takes them), one data rank byte for byte the
plain step, remat's masks, local SGD and replica consensus; then the
reference's
``tests/test_parallel.py`` trainer cases on the port over ``["cpu"] * 8``;
then the data axis across two gloo processes (this file run as a script is
the worker; it imports no JAX).

Tolerances: ``LOSS_RTOL`` for f32 losses and params against the reference
(sums in other orders, carried through a few SGD steps); ``DP_RTOL`` for
the port's dp 2 against its dp 1 (the batch's statistics combined rank by
rank by Chan's update, against one reduction); ``PROC_RTOL`` for two
processes against one."""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
else:
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn import conf as JC
    from deeplearning4j_tpu.parallel import DataParallelTrainer as JTrainer
    from deeplearning4j_tpu.parallel import data_parallel_mesh as jmesh
    from deeplearning4j_tpu.parallel import local_sgd_step as jlocal_sgd
    from deeplearning4j_tpu.parallel.data_parallel import (
        replica_consensus as jconsensus,
    )

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.datasets import fetchers
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.models.multilayer import (
    MultiLayerNetwork,
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn import preprocessors as pp
from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad
from deeplearning4j_tpu_torch.parallel import lockstep
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    SGD,
    DataParallelTrainer,
    local_sgd_step,
    replica_consensus,
)
from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
from deeplearning4j_tpu_torch.utils import tree_math as tm

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
DP_RTOL = 1e-5
PROC_RTOL = 1e-6
STAT_NAMES = ["zero_mean_unit_variance", "zero_mean", "unit_variance"]


def _mesh(dp):
    return data_parallel_mesh(devices=["cpu"] * dp)


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _mlp_conf(cmod, preprocessors=None, dropout=0.0):
    """8 -> 16 -> 3, or 8 -> 16 -> 12 -> 3 with ``preprocessors`` (the
    supervised score applies a preprocessor to the input of every layer
    but the output layer)."""
    conf = cmod.list_builder(
        cmod.LayerConfig(activation="tanh", dropout=dropout),
        sizes=[16, 12] if preprocessors else [16], n_in=8, n_out=3,
        pretrain=False, backward=True)
    return dataclasses.replace(conf, preprocessors=dict(preprocessors or {}))


def _pair(preprocessors=None, dropout=0.0, training=False):
    """The reference's small MLP (seed 0) and the port's from its params:
    (jnet, jparams, jloss, net, params, loss)."""
    jnet = JNet(_mlp_conf(JC, preprocessors, dropout), seed=0)
    jparams = jnet.init()
    net = MultiLayerNetwork(_mlp_conf(C, preprocessors, dropout),
                            device="cpu")
    params = params_from_jax(_np(jparams), net.conf, device="cpu")

    def jloss(p, x, y, key=None):
        return jnet.supervised_score_fn(p, x, y, key=key, training=training)

    def loss(p, x, y, key=None):
        return net.supervised_score_fn(p, x, y, key=key, training=training)

    return jnet, jparams, jloss, net, params, loss


def _toy(n=64, d=8, k=3, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, d)).astype(np.float32) * 2.0 + 0.5
    w = rs.normal(size=(d, k))
    return x, np.eye(k, dtype=np.float32)[(x @ w).argmax(1)]


def _port_run(loss, params, dp, x, y, steps, **kw):
    trainer = DataParallelTrainer(loss, mesh=_mesh(dp), **kw)
    state = trainer.init(params)
    losses = []
    for i in range(steps):
        state, value = trainer.step(state, *trainer.shard_batch(x, y),
                                    rng.key_for(i))
        losses.append(value.item())
    return np.array(losses), state


def _ref_run(jloss, jparams, dp, x, y, steps, **kw):
    trainer = JTrainer(jloss, mesh=jmesh(dp), **kw)
    state = trainer.init(jparams)
    losses = []
    for i in range(steps):
        state, value = trainer.step(
            state, *trainer.shard_batch(jnp.asarray(x), jnp.asarray(y)),
            jax.random.key(i))
        losses.append(float(value))
    return np.array(losses), state


def _close(a, b, rtol):
    for la, lb in zip(a, b):
        for k in lb:
            assert (np.linalg.norm(la[k] - lb[k])
                    <= rtol * np.linalg.norm(lb[k])), k


# -- the repair: batch statistics over the data axis --------------------------

@pytest.mark.parametrize("name", STAT_NAMES)
def test_batch_statistics_over_two_ranks_are_the_whole_batchs(name):
    """5 trainer steps of an MLP whose hidden activations go through a
    batch-statistics preprocessor: over two data ranks the statistics are
    the whole batch's, so dp 2 gives dp 1's losses and params (DP_RTOL),
    and both give the reference trainer's over 2 devices (LOSS_RTOL)."""
    jnet, jparams, jloss, net, params, loss = _pair({1: name})
    x, y = _toy()
    ref, jstate = _ref_run(jloss, jparams, 2, x, y, 5)
    one, s1 = _port_run(loss, params, 1, x, y, 5)
    two, s2 = _port_run(loss, params, 2, x, y, 5)
    np.testing.assert_allclose(one, ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(two, one, rtol=DP_RTOL)
    _close(params_to_jax(s2.params, net.conf), params_to_jax(s1.params,
                                                             net.conf),
           DP_RTOL)
    _close(params_to_jax(s2.params, net.conf), _np(jstate.params), LOSS_RTOL)


def test_batch_moments_combine_ranks_and_carry_gradients():
    """Inside ``run_ranks`` each rank's ``batch_moments`` is the whole
    batch's (mean and population variance, and std), and the gradient of
    the ranks' summed outputs reaches every rank's rows through the
    combination: dp 4's equals one rank's over the whole batch."""
    rs = np.random.default_rng(1)
    x = torch.from_numpy(rs.normal(size=(32, 5)).astype(np.float32) * 3 + 7)
    whole = x.clone().requires_grad_(True)
    m, v = lockstep.batch_moments(whole, (0,))
    torch.testing.assert_close(m, torch.mean(x, 0, keepdim=True), rtol=0,
                               atol=0)
    torch.testing.assert_close(v, torch.var(x, 0, keepdim=True,
                                            unbiased=False), rtol=0, atol=0)
    ((whole - m) / v.sqrt()).pow(3).sum().backward()
    mesh = _mesh(4)
    parts = [p.clone().requires_grad_(True) for p in x.chunk(4)]

    def rank(r):
        mr, sr = lockstep.batch_moments(parts[r], (0,), std=True)
        return mr, sr, ((parts[r] - mr) / sr).pow(3).sum()

    outs = lockstep.run_ranks(mesh, rank, 32)
    for mr, sr, _ in outs:
        torch.testing.assert_close(mr, m, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sr, v.sqrt(), rtol=1e-6, atol=1e-6)
    sum(o[2] for o in outs).backward()
    torch.testing.assert_close(torch.cat([p.grad for p in parts]),
                               whole.grad, rtol=1e-4, atol=1e-4)


def test_one_rank_step_is_byte_identical_to_the_plain_step():
    """One data rank: the preprocessors compute what they computed before
    the data axis took statistics (``torch.std`` of the batch), and a
    trainer step is the plain value-and-grad plus the SGD update, bit for
    bit, with ``donate`` (in place) or not."""
    rs = np.random.default_rng(2)
    x = torch.from_numpy(rs.normal(size=(16, 6)).astype(np.float32))
    std = torch.std(x, dim=0, keepdim=True, unbiased=False)
    mean = torch.mean(x, dim=0, keepdim=True)
    assert torch.equal(pp.get("zero_mean_unit_variance")(x),
                       (x - mean) / (std + 1e-8))
    assert torch.equal(pp.get("zero_mean")(x), x - mean)
    assert torch.equal(pp.get("unit_variance")(x), x / (std + 1e-8))
    *_, net, params, loss = _pair({1: "zero_mean_unit_variance"})
    xb, yb = _toy(32)
    xb, yb = torch.from_numpy(xb), torch.from_numpy(yb)
    value, grads = value_and_grad(loss)(params, xb, yb, rng.key_for(0))
    opt = SGD(1e-2, momentum=0.9)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = tm.add(params, updates)
    for donate in (True, False):
        trainer = DataParallelTrainer(loss, mesh=_mesh(1), donate=donate)
        state, got = trainer.step(trainer.init(params), xb, yb,
                                  rng.key_for(0))
        assert torch.equal(got, value)
        assert all(torch.equal(a, b) for a, b in zip(tm.leaves(state.params),
                                                     tm.leaves(want)))


# -- remat --------------------------------------------------------------------

@pytest.mark.parametrize("dp", [1, 2])
def test_remat_redraws_the_same_dropout_masks(dp):
    """With dropout on every layer and a batch statistic, remat's
    recomputed forward draws the same keyed masks and takes the same
    statistics: 3 steps bitwise the plain trainer's, losses and params."""
    *_, net, params, loss = _pair({1: "zero_mean_unit_variance"},
                                  dropout=0.3, training=True)
    x, y = _toy(32, seed=3)
    plain, sp = _port_run(loss, params, dp, x, y, 3)
    remat, sr = _port_run(loss, params, dp, x, y, 3, remat=True)
    np.testing.assert_array_equal(remat, plain)
    assert all(torch.equal(a, b) for a, b in zip(tm.leaves(sr.params),
                                                 tm.leaves(sp.params)))


# -- local SGD ----------------------------------------------------------------

def test_local_sgd_matches_the_reference():
    """``local_sgd_step`` over 4 ranks, 3 local steps, twice, on the MLP
    with dropout and a batch statistic: losses and averaged params the
    reference's (every rank draws the first rows' masks and takes its
    shard's statistics, as the reference's ``shard_map`` does), and
    ``replica_consensus`` of the ranks' copies 0, as the reference's."""
    jnet, jparams, jloss, net, params, loss = _pair(
        {1: "zero_mean_unit_variance"}, dropout=0.3, training=True)
    x, y = _toy(64, seed=4)
    jstep = jlocal_sgd(jloss, jmesh(4), local_steps=3, lr=0.2)
    step = local_sgd_step(loss, _mesh(4), local_steps=3, lr=0.2)
    jp, p = jparams, params
    for i in range(2):
        jp, jl = jstep(jp, jnp.asarray(x), jnp.asarray(y), jax.random.key(i))
        p, value = step(p, torch.from_numpy(x), torch.from_numpy(y),
                        rng.key_for(i))
        np.testing.assert_allclose(value.item(), float(jl), rtol=LOSS_RTOL)
    _close(params_to_jax(p, net.conf), _np(jp), LOSS_RTOL)
    stacked = tm.tree_map(lambda *ts: torch.stack(ts), *step.replicas)
    assert replica_consensus(stacked).item() == 0.0
    jstacked = jax.tree.map(lambda a: jnp.stack([a] * 4), jp)
    assert float(jconsensus(jstacked)) == 0.0


def test_local_sgd_parameter_averaging():
    """The reference's case: 20 local-SGD rounds over 8 ranks of 4 local
    steps cut the loss below 0.7 of the first round's; without averaging
    the ranks' copies part ways."""
    *_, net, params, loss = _pair()
    x, y = _toy(256)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    step = local_sgd_step(loss, _mesh(8), local_steps=4, lr=0.2)
    first = None
    for i in range(20):
        params, value = step(params, x, y, rng.key_for(i))
        first = value.item() if first is None else first
    assert value.item() < first * 0.7
    apart = local_sgd_step(loss, _mesh(8), local_steps=4, lr=0.2,
                           average_every_step=False)
    apart(params, x, y, rng.key_for(0))
    stacked = tm.tree_map(lambda *ts: torch.stack(ts), *apart.replicas)
    assert replica_consensus(stacked).item() > 0.0


# -- the reference's trainer cases on the port --------------------------------

def test_data_parallel_trainer_reduces_loss():
    *_, net, params, loss = _pair()
    x, y = _toy(256)
    losses, _ = _port_run(loss, params, 8, x, y, 60)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_data_parallel_matches_single_device():
    """Gradient averaging over 8 ranks == one rank on the whole batch, and
    the reference's 8-device trainer."""
    jnet, jparams, jloss, net, params, loss = _pair()
    x, y = _toy(64)
    l8, s8 = _port_run(loss, params, 8, x, y, 5, optimizer=SGD(0.1))
    l1, s1 = _port_run(loss, params, 1, x, y, 5, optimizer=SGD(0.1))
    ref, _ = _ref_run(jloss, jparams, 8, x, y, 5, optimizer=optax.sgd(0.1))
    assert abs(l8[-1] - l1[-1]) < 1e-4
    for a, b in zip(tm.leaves(s8.params), tm.leaves(s1.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    np.testing.assert_allclose(l8, ref, rtol=LOSS_RTOL)


def test_run_steps_matches_stepwise_loop():
    *_, net, params, loss = _pair()
    x, y = _toy(64)
    t_scan = DataParallelTrainer(loss, mesh=_mesh(8), optimizer=SGD(0.1))
    t_step = DataParallelTrainer(loss, mesh=_mesh(8), optimizer=SGD(0.1))
    xs, ys = t_scan.shard_batch(x, y)
    root = rng.key_for(42)
    s_scan, losses = t_scan.run_steps(t_scan.init(params), xs, ys, root, 7)
    assert losses.shape == (7,)
    s_step = t_step.init(params)
    for k in rng.split(root, 7):
        s_step, _ = t_step.step(s_step, xs, ys, k)
    assert s_scan.step == s_step.step == 7
    for a, b in zip(tm.leaves(s_scan.params), tm.leaves(s_step.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_fit_epoch_over_stacked_minibatches():
    *_, net, params, loss = _pair()
    trainer = DataParallelTrainer(loss, mesh=_mesh(8))
    state = trainer.init(params)
    x, y = _toy(512)
    xs = torch.from_numpy(x).reshape(8, 64, -1)
    ys = torch.from_numpy(y).reshape(8, 64, -1)
    first = None
    for epoch in range(6):
        state, losses = trainer.fit_epoch(state, xs, ys, rng.key_for(epoch))
        first = losses[0].item() if first is None else first
    assert losses.shape == (8,)
    assert losses[-1].item() < first * 0.6, (first, losses[-1].item())


def test_lenet_trains_data_parallel():
    net, params = lenet.build_lenet(0, device="cpu")
    ds = fetchers.mnist(n=256)
    losses, _ = _port_run(lenet.lenet_loss(net), params, 8, ds.features,
                          ds.labels, 12)
    assert losses[-1] < losses[0], (losses[0], losses[-1])


def test_gradient_accumulation_matches_full_batch():
    """step_accumulate over 4 microbatches == one step on the
    concatenated batch (8 ranks, LeNet)."""
    net, params = lenet.build_lenet(0, device="cpu")
    loss = lenet.lenet_loss(net)
    ds = fetchers.mnist(n=256)
    x, y = torch.from_numpy(ds.features), torch.from_numpy(ds.labels)
    t1 = DataParallelTrainer(loss, mesh=_mesh(8), donate=False)
    s1, l_full = t1.step(t1.init(params), x, y, rng.key_for(0))
    t2 = DataParallelTrainer(loss, mesh=_mesh(8), donate=False)
    s2, l_acc = t2.step_accumulate(t2.init(params), x.reshape(4, 64, -1),
                                   y.reshape(4, 64, -1), rng.key_for(0))
    np.testing.assert_allclose(l_full.item(), l_acc.item(), rtol=1e-5)
    for a, b in zip(tm.leaves(s1.params), tm.leaves(s2.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# -- the data axis across two processes ---------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: (preprocessor, local data ranks a process) of the two-process runs
PROC_CASES = [("zero_mean_unit_variance", 1), ("unit_variance", 2)]


def _worker(port: int, pid: int) -> None:
    """Process ``pid`` of 2, for each of PROC_CASES: 5 steps of the
    batch-statistics MLP (seed 0 of the port's own init) over a data axis
    of ``dp`` local ranks a process; prints the losses and the params."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import hybrid_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=pid)
    x, y = _toy()
    for case, (name, dp) in enumerate(PROC_CASES):
        net = MultiLayerNetwork(_mlp_conf(C, {1: name}), device="cpu")
        params = net.init(rng.key_for(0))
        mesh = hybrid_mesh({"data": dp}, {"data": 2}, ["cpu"] * dp)
        trainer = DataParallelTrainer(
            lambda p, xx, yy, key=None, net=net: net.supervised_score_fn(
                p, xx, yy), mesh=mesh)
        state = trainer.init(params)
        for i in range(5):
            state, value = trainer.step(
                state, *trainer.shard_global_batch(x, y), rng.key_for(i))
            print("LOSS", case, repr(value.item()), flush=True)
        flat = torch.cat([t.reshape(-1) for t in tm.leaves(state.params)])
        print("PARAMS", case, " ".join(repr(v) for v in flat.tolist()),
              flush=True)
    dist.destroy_process_group()


def test_batch_statistics_across_two_processes():
    """Two gloo processes of ``dp`` ranks each (global data axis 2 * dp),
    for each of PROC_CASES: the processes' losses and params agree
    bitwise, and equal the one-process run over ``2 * dp`` ranks within
    PROC_RTOL and one rank's within DP_RTOL: the statistics and their
    gradients cross the processes."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(pid)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    runs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        lines = [line.split() for line in out.splitlines()]
        runs.append([(np.array([float(w[2]) for w in lines
                                if w[:2] == ["LOSS", str(c)]]),
                      np.array([float(v) for w in lines
                                if w[:2] == ["PARAMS", str(c)]
                                for v in w[2:]]))
                     for c in range(len(PROC_CASES))])
    x, y = _toy()
    for (la, pa), (lb, pb), (name, dp) in zip(*runs, PROC_CASES):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(pa, pb)
        net = MultiLayerNetwork(_mlp_conf(C, {1: name}), device="cpu")
        params = net.init(rng.key_for(0))

        def loss(p, xx, yy, key=None, net=net):
            return net.supervised_score_fn(p, xx, yy)

        for ranks, rtol in ((2 * dp, PROC_RTOL), (1, DP_RTOL)):
            losses, state = _port_run(loss, params, ranks, x, y, 5)
            flat = torch.cat([t.reshape(-1)
                              for t in tm.leaves(state.params)])
            np.testing.assert_allclose(la, losses, rtol=rtol, err_msg=name)
            np.testing.assert_allclose(pa, flat.numpy(), rtol=rtol,
                                       atol=rtol * np.abs(pa).max(),
                                       err_msg=name)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
