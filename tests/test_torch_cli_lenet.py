"""``train --model lenet`` and ``DataParallelTrainer`` of the port held
against the JAX package's on the CPU: the trainer's losses step by step
from the reference's params, its multi-step forms, its data axis split
over two ranks (with and without dropout), and the CLI's final loss,
checkpoints and refusals (``tests/test_torch_zoo.py`` holds ``--model
alexnet`` and the data axis across processes)."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.models import lenet as jlenet
from deeplearning4j_tpu.models.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import checkpoint as jckpt
from deeplearning4j_tpu.parallel.data_parallel import (
    DataParallelTrainer as JTrainer,
)
from deeplearning4j_tpu_torch import cli, rng
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.models.multilayer import (
    MultiLayerNetwork,
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.parallel import checkpoint as tckpt
from deeplearning4j_tpu_torch.parallel.data_parallel import DataParallelTrainer
from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

#: trainer losses, port vs reference, step by step (f32, sums in other
#: orders, carried through the SGD momentum)
LOSS_RTOL = 1e-4
#: the CLI's final loss, port vs reference, same flags
CLI_RTOL = 1e-3


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _batches(n_steps, b=64):
    ds = jfetchers.mnist(n=n_steps * b)
    return [(d.features, d.labels) for d in ds.batches(b)]


def test_trainer_steps_match_the_reference():
    """5 steps of the default SGD (momentum 0.9) from the reference's
    params: losses within LOSS_RTOL, step by step; the port's data axis
    over two ranks gives the one-rank run's losses."""
    jnet, jparams = jlenet.build_lenet(0)
    net, _ = lenet.build_lenet(0, device="cpu")
    params = params_from_jax(_np(jparams), net.conf, device="cpu")
    jtrainer = JTrainer(jlenet.lenet_loss(jnet))
    jstate = jtrainer.init(jparams)
    runs = {}
    for dp in (1, 2):
        trainer = DataParallelTrainer(
            lenet.lenet_loss(net), mesh=data_parallel_mesh(devices=["cpu"] * dp))
        state = trainer.init(params)
        losses = []
        for i, (x, y) in enumerate(_batches(5)):
            state, loss = trainer.step(state, *trainer.shard_batch(x, y),
                                       rng.key_for(i))
            losses.append(loss.item())
        runs[dp] = (losses, state)
    ref = []
    for i, (x, y) in enumerate(_batches(5)):
        jstate, jloss = jtrainer.step(
            jstate, *jtrainer.shard_batch(jnp.asarray(x), jnp.asarray(y)),
            jax.random.key(i))
        ref.append(float(jloss))
    np.testing.assert_allclose(runs[1][0], ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(runs[2][0], runs[1][0], rtol=1e-6)
    for got, want in zip(params_to_jax(runs[1][1].params, net.conf),
                         _np(jstate.params)):
        for k in want:
            assert (np.linalg.norm(got[k] - want[k])
                    <= LOSS_RTOL * np.linalg.norm(want[k])), k
    # params survive: the trainer updates its own copy
    assert torch.equal(params[0]["convweights"],
                       params_from_jax(_np(jparams), net.conf,
                                       device="cpu")[0]["convweights"])


def test_trainer_multi_step_forms_match_the_reference():
    """run_steps, fit_epoch and step_accumulate from the reference's
    params, keys split as the reference splits them."""
    jnet, jparams = jlenet.build_lenet(1)
    net, _ = lenet.build_lenet(1, device="cpu")
    params = params_from_jax(_np(jparams), net.conf, device="cpu")
    xs = np.stack([x for x, _ in _batches(3, 32)])
    ys = np.stack([y for _, y in _batches(3, 32)])
    jtrainer = JTrainer(jlenet.lenet_loss(jnet))
    trainer = DataParallelTrainer(lenet.lenet_loss(net),
                                  mesh=data_parallel_mesh(devices=["cpu"]))
    cases = [
        ("run_steps", (jnp.asarray(xs[0]), jnp.asarray(ys[0])),
         (torch.from_numpy(xs[0]), torch.from_numpy(ys[0])), (3,)),
        ("fit_epoch", (jnp.asarray(xs), jnp.asarray(ys)),
         (torch.from_numpy(xs), torch.from_numpy(ys)), ()),
        ("step_accumulate", (jnp.asarray(xs), jnp.asarray(ys)),
         (torch.from_numpy(xs), torch.from_numpy(ys)), ()),
    ]
    for name, jargs, targs, extra in cases:
        js, jl = getattr(jtrainer, name)(jtrainer.init(jparams), *jargs,
                                         jax.random.key(5), *extra)
        s, tl = getattr(trainer, name)(trainer.init(params), *targs,
                                       rng.key_for(5), *extra)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOSS_RTOL, err_msg=name)
        assert s.step == int(js.step), name


def test_trainer_dropout_over_two_ranks_is_the_reference():
    """LeNet with dropout on every layer (the conv blocks' masks over the
    reference's NHWC order): 5 steps over two data ranks take each rank's
    rows of the one whole-batch mask, so their losses are the one-rank
    run's and the reference trainer's (one draw over the sharded batch)."""
    jconf = jlenet.lenet_config()
    jconf = dataclasses.replace(jconf, confs=[c.replace(dropout=0.25)
                                              for c in jconf.confs])
    jnet = JNet(jconf, seed=0)
    jparams = jnet.init()
    conf = lenet.lenet_config()
    conf = dataclasses.replace(conf, confs=[c.replace(dropout=0.25)
                                            for c in conf.confs])
    net = MultiLayerNetwork(conf, device="cpu")
    params = params_from_jax(_np(jparams), conf, device="cpu")

    def loss(p, x, y, key):
        return net.supervised_score_fn(p, x, y, key=key, training=True)

    runs = {}
    for dp in (1, 2):
        trainer = DataParallelTrainer(
            loss, mesh=data_parallel_mesh(devices=["cpu"] * dp))
        state = trainer.init(params)
        runs[dp] = []
        for i, (x, y) in enumerate(_batches(5, 32)):
            state, value = trainer.step(state, *trainer.shard_batch(x, y),
                                        rng.key_for(i))
            runs[dp].append(value.item())
    jtrainer = JTrainer(lambda p, x, y, key: jnet.supervised_score_fn(
        p, x, y, key=key, training=True))
    jstate = jtrainer.init(jparams)
    ref = []
    for i, (x, y) in enumerate(_batches(5, 32)):
        jstate, jloss = jtrainer.step(
            jstate, *jtrainer.shard_batch(jnp.asarray(x), jnp.asarray(y)),
            jax.random.key(i))
        ref.append(float(jloss))
    np.testing.assert_allclose(runs[1], ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(runs[2], runs[1], rtol=1e-6)


def _final_loss(text: str) -> float:
    m = re.search(r"^final loss ([0-9.]+)$", text, re.M)
    assert m is not None, text
    return float(m.group(1))


def test_train_cli_final_loss_matches_the_reference(capsys):
    """``python -m deeplearning4j_tpu_torch train --model lenet --device
    cpu --examples 256 --batch 64`` against the reference's ``cmd_train``
    at the same flags."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
         "--model", "lenet", "--device", "cpu", "--examples", "256",
         "--batch", "64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"ms a step over steps 2-4 \(batch 64, 1 data rank",
                     out.stdout), out.stdout
    assert jcli.main(["train", "--model", "lenet", "--examples", "256",
                      "--batch", "64"]) == 0
    ref = _final_loss(capsys.readouterr().out)
    assert abs(_final_loss(out.stdout) - ref) <= CLI_RTOL * ref


def test_train_cli_lenet_checkpoints_and_status(tmp_path, capsys):
    """npz checkpoints every --save-every steps in the reference's keys and
    layout (the reference restores them into its own LeNet tree), the
    status server, 10-step loss lines."""
    ck = tmp_path / "ck"
    assert cli.main(["train", "--model", "lenet", "--device", "cpu",
                     "--examples", "640", "--batch", "32", "--checkpoint-dir",
                     str(ck), "--save-every", "10", "--status-port", "0"]) == 0
    out = capsys.readouterr().out
    assert "status REST on http://127.0.0.1:" in out
    assert re.search(r"^epoch 0 step 20 loss [0-9.]+$", out, re.M)
    final = _final_loss(out)
    assert sorted(p.name for p in ck.iterdir()) == ["ckpt_10.npz",
                                                    "ckpt_20.npz"]
    _, jparams = jlenet.build_lenet(0)
    jp, meta = jckpt.restore(ck / "ckpt_20.npz", jparams)
    assert meta["step"] == 20 and round(meta["loss"], 4) == final
    net, _ = lenet.build_lenet(0, device="cpu")
    tree, _ = tckpt.restore(ck / "ckpt_20.npz", net.checkpoint_tree(),
                            device="cpu")
    for got, want in zip(params_to_jax(net.from_checkpoint_tree(tree),
                                       net.conf), _np(jp)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("flags,named", [
    (["--model", "alexnet", "--status-port", "-1"], "--status-port"),
    (["--model", "lenet", "--coordinator", "localhost:1",
      "--num-processes", "2"], "--process-id"),
    (["--model", "lenet", "--status-port", "70000"], "--status-port"),
])
def test_train_cli_refusals(flags, named, capsys):
    assert cli.main(["train", "--device", "cpu", *flags]) == 2
    assert named in capsys.readouterr().err
