"""``train --tp N --n-experts N --fsdp`` on the CPU (every rank on the
host with ``--device cpu``), its checkpoint restored by both packages, and
the reference's flag checks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.parallel import checkpoint as jckpt
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODEL = ["--d-model", "32", "--n-layers", "1", "--n-heads", "2",
         "--seq-len", "32"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --tp 2 --n-experts 2 --fsdp --device cpu`` with a
    checkpoint, in a fresh process as a user runs it."""
    ck = tmp_path_factory.mktemp("mesh") / "ck"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
         "--model", "transformer", "--tp", "2", "--n-experts", "2",
         "--fsdp", "--device", "cpu", "--steps", "4", "--batch", "4",
         "--checkpoint-dir", str(ck), "--save-every", "2", *MODEL],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return ck, out.stdout


def test_train_on_the_mesh_writes_checkpoints(trained):
    ck, stdout = trained
    assert "training on a (data, model) = (1, 2) mesh with fsdp, 2 experts" \
        in stdout
    assert "final loss" in stdout and "sample:" in stdout
    assert sorted(p.name for p in ck.glob("ckpt_*.npz")) == [
        "ckpt_2.npz", "ckpt_4.npz"]


def test_mesh_checkpoint_restores_in_the_reference(trained):
    """Whole leaves under the reference's keys (``blocks//moe//.wg``
    ...): its ``restore`` fills an ``init_transformer`` template of the
    config in the meta."""
    ck, _ = trained
    with np.load(ck / "ckpt_4.npz") as z:
        meta = json.loads(str(z["__manifest__"]))["meta"]
        keys = set(z.files)
    assert {"blocks//moe//.wg", "blocks//moe//.w1"} <= keys
    jcfg = jt.TransformerConfig.from_json(meta["config"])
    assert jcfg.n_experts == 2 and meta["step"] == 4
    like = jt.init_transformer(jax.random.key(0), jcfg)
    params, jmeta = jckpt.restore(ck / "ckpt_4.npz", like)
    assert jmeta["step"] == 4
    mine, _ = ckpt.restore(ck / "ckpt_4.npz", pt.param_shapes(
        pt.TransformerConfig.from_json(meta["config"])), device="cpu")
    np.testing.assert_array_equal(np.asarray(params["blocks"]["moe"].w2),
                                  mine["blocks"]["moe"]["w2"].numpy())


def test_generate_from_the_mesh_checkpoint(trained, capsys):
    ck, _ = trained
    assert cli.main(["generate", "--checkpoint-dir", str(ck), "--device",
                     "cpu", "--temperature", "0", "--max-new", "6"]) == 0
    out = capsys.readouterr().out
    assert "restored step 4" in out and "sample:" in out
    assert cli.main(["generate", "--checkpoint-dir", str(ck), "--device",
                     "cpu", "--beam", "2", "--max-new", "4"]) == 0
    assert "beam 1 (logp" in capsys.readouterr().out


def test_reference_mesh_checkpoint_restores_in_the_port(devices, tmp_path,
                                                        capsys):
    """The reverse: a checkpoint of the reference's mesh-trained MoE model
    (its train step on (4, 2), params gathered by ``np.asarray``) restores
    in the port and generates."""
    jcfg = jt.TransformerConfig(vocab_size=256, d_model=32, n_heads=2,
                                n_layers=1, d_ff=128, max_len=33,
                                n_experts=2)
    step, init_state, shard = jt.transformer_train_step(
        jmesh.dp_mp_mesh(4, 2), jcfg, fsdp=True)
    params, opt = init_state(jax.random.key(1))
    toks = np.random.default_rng(0).integers(0, 256, (4, 33)).astype(
        np.int32)
    params, opt, _ = step(params, opt, shard(toks))
    mgr = jckpt.CheckpointManager(tmp_path)
    mgr.maybe_save(1, params, {"config": jcfg.to_json()})
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    mine, meta = ckpt.CheckpointManager(tmp_path).restore_latest(
        pt.param_shapes(tcfg), device="cpu")
    assert meta["step"] == 1
    np.testing.assert_array_equal(mine["blocks"]["moe"]["wg"].numpy(),
                                  np.asarray(params["blocks"]["moe"].wg))
    assert cli.main(["generate", "--checkpoint-dir", str(tmp_path),
                     "--device", "cpu", "--temperature", "0",
                     "--max-new", "4"]) == 0
    assert "restored step 1" in capsys.readouterr().out


@pytest.mark.parametrize("flags,msg", [
    (["--tp", "3"], "--n-heads (2) must be divisible by --tp (3)"),
    (["--tp", "2", "--n-experts", "3"], "must equal --tp (2)"),
    (["--coordinator", "localhost:1"],
     "--coordinator needs --num-processes and --process-id"),
    (["--checkpoint-dir", "ck", "--coordinator", "localhost:1",
      "--num-processes", "2", "--process-id", "0"],
     "use --checkpoint-backend orbax for distributed runs"),
])
def test_train_flag_checks_exit_2(flags, msg, capsys):
    args = ["train", "--model", "transformer", "--device", "cpu",
            "--steps", "1", *MODEL, *flags]
    assert cli.main(args) == 2
    assert msg in capsys.readouterr().err


def test_train_tp_without_a_card_exits_2(monkeypatch, capsys):
    """Without ``--device``, ``train --tp 2`` lays a (cards // 2, 2) mesh
    over the first cards: none here, so it exits 2 with the mesh's
    message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["train", "--model", "transformer", "--tp", "2",
                     "--steps", "1", *MODEL]) == 2
    assert "need 2 devices for a (1, 2) mesh, have 0" in (
        capsys.readouterr().err)
