"""The port's sharded checkpoints (``AsyncShardedCheckpointManager`` on
``torch.distributed.checkpoint``) and ``hybrid_mesh``, held to the
reference's cases (``tests/test_checkpoint_orbax.py``): the round trip on
a (4, 2) layout, retention and the newest step, the ``save_every``
cadence, and the hybrid mesh's single-slice collapse and checks; then
``train --checkpoint-backend orbax`` into ``generate``, and the npz
backend refused in a multi-process run. Restores are bitwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.parallel import mesh as pmesh
from deeplearning4j_tpu_torch.parallel.checkpoint import (
    AsyncShardedCheckpointManager,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# the reference tests' CFG
CFG = pt.TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=2,
                           d_ff=32, max_len=16)


def _placed(seed, fsdp=False, dp=4, tp=2):
    """The reference's init (``init_transformer(key(seed))``) through
    ``params_from_jax``, laid out on a (dp, tp) mesh of the CPU."""
    jcfg = jt.TransformerConfig.from_json(CFG.to_json())
    params = pt.params_from_jax(
        jax.tree.map(np.asarray, jt.init_transformer(jax.random.key(seed),
                                                     jcfg)),
        CFG, device="cpu")
    mesh = pmesh.dp_mp_mesh(dp, tp, ["cpu"] * (dp * tp))
    return pt.place_transformer_params(mesh, params, CFG, fsdp=fsdp)


def _same(a, b) -> bool:
    la, lb = dict(pt._leaves(a)), dict(pt._leaves(b))
    return la.keys() == lb.keys() and all(
        la[k].spec == lb[k].spec and la[k].mesh is lb[k].mesh
        and all(torch.equal(x, y) for x, y in zip(la[k].flat(),
                                                  lb[k].flat()))
        for k in la)


@pytest.mark.parametrize("fsdp", [False, True], ids=["megatron", "fsdp"])
def test_async_sharded_save_restore_roundtrip(tmp_path, fsdp):
    params = _placed(0, fsdp)
    mgr = AsyncShardedCheckpointManager(tmp_path / "ckpt", keep=3)
    assert mgr.maybe_save(1, params, meta={"loss": 1.5})
    mgr.wait()
    restored, meta = mgr.restore_latest(params)
    assert meta["step"] == 1 and meta["loss"] == 1.5
    assert _same(params, restored)  # bitwise, laid out back onto the mesh
    # the same values on another layout (the elastic restore), and whole
    other = _placed(7, dp=1, tp=2)
    moved, _ = mgr.restore_latest(other)
    for path, leaf in pt._leaves(moved):
        assert leaf.mesh is next(iter(pt._leaves(other)))[1].mesh
        assert torch.equal(leaf.whole(), dict(pt._leaves(params))[path]
                           .whole())
    whole, _ = mgr.restore_latest(pt.param_shapes(CFG), device="cpu")
    for path, leaf in pt._leaves(whole):
        assert torch.equal(leaf, dict(pt._leaves(params))[path].whole())
    mgr.close()


def test_retention_and_latest(tmp_path):
    params = _placed(1)
    mgr = AsyncShardedCheckpointManager(tmp_path / "ckpt", keep=2)
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, params)
    mgr.wait()
    assert mgr.latest_step() == 4
    assert mgr.read_meta() == {"step": 4}
    steps = sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()
                   if p.name.isdigit())
    assert steps == [3, 4]
    mgr.close()


def test_save_every_cadence(tmp_path):
    params = _placed(2)
    mgr = AsyncShardedCheckpointManager(tmp_path / "ckpt", keep=5,
                                        save_every=2)
    results = [mgr.maybe_save(s, params) for s in (0, 1, 2, 3, 4)]
    mgr.close()  # close waits too
    assert results == [True, False, True, False, True]
    assert mgr.latest_step() == 4


def test_hybrid_mesh_single_slice_collapse(devices):
    mesh = pmesh.hybrid_mesh({"data": 2, "model": 2}, dcn={"data": 2},
                             devices=["cpu"] * 8)
    ref = jmesh.hybrid_mesh({"data": 2, "model": 2}, dcn={"data": 2})
    assert mesh.axis_names == tuple(ref.axis_names) == ("data", "model")
    assert mesh.shape == dict(ref.shape) == {"data": 4, "model": 2}
    assert mesh.num_processes == 1


def test_hybrid_mesh_validates_device_count(devices, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 16 devices"):
        pmesh.hybrid_mesh({"data": 8, "model": 2})
    with pytest.raises(ValueError, match="need 16 devices"):
        jmesh.hybrid_mesh({"data": 8, "model": 2})
    with pytest.raises(ValueError, match="need 4 devices"):
        pmesh.hybrid_mesh({"data": 2, "model": 2}, devices=["cpu"] * 3)


def test_hybrid_mesh_rejects_unknown_dcn_axis():
    with pytest.raises(ValueError, match="not present in ici axes"):
        pmesh.hybrid_mesh({"data": 4}, dcn={"daat": 2}, devices=["cpu"] * 8)


MODEL = ["--d-model", "32", "--n-layers", "1", "--n-heads", "2",
         "--seq-len", "32"]


def test_train_then_generate_through_orbax(tmp_path, capsys):
    """``train --tp 2 --checkpoint-backend orbax`` writes sharded step
    directories; ``generate`` and the manager restore them; the restored
    params are the npz run's bitwise (the same training run)."""
    ck, npz = tmp_path / "ck", tmp_path / "npz"
    common = ["train", "--model", "transformer", "--device", "cpu",
              "--steps", "4", "--batch", "4", "--tp", "2", "--save-every",
              "2", *MODEL]
    assert cli.main([*common, "--checkpoint-dir", str(ck),
                     "--checkpoint-backend", "orbax"]) == 0
    assert cli.main([*common, "--checkpoint-dir", str(npz)]) == 0
    assert sorted(p.name for p in ck.iterdir()) == ["2", "4"]
    capsys.readouterr()
    assert cli.main(["generate", "--checkpoint-dir", str(ck),
                     "--checkpoint-backend", "orbax", "--device", "cpu",
                     "--temperature", "0"]) == 0
    out = capsys.readouterr().out
    assert f"restored step 4 from {ck}" in out and "sample:" in out
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        CheckpointManager,
    )

    cfg = pt.TransformerConfig.from_json(
        AsyncShardedCheckpointManager(ck).read_meta()["config"])
    shapes = pt.param_shapes(cfg)
    got, meta = AsyncShardedCheckpointManager(ck).restore_latest(
        shapes, device="cpu")
    want, _ = CheckpointManager(npz).restore_latest(shapes, device="cpu")
    assert meta["step"] == 4
    for path, leaf in pt._leaves(got):
        assert torch.equal(leaf, dict(pt._leaves(want))[path]), path


def test_npz_refused_in_a_multi_process_run(tmp_path, capsys):
    """The reference refuses npz checkpoints in a multi-process run; the
    port refuses them before the processes meet (no rendezvous, no
    directory)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
         "--model", "transformer", "--device", "cpu", "--steps", "1",
         *MODEL, "--coordinator", "127.0.0.1:9", "--num-processes", "2",
         "--process-id", "1", "--checkpoint-dir", str(tmp_path / "ck")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert ("npz checkpoints cannot address multi-process shardings; use "
            "--checkpoint-backend orbax for distributed runs") in out.stderr
    assert not (tmp_path / "ck").exists()
