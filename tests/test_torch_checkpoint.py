"""The port's npz checkpoints against the reference's
(``deeplearning4j_tpu/parallel/checkpoint.py``): each package restores
what the other saved, bitwise, and the manager keeps the reference's
retention."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.parallel import checkpoint as jckpt
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# f32 logits of the two frameworks' forwards on the same weights
LOGIT_ATOL = 1e-4

JCFG = jt.TransformerConfig(vocab_size=96, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_len=32, n_kv_heads=2,
                            rope=True)
TCFG = pt.TransformerConfig.from_json(JCFG.to_json())


def _flat(tree):
    return dict(ckpt.flat_leaves(tree))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jparams = jt.init_transformer(jax.random.key(0), JCFG)
    path = jckpt.save(tmp_path / "ref.npz", jparams,
                      {"config": JCFG.to_json(), "step": 7})
    for like in (pt.param_shapes(TCFG),
                 pt.init_params(TCFG, seed=1, device="cpu")):
        params, meta = ckpt.restore(path, like, device="cpu")
        assert meta["step"] == 7
        assert pt.TransformerConfig.from_json(meta["config"]) == TCFG
        ref = {"//".join(str(k.key) for k in p): np.asarray(leaf)
               for p, leaf in jax.tree_util.tree_flatten_with_path(
                   jparams)[0]}
        got = _flat(params)
        assert got.keys() == ref.keys()
        for key, leaf in got.items():
            assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
            np.testing.assert_array_equal(leaf.numpy(), ref[key])
    toks = np.random.default_rng(0).integers(0, 96, (2, 12)).astype(np.int32)
    jl, _ = jt.transformer_apply(JCFG)(jparams, jnp.asarray(toks))
    tl, _ = pt.transformer_apply(TCFG)(params, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=LOGIT_ATOL, rtol=0)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params = pt.init_params(TCFG, seed=3, device="cpu")
    mgr = ckpt.CheckpointManager(tmp_path / "run", save_every=2)
    assert mgr.maybe_save(1, params) is None
    path = mgr.maybe_save(2, params, {"loss": 1.5,
                                      "config": TCFG.to_json()})
    like = jax.tree.map(jnp.zeros_like,
                        jt.init_transformer(jax.random.key(0), JCFG))
    restored, meta = jckpt.restore(path, like)
    assert meta == {"loss": 1.5, "config": TCFG.to_json(), "step": 2}
    want = _flat(params)
    for p, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        key = "//".join(str(k.key) for k in p)
        np.testing.assert_array_equal(np.asarray(leaf), want[key].numpy())
    assert jckpt.CheckpointManager(tmp_path / "run").read_meta() == meta
    assert jt.TransformerConfig.from_json(meta["config"]) == JCFG
    with np.load(path) as z:
        manifest = json.loads(str(z["__manifest__"]))
        assert manifest["format"] == "dl4j-tpu-ckpt-v1"
        assert manifest["keys"] == sorted(want) == sorted(
            k for k in z.files if k != "__manifest__")
        assert "'blocks': {" in manifest["treedef"]


def test_int8_leaves_roundtrip(tmp_path):
    params = pt.quantize_decode_params(
        pt.init_params(TCFG, seed=4, device="cpu"), TCFG)
    path = ckpt.save(tmp_path / "q.npz", params)
    back, meta = ckpt.restore(path, params, device="cpu")
    assert meta == {}
    for key, leaf in _flat(params).items():
        assert torch.equal(_flat(back)[key], leaf), key
    assert _flat(back)["blocks//wkv"].dtype == torch.int8


def test_manager_retention_and_latest(tmp_path):
    """The reference's own manager test (tests/test_parallel.py) on the
    port's manager."""
    params = pt.init_params(TCFG, seed=0, device="cpu")
    mgr = ckpt.CheckpointManager(tmp_path / "ckpts", keep=2, save_every=2)
    assert mgr.latest_step() is None and mgr.read_meta() is None
    assert mgr.restore_latest(params, device="cpu") is None
    for step in range(1, 9):
        mgr.maybe_save(step, params, {"step": step})
    assert mgr.latest_step() == 8
    assert sorted(p.name for p in (tmp_path / "ckpts").glob("ckpt_*.npz")) \
        == ["ckpt_6.npz", "ckpt_8.npz"]
    restored, meta = mgr.restore_latest(params, device="cpu")
    assert meta["step"] == 8
    assert torch.equal(restored["head"], params["head"])
    assert mgr.read_meta() == {"step": 8}


def test_restore_checks_keys_and_shapes_and_leaves_no_temp(tmp_path):
    params = pt.init_params(TCFG, seed=0, device="cpu")
    path = ckpt.save(tmp_path / "m.npz", params)
    like = pt.param_shapes(TCFG)
    like["blocks"]["extra"] = (2, 3)
    with pytest.raises(KeyError, match="blocks//extra"):
        ckpt.restore(path, like, device="cpu")
    like = pt.param_shapes(TCFG)
    like["head"] = (32, 95)
    with pytest.raises(ValueError, match="shape mismatch for 'head'"):
        ckpt.restore(path, like, device="cpu")
    bad = dict(params, head=params["head"].bfloat16())
    with pytest.raises(TypeError, match="'head'"):
        ckpt.save(tmp_path / "bad.npz", bad)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.npz"]
