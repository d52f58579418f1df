"""The port's training path held against the reference's
``transformer_loss`` / ``lm_optimizer`` / ``transformer_train_step`` on the
CPU, with the reference's params carried over by ``params_from_jax``.

The reference's Pallas flash kernels run in interpret mode (its own CPU
default); the port's run their plain versions (CPU tensors).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.parallel.mesh import dp_mp_mesh
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import flash_attention as fa

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# f32: the frameworks sum in other orders; bf16: activations round at
# other places (XLA per op, PyTorch per fused op)
LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-2}
GRAD_REL = {"f32": 1e-4, "bf16": 5e-2}
GRAD_ABS = {"f32": 1e-6, "bf16": 0.0}
# three optimizer steps in f32: per leaf, |p - p_ref| / |p_ref| in the
# Frobenius norm. Not element by element: Adam's first steps divide each
# gradient element by its own magnitude, so an element whose gradient sits
# at rounding level moves by up to a learning rate either way, whichever
# framework sums it
PARAM_RTOL = 1e-5

_BASE = jt.TransformerConfig(
    vocab_size=96, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=33,
)
ARCHS = {
    "mha": _BASE,
    "gqa_rope": dataclasses.replace(_BASE, n_kv_heads=2, rope=True),
}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _pair(jcfg, seed=0):
    jparams = jt.init_transformer(jax.random.key(seed), jcfg)
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    # copies: the reference's train step donates its params
    np_params = jax.tree.map(np.array, jparams)
    return jparams, tcfg, pt.params_from_jax(np_params, tcfg, device="cpu")


def _tokens(b, t, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("flash", [True, False])
def test_loss_and_grads_match_reference(flash, arch, dtype):
    jcfg = dataclasses.replace(ARCHS[arch], use_flash=flash,
                               compute_dtype=_JDT[dtype])
    jparams, tcfg, tparams = _pair(jcfg)
    toks = _tokens(3, 33, jcfg.vocab_size)
    jl, jg = jax.jit(jax.value_and_grad(jt.transformer_loss(jcfg)))(
        jparams, jnp.asarray(toks))
    tl, tg = pt.value_and_grad(pt.transformer_loss(tcfg), tparams,
                               torch.from_numpy(toks).long())
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL[dtype] * abs(float(jl))
    leaves = list(pt._leaves(tg))
    assert len(leaves) == len(jax.tree.leaves(jg))
    for path, g in leaves:
        ref = _leaf(jg, path)
        assert g.dtype == torch.float32 and g.shape == ref.shape, path
        err = np.abs(g.numpy() - ref).max()
        tol = GRAD_REL[dtype] * np.abs(ref).max() + GRAD_ABS[dtype]
        assert err <= tol, (path, err, tol)


def _loss_and_grads(tcfg, tparams, toks):
    params = pt._tree((path, p.detach().clone())
                      for path, p in pt._leaves(tparams))
    return pt.value_and_grad(pt.transformer_loss(tcfg), params, toks)


@pytest.mark.parametrize("policy", ["dots_no_batch", "full"])
@pytest.mark.parametrize("flash", [True, False])
def test_remat_changes_no_bit(flash, policy):
    jcfg = dataclasses.replace(ARCHS["gqa_rope"], use_flash=flash,
                               compute_dtype=jnp.bfloat16)
    _, tcfg, tparams = _pair(jcfg)
    toks = torch.from_numpy(_tokens(2, 33, jcfg.vocab_size)).long()
    l0, g0 = _loss_and_grads(tcfg, tparams, toks)
    l1, g1 = _loss_and_grads(
        dataclasses.replace(tcfg, remat=True, remat_policy=policy), tparams,
        toks)
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(pt._leaves(g0), pt._leaves(g1)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("remat,policy,runs", [
    (False, "dots_no_batch", 1), (True, "dots_no_batch", 1),
    (True, "full", 2),
])
def test_remat_policy_keeps_the_flash_forward(monkeypatch, remat, policy,
                                              runs):
    """Under "dots_no_batch" the backward reuses the saved flash outputs
    (one forward run per layer); "full" recomputes them."""
    calls = []
    fwd = fa.flash_attention_fwd
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    jcfg = dataclasses.replace(_BASE, use_flash=True, remat=remat,
                               remat_policy=policy)
    _, tcfg, tparams = _pair(jcfg)
    toks = torch.from_numpy(_tokens(2, 33, jcfg.vocab_size)).long()
    pt.value_and_grad(pt.transformer_loss(tcfg), tparams, toks)
    assert len(calls) == runs * tcfg.n_layers


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decay_mask_matches_reference(arch):
    jparams, _, tparams = _pair(ARCHS[arch])
    ref = {tuple(k.key for k in path)
           for path, keep in jax.tree_util.tree_flatten_with_path(
               jt._decay_mask(jparams))[0] if keep}
    port = {path for path, keep in pt._leaves(pt._decay_mask(tparams))
            if keep}
    assert port == ref and "head" in {p[-1] for p in port}


@pytest.mark.parametrize("warmup,total", [(1, 3), (3, 12), (5, 40)])
def test_schedule_matches_optax(warmup, total):
    kw = dict(init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
              decay_steps=total, end_value=3e-5)
    ref = optax.warmup_cosine_decay_schedule(**kw)
    port = pt.warmup_cosine_decay_schedule(**kw)
    for count in range(total + 4):
        assert port(count) == pytest.approx(float(ref(count)), rel=1e-6,
                                            abs=1e-12), count


@pytest.mark.parametrize("which", ["lm_optimizer", "default_adamw"])
def test_three_train_steps_match_reference(which):
    jcfg = dataclasses.replace(ARCHS["gqa_rope"], use_flash=True)
    if which == "lm_optimizer":
        jopt, topt = jt.lm_optimizer(total_steps=3), pt.lm_optimizer(
            total_steps=3)
    else:
        jopt, topt = None, None
    jstep, jinit, jshard = jt.transformer_train_step(dp_mp_mesh(1, 1), jcfg,
                                                     optimizer=jopt)
    jparams, jstate = jinit(jax.random.key(0))
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    tparams = pt.params_from_jax(jax.tree.map(np.array, jparams), tcfg,
                                 device="cpu")
    tstep, _, tshard = pt.transformer_train_step(None, tcfg, optimizer=topt,
                                                 device="cpu")
    tstate = (topt or pt.AdamW(3e-4)).init(tparams)
    for i in range(3):
        toks = _tokens(2, 33, jcfg.vocab_size, seed=10 + i)
        jparams, jstate, jl = jstep(jparams, jstate, jshard(toks))
        tparams, tstate, tl = tstep(tparams, tstate, tshard(toks))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), i
    assert tstate["count"] == 3
    for path, p in pt._leaves(tparams):
        ref = _leaf(jparams, path)
        err = np.linalg.norm(p.detach().numpy() - ref)
        assert err <= PARAM_RTOL * np.linalg.norm(ref), (path, err)


def test_unported_training_modes_raise():
    cfg = pt.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                               n_layers=1, d_ff=32, max_len=16)
    # MoE and sequence parallelism train on a mesh only, as the
    # reference's; fsdp splits over a mesh's data axis
    for bad in (dataclasses.replace(cfg, n_experts=2),
                dataclasses.replace(cfg, sequence_parallel=True)):
        with pytest.raises(ValueError, match="need a mesh"):
            pt.transformer_apply(bad)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.transformer_loss(dataclasses.replace(
            cfg, use_flash=True, sequence_parallel=True),
            mesh=pt.mesh_lib.dp_mp_mesh(1, 1, ["cpu"]))
    with pytest.raises(ValueError, match="pass a mesh"):
        pt.transformer_train_step(None, cfg, fsdp=True, device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        pt.transformer_loss(dataclasses.replace(cfg, use_flash=True))(
            pt.init_params(cfg, device="cpu"),
            torch.zeros((1, 12), dtype=torch.long))


def test_train_cli_runs_on_cpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
         "--model", "transformer", "--device", "cpu", "--steps", "3",
         "--seq-len", "16", "--d-model", "32", "--n-layers", "1",
         "--n-heads", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1"],
                                  ["--status-port", "-1"],
                                  ["--checkpoint-dir", "ck",
                                   "--coordinator", "localhost:1",
                                   "--num-processes", "2",
                                   "--process-id", "1"],
                                  ["--model", "alexnet", "--coordinator",
                                   "localhost:1"]])
def test_train_cli_names_the_later_slice(flag):
    """The flags of the cluster slice run now (tests/test_torch_cli_cluster
    .py); what still exits 2 is a flag combination the reference refuses
    (a coordinator without its process count, an invalid status port, npz
    checkpoints across processes), for the model-zoo nets too (``--model
    lenet`` and ``--model alexnet`` train: tests/test_torch_cli_lenet.py,
    tests/test_torch_zoo.py)."""
    from deeplearning4j_tpu_torch import cli

    args = ["train", "--model", "transformer", "--device", "cpu", *flag]
    assert cli.main(args) == 2
