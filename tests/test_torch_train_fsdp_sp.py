"""FSDP and sequence parallelism in the port's mesh training, held against
the reference on the CPU (its 8 virtual devices; the port's mesh over
``["cpu"] * (dp * tp)``), and the refusals the reference makes.

- FSDP: params and AdamW state split over the data axis too; losses equal
  the reference's FSDP run and the port's replicated run; a rank holds
  less;
- sequence parallelism: ring attention over the data axis, the rolled and
  masked loss; logits against dense attention, losses against the
  reference, MoE with the sequence split (capacity from T/dp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.parallel import mesh as pmesh

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# f32 logits: the frameworks sum in other orders
TOL = 1e-4
# f32 losses over a few optimizer steps
LOSS_RTOL = 2e-3
STEPS = 3

CFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32
)


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size,
                                                (b, t)).astype(np.int32)


def _meshes(dp, tp):
    return (jmesh.dp_mp_mesh(dp, tp),
            pmesh.dp_mp_mesh(dp, tp, ["cpu"] * (dp * tp)))


def _ref_losses(jcfg, mesh, fsdp, toks, seed):
    step, init_state, shard = jt.transformer_train_step(mesh, jcfg,
                                                        fsdp=fsdp)
    params, opt = init_state(jax.random.key(seed))
    start = jax.tree.map(np.array, params)
    ts = shard(jnp.asarray(toks))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, ts)
        losses.append(float(loss))
    return start, losses


def _port_losses(tcfg, mesh, fsdp, start, toks):
    params = pt.place_transformer_params(
        mesh, pt.params_from_jax(start, tcfg, device="cpu"), tcfg, fsdp)
    opt = pt.AdamW(3e-4)
    state = opt.init(params)
    step, _, shard = pt.transformer_train_step(mesh, tcfg, optimizer=opt,
                                               fsdp=fsdp)
    ts = shard(toks)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, ts)
        losses.append(float(loss))
    return params, state, losses


CASES = {
    "fsdp": (CFG, True, (8, 17)),
    "fsdp_moe": (dataclasses.replace(CFG, n_experts=2), True, (8, 17)),
    "sp_moe": (dataclasses.replace(CFG, n_experts=2, sequence_parallel=True,
                                   moe_capacity_factor=4.0), False, (4, 16)),
}


@pytest.fixture(scope="module")
def ref_runs(devices):
    out = {}
    for name, (jcfg, fsdp, shape) in CASES.items():
        jm, _ = _meshes(4, 2)
        toks = _tokens(*shape, seed=30)
        out[name] = (toks, *_ref_losses(jcfg, jm, fsdp, toks, 30))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_losses_match_reference(ref_runs, name):
    jcfg, fsdp, _ = CASES[name]
    toks, start, ref = ref_runs[name]
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    _, pm = _meshes(4, 2)
    params, state, losses = _port_losses(tcfg, pm, fsdp, start, toks)
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL, atol=0)
    if fsdp:
        # the state is laid out like the params: split over the data axis
        emb = state["mu"]["embed"]
        assert emb.dim_of("data") == 0 and len(emb.parts) == 4


def test_fsdp_matches_replicated_and_holds_less(ref_runs):
    """The same start, batch and optimizer with and without FSDP: the
    losses agree (only the clip norm's summation order differs) and every
    rank holds a quarter of the split leaves' bytes."""
    jcfg, _, _ = CASES["fsdp"]
    toks, start, _ = ref_runs["fsdp"]
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    _, pm = _meshes(4, 2)
    runs = {fsdp: _port_losses(tcfg, pm, fsdp, start, toks)
            for fsdp in (False, True)}
    np.testing.assert_allclose(runs[True][2], runs[False][2],
                               rtol=LOSS_RTOL, atol=0)
    rep, sh = (pt.layout_bytes(runs[f][0]) for f in (False, True))
    assert set(rep) == set(sh) == {(d, m) for d in range(4)
                                   for m in range(2)}
    assert all(sh[r] < rep[r] / 2 for r in rep), (rep, sh)
    # gathered whole, the FSDP params are the replicated run's within the
    # optimizer's rounding
    for (path, a), (_, b) in zip(
            pt._leaves(pt.gather_transformer_params(runs[True][0])),
            pt._leaves(pt.gather_transformer_params(runs[False][0]))):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5,
                                   msg=str(path))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_sequence_parallel_logits_match_reference(devices, moe):
    jcfg = dataclasses.replace(CFG, sequence_parallel=True,
                               n_experts=4 if moe else 0,
                               moe_capacity_factor=8.0)
    jparams = jt.init_transformer(jax.random.key(12), jcfg)
    toks = _tokens(2, 16, seed=12)
    jm, pm = _meshes(2, 4)
    jlg, jaux = jax.jit(jt.transformer_apply(jcfg, jm))(
        jt.place_transformer_params(jm, jparams, jcfg), jnp.asarray(toks))
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    tparams = pt.params_from_jax(jax.tree.map(np.array, jparams), tcfg,
                                 device="cpu")
    lg, aux = pt.transformer_apply(tcfg, pm)(
        pt.place_transformer_params(pm, tparams, tcfg),
        torch.from_numpy(toks))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL, rtol=0)
    if not moe:
        # the ring's attention is the dense model's
        dense = dataclasses.replace(tcfg, sequence_parallel=False)
        ref, _ = pt.transformer_apply(dense)(tparams,
                                             torch.from_numpy(toks).long())
        np.testing.assert_allclose(lg.numpy(), ref.numpy(), atol=TOL,
                                   rtol=0)


def test_sequence_parallel_loss_rolls_and_masks(devices):
    """The sequence-parallel loss over (B, T) tokens equals the reference's
    and the plain loss over the same tokens with the last position's
    target dropped."""
    jcfg = dataclasses.replace(CFG, sequence_parallel=True)
    jparams = jt.init_transformer(jax.random.key(4), jcfg)
    toks = _tokens(2, 16, seed=4)
    jm, pm = _meshes(2, 2)
    jl = jax.jit(jt.transformer_loss(jcfg, jm))(
        jt.place_transformer_params(jm, jparams, jcfg), jnp.asarray(toks))
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    tparams = pt.params_from_jax(jax.tree.map(np.array, jparams), tcfg,
                                 device="cpu")
    tl = pt.transformer_loss(tcfg, pm)(tparams, torch.from_numpy(toks))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    plain = pt.transformer_loss(dataclasses.replace(
        tcfg, sequence_parallel=False))(tparams,
                                        torch.from_numpy(toks).long())
    assert abs(float(tl) - float(plain)) <= 1e-5 * abs(float(plain))


def test_refusals_keep_the_references_wording():
    tcfg = pt.TransformerConfig.from_json(CFG.to_json())
    pm = pmesh.dp_mp_mesh(2, 2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.transformer_apply(dataclasses.replace(
            tcfg, use_flash=True, sequence_parallel=True), pm)
    for bad in (dataclasses.replace(tcfg, n_experts=2),
                dataclasses.replace(tcfg, sequence_parallel=True)):
        with pytest.raises(ValueError, match="need a mesh"):
            pt.transformer_loss(bad)
    with pytest.raises(ValueError, match="must equal the mesh's model"):
        pt.transformer_apply(dataclasses.replace(tcfg, n_experts=3), pm)
    with pytest.raises(ValueError, match="divisible by the mesh's model"):
        pt.transformer_shardings(pmesh.dp_mp_mesh(1, 3, ["cpu"] * 3), tcfg)
    with pytest.raises(ValueError, match="pass a mesh"):
        pt.transformer_train_step(None, tcfg, fsdp=True, device="cpu")
    step, _, shard = pt.transformer_train_step(pm, tcfg)
    whole = pt.init_params(tcfg, device="cpu")
    with pytest.raises(TypeError, match="laid out"):
        step(whole, pt.AdamW(1e-3).init(whole), shard(_tokens(2, 9)))
    with pytest.raises(ValueError, match="divisible by the data axis"):
        pt.transformer_loss(dataclasses.replace(
            tcfg, sequence_parallel=True), pm)(
            whole, torch.from_numpy(_tokens(2, 15)))


def test_place_gather_and_clip_over_parts():
    """A laid-out tree gathers back bitwise, and the optimizer's update
    over the parts (the clip's global norm over all of them) is the
    update of the whole tree."""
    tcfg = pt.TransformerConfig.from_json(CFG.to_json())
    pm = pmesh.dp_mp_mesh(2, 2, ["cpu"] * 4)
    whole = pt.init_params(tcfg, seed=7, device="cpu")
    placed = pt.place_transformer_params(pm, whole, tcfg, fsdp=True)
    back = pt.gather_transformer_params(placed)
    for (path, a), (_, b) in zip(pt._leaves(whole), pt._leaves(back)):
        assert torch.equal(a, b), path
    grads = pt._map_parts(lambda p: torch.full_like(p, 0.5), placed)
    opt = pt.lm_optimizer(peak_lr=1e-2, total_steps=10, warmup_steps=1,
                          clip_norm=1.0)
    state = opt.init(placed)
    for _ in range(2):
        opt.update_(placed, grads, state)
    ref_state = opt.init(whole)
    whole_grads = pt._map_parts(lambda p: torch.full_like(p, 0.5), whole)
    for _ in range(2):
        opt.update_(whole, whole_grads, ref_state)
    for (path, a), (_, b) in zip(
            pt._leaves(pt.gather_transformer_params(placed)),
            pt._leaves(whole)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6,
                                   msg=str(path))
