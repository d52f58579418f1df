"""The port's transformer training on a (data, model) mesh, held against
the reference's GSPMD programs on the CPU: the reference on its 8 virtual
devices, the port on one controller over ``["cpu"] * (dp * tp)``, the same
params (``params_from_jax``) and tokens.

- the layout: ``transformer_shardings`` / ``fsdp_shardings`` leaf by leaf
  against the reference's ``PartitionSpec``s;
- ``transformer_apply`` logits on (2, 4) and (1, 4) meshes, dense and MoE;
- gradients of ``transformer_loss`` on the mesh;
- ``transformer_train_step`` losses at the same (dp, tp): dense, MoE, GQA
  and MQA on (4, 2).

Routing is discrete: the MoE cases assert a top-2 gate margin above
``ROUTE_MARGIN`` at the first layer's input, so a routing flip shows as a
fault and not as noise.
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

# f32 logits and gradients: the frameworks sum in other orders
TOL = 1e-4
# f32 losses over a few optimizer steps
LOSS_RTOL = 2e-3
ROUTE_MARGIN = 1e-4
STEPS = 4

# the reference tests' CFG (tests/test_transformer.py:23)
CFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32
)
CONFIGS = {
    "dense": CFG,
    "moe": dataclasses.replace(CFG, n_experts=2, moe_capacity_factor=2.0),
    "gqa": dataclasses.replace(CFG, n_kv_heads=2, rope=True),
    "mqa": dataclasses.replace(CFG, n_kv_heads=1),
}


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size,
                                                (b, t)).astype(np.int32)


def _meshes(dp, tp):
    return (jmesh.dp_mp_mesh(dp, tp),
            pmesh.dp_mp_mesh(dp, tp, ["cpu"] * (dp * tp)))


def _port(jcfg, jparams):
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    return tcfg, pt.params_from_jax(jax.tree.map(np.array, jparams), tcfg,
                                    device="cpu")


def _route_margin(jparams, tokens, t):
    """The smallest gap between adjacent gates among a token's top 3 at
    the first layer's router (its top-2 choices and their order): a guard
    on the seeded data at the layer the tokens reach first; the logits'
    tolerance covers the second layer."""
    x = jparams["embed"][tokens] + jparams["pos"][:t]
    b = jparams["blocks"]
    h = jt._layer_norm(x, b["ln1_scale"][0], b["ln1_bias"][0])
    g = np.asarray(jax.nn.softmax(h @ b["moe"].wg[0], axis=-1)).reshape(
        -1, b["moe"].wg.shape[-1])
    s = -np.sort(-g, axis=1)
    return float(np.min(s[:, :2] - s[:, 1:3]))


def _spec(s, rank):
    spec = tuple(s.spec) + (None,) * (rank - len(tuple(s.spec)))
    return tuple(None if a is None else a for a in spec)


def _flat_specs(jspecs):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]:
        out[tuple(getattr(p, "key", getattr(p, "name", None))
                  for p in path)] = s
    return out


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_layout_matches_reference_specs(devices, shape, name, fsdp):
    jcfg = CONFIGS[name]
    if jcfg.n_experts:
        jcfg = dataclasses.replace(jcfg, n_experts=shape[1])
    jm, pm = _meshes(*shape)
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    jspecs = (jt.fsdp_shardings(jm, jcfg) if fsdp
              else jt.transformer_shardings(jm, jcfg))
    ref = _flat_specs(jspecs)
    mine = dict(pt._leaves((pt.fsdp_shardings if fsdp
                            else pt.transformer_shardings)(pm, tcfg)))
    shapes = dict(pt._leaves(pt.param_shapes(tcfg)))
    assert set(mine) == set(ref) == set(shapes)
    for path, spec in mine.items():
        assert spec == _spec(ref[path], len(shapes[path])), path


@pytest.fixture(scope="module")
def logits_cases(devices):
    """Reference logits (and aux) per (config, dp): the inputs and its
    outputs, computed once."""
    out = {}
    toks = _tokens(4, 16, seed=1)
    for name in ("dense", "moe"):
        jcfg = dataclasses.replace(CONFIGS[name], n_experts=4,
                                   moe_capacity_factor=8.0) if (
            name == "moe") else CONFIGS[name]
        jparams = jt.init_transformer(jax.random.key(11), jcfg)
        for dp in (2, 1):
            jm, _ = _meshes(dp, 4)
            apply = jax.jit(jt.transformer_apply(
                jcfg, jm if jcfg.n_experts else None))
            lg, aux = apply(jt.place_transformer_params(jm, jparams, jcfg),
                            jnp.asarray(toks))
            out[name, dp] = (jcfg, jparams, toks, np.asarray(lg),
                             float(aux))
    return out


@pytest.mark.parametrize("dp", [2, 1])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_apply_logits_match_reference(logits_cases, name, dp):
    jcfg, jparams, toks, jlg, jaux = logits_cases[name, dp]
    if jcfg.n_experts:
        assert _route_margin(jparams, toks, 16) > ROUTE_MARGIN
    tcfg, tparams = _port(jcfg, jparams)
    _, pm = _meshes(dp, 4)
    placed = pt.place_transformer_params(pm, tparams, tcfg)
    lg, aux = pt.transformer_apply(tcfg, pm)(placed, torch.from_numpy(toks))
    np.testing.assert_allclose(lg.numpy(), jlg, atol=TOL, rtol=0)
    np.testing.assert_allclose(float(aux), jaux, atol=TOL, rtol=0)
    # a whole tree is split on the fly, to the same logits
    lg2, _ = pt.transformer_apply(tcfg, pm)(tparams, torch.from_numpy(toks))
    assert torch.equal(lg, lg2)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_mesh_gradients_match_reference(devices, name):
    jcfg = CONFIGS[name]
    jparams = jt.init_transformer(jax.random.key(5), jcfg)
    toks = _tokens(4, 17, seed=5)
    jm, pm = _meshes(2, 2)
    jl, jg = jax.jit(jax.value_and_grad(jt.transformer_loss(jcfg, jm)))(
        jt.place_transformer_params(jm, jparams, jcfg), jnp.asarray(toks))
    tcfg, tparams = _port(jcfg, jparams)
    placed = pt.place_transformer_params(pm, tparams, tcfg)
    tl, tg = pt.value_and_grad(pt.transformer_loss(tcfg, pm), placed,
                               torch.from_numpy(toks))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    ref = _flat_specs(jg)
    for path, g in pt._leaves(tg):
        assert isinstance(g, pmesh.MeshTensor)
        r = np.asarray(ref[path])
        np.testing.assert_allclose(g.whole().numpy(), r,
                                   atol=TOL * max(1.0, np.abs(r).max()),
                                   rtol=0, err_msg=str(path))


@pytest.fixture(scope="module")
def train_cases(devices):
    """Reference losses of STEPS ``transformer_train_step`` calls on (4,
    2), from one init and one fixed batch, with the params they start
    from."""
    out = {}
    for name, jcfg in CONFIGS.items():
        jm, _ = _meshes(4, 2)
        step, init_state, shard = jt.transformer_train_step(jm, jcfg)
        jparams, jopt = init_state(jax.random.key(3))
        start = jax.tree.map(np.array, jparams)
        ts = shard(jnp.asarray(_tokens(8, 17, seed=3)))
        losses = []
        for _ in range(STEPS):
            jparams, jopt, loss = step(jparams, jopt, ts)
            losses.append(float(loss))
        out[name] = (start, losses)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_losses_match_reference(train_cases, name):
    start, ref = train_cases[name]
    jcfg = CONFIGS[name]
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    _, pm = _meshes(4, 2)
    params = pt.place_transformer_params(
        pm, pt.params_from_jax(start, tcfg, device="cpu"), tcfg)
    opt = pt.AdamW(3e-4)  # the reference step's default, optax.adamw(3e-4)
    state = opt.init(params)
    step, _, shard = pt.transformer_train_step(pm, tcfg, optimizer=opt)
    ts = shard(_tokens(8, 17, seed=3))
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, ts)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]


def test_remat_and_flash_on_the_mesh(devices):
    """On the mesh, remat changes no bit (both policies), and the flash
    kernels' plain versions, one call a model rank over its heads, give
    the dense attention's loss and gradients within f32 rounding."""
    tcfg = pt.TransformerConfig.from_json(CFG.to_json())
    _, pm = _meshes(2, 2)
    params = pt.place_transformer_params(
        pm, pt.init_params(tcfg, seed=2, device="cpu"), tcfg)
    toks = torch.from_numpy(_tokens(4, 17, seed=2))

    def run(cfg):
        fresh = pt._map_parts(lambda p: p.detach().clone(), params)
        loss, grads = pt.value_and_grad(pt.transformer_loss(cfg, pm), fresh,
                                        toks)
        return loss, [q for _, g in pt._leaves(grads) for q in g.flat()]

    flash = dataclasses.replace(tcfg, use_flash=True)
    l0, g0 = run(flash)
    for policy in ("dots_no_batch", "full"):
        l1, g1 = run(dataclasses.replace(flash, remat=True,
                                         remat_policy=policy))
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1)), policy
    ld, gd = run(tcfg)
    assert abs(float(l0) - float(ld)) <= 1e-5 * abs(float(ld))
    for a, b in zip(g0, gd):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_decay_mask_matches_reference(name):
    """AdamW's decay mask by leaf name, as the reference's: the MoE biases
    ``b1``/``b2`` exempt, the router and expert weights decayed."""
    jcfg = CONFIGS[name]
    jparams = jt.init_transformer(jax.random.key(0), jcfg)
    ref = _flat_specs(jt._decay_mask(jparams))
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    mine = dict(pt._leaves(pt._decay_mask(pt.param_shapes(tcfg))))
    assert mine == {path: bool(v) for path, v in ref.items()}
    if jcfg.n_experts:
        assert [mine["blocks", "moe", f] for f in
                ("wg", "w1", "b1", "w2", "b2")] == [True, True, False, True,
                                                    False]
