"""The port's expert parallelism (``parallel/expert_parallel.py``), its
online-softmax attention and ring attention, held against the reference's
on the CPU: the reference on its 8 virtual devices, the port's meshes on
``["cpu"] * n``.

Routing is discrete, so a flipped top-k choice would show as a large
difference, not as rounding: every seeded input asserts a top-k gate margin
above ``ROUTE_MARGIN`` first, and then a difference is a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jattn
from deeplearning4j_tpu.parallel import expert_parallel as jep
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import sequence_parallel as jsp
from deeplearning4j_tpu_torch.ops import attention as pattn
from deeplearning4j_tpu_torch.parallel import expert_parallel as pep
from deeplearning4j_tpu_torch.parallel import mesh as pmesh
from deeplearning4j_tpu_torch.parallel import sequence_parallel as psp

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

D, H = 8, 16
# f32 values: the frameworks sum in other orders
TOL = 1e-4
# a routing decision closer than this could flip on rounding alone
ROUTE_MARGIN = 1e-4


def _tokens(n, seed=0, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _pair(n_exp, seed=0):
    jp = jep.init_moe_params(jax.random.key(seed), D, H, n_exp)
    tp = pep.MoEParams(*(torch.from_numpy(np.array(a)) for a in jp))
    return jp, tp


def _margin(params, x, k):
    """The smallest gap between a token's k-th and (k+1)-th gate."""
    g = np.asarray(jax.nn.softmax(jnp.asarray(x) @ params.wg, axis=-1))
    s = -np.sort(-g, axis=1)
    return float(np.min(s[:, k - 1] - s[:, k])) if g.shape[1] > k else 1.0


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def expert_mesh(devices):
    return jmesh.expert_mesh(8), pmesh.expert_mesh(devices=["cpu"] * 8)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_moe_reference_matches(k, act):
    jp, tp = _pair(4, seed=k)
    x = _tokens(24, seed=10 + k)
    assert _margin(jp, x, k) > ROUTE_MARGIN
    jact = {"relu": jax.nn.relu, "gelu": jax.nn.gelu}[act]
    pact = {"relu": pep.relu, "gelu": pep.gelu}[act]
    y = pep.moe_reference(tp, torch.from_numpy(x), k=k, activation=pact)
    _close(y, jep.moe_reference(jp, jnp.asarray(x), k=k, activation=jact))


def test_moe_reference_breaks_ties_toward_the_lower_expert():
    """``lax.top_k`` keeps the lower index first on a tie; so does the
    port's stable sort (``torch.topk`` promises no order)."""
    jp, tp = _pair(4)
    wg = np.zeros((D, 4), np.float32)  # every gate 1/4: a four-way tie
    jp = jp._replace(wg=jnp.asarray(wg))
    tp = tp._replace(wg=torch.from_numpy(wg))
    x = _tokens(5, seed=3)
    _close(pep.moe_reference(tp, torch.from_numpy(x), k=2),
           jep.moe_reference(jp, jnp.asarray(x), k=2))


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_masks_match_reference(k, cf):
    """The index route rebuilt as the reference's dense masks, drops at
    small capacity factors included."""
    jp, _ = _pair(4, seed=5)
    x = _tokens(32, seed=6)
    assert _margin(jp, x, k) > ROUTE_MARGIN
    gates = jax.nn.softmax(jnp.asarray(x) @ jp.wg, axis=-1)
    cap = max(1, int(cf * k * 32 / 4))
    jd, jc, jf = jep._top_k_dispatch(gates, k, cap)
    pd, pc, pf = pep._top_k_dispatch(torch.from_numpy(np.array(gates)),
                                     k, cap)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    _close(pc, jc, 1e-6)
    _close(pf, jf, 1e-6)
    if cf == 0.25:
        assert float(np.asarray(jd).sum()) < k * 32  # tokens did drop


@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_apply_matches_reference(expert_mesh, k, cf):
    jm, pm = expert_mesh
    jp, tp = _pair(8, seed=7)
    x = _tokens(64, seed=11)
    assert _margin(jp, x, k) > ROUTE_MARGIN
    jy, jaux = jep.moe_apply(jm, k=k, capacity_factor=cf)(
        jep.place_moe_params(jm, jp), jnp.asarray(x))
    py, paux = pep.moe_apply(pm, k=k, capacity_factor=cf)(
        pep.place_moe_params(pm, tp), torch.from_numpy(x))
    _close(py, jy)
    _close(paux, jaux)


def _ffn_pair(mesh, spec, k, cf):
    return (jep.moe_ffn(mesh[0], k=k, capacity_factor=cf,
                        token_spec=jax.sharding.PartitionSpec(*spec)),
            pep.moe_ffn(mesh[1], k=k, capacity_factor=cf, token_spec=spec))


@pytest.fixture(scope="module")
def dp_mp(devices):
    return jmesh.dp_mp_mesh(2, 4), pmesh.dp_mp_mesh(2, 4, ["cpu"] * 8)


@pytest.mark.parametrize("spec", [("data", None, None), (None, "data", None)],
                         ids=["batch", "sequence"])
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_ffn_matches_reference(dp_mp, spec, cf):
    jp, tp = _pair(4, seed=9)
    x = _tokens(4 * 8, seed=11).reshape(4, 8, D)
    assert _margin(jp, x.reshape(-1, D), 2) > ROUTE_MARGIN
    jfn, pfn = _ffn_pair(dp_mp, spec, 2, cf)
    jy, jaux = jax.jit(jfn)(jp, jnp.asarray(x))
    py, paux = pfn(tp, torch.from_numpy(x))
    _close(py, jy)
    _close(paux, jaux)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_gradients_match_reference(dp_mp, k):
    """Gradients through the router (the combine weights and the aux
    loss) and the experts; at k 1 the raw gate keeps the router's task
    gradient."""
    jp, tp = _pair(4, seed=12)
    x = _tokens(4 * 8, seed=13).reshape(4, 8, D)
    w = _tokens(4 * 8, seed=14).reshape(4, 8, D)
    assert _margin(jp, x.reshape(-1, D), k) > ROUTE_MARGIN
    jfn, pfn = _ffn_pair(dp_mp, ("data", None, None), k, 2.0)

    def jloss(p, xx):
        y, aux = jfn(p, xx)
        return jnp.sum(y * w) + 0.01 * aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_() for t in tp]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = pfn(pep.MoEParams(*leaves), xt)
    (y * torch.from_numpy(w)).sum().add(0.01 * aux).backward()
    for name, leaf, ref in zip(pep.MoEParams._fields, leaves, jg):
        _close(leaf.grad, ref)
        if name == "wg":
            assert float(leaf.grad.abs().max()) > 1e-3  # the router learns
    _close(xt.grad, jgx)


def test_one_expert_per_rank_or_the_references_error(expert_mesh, dp_mp):
    _, tp = _pair(4)
    x = torch.from_numpy(_tokens(16))
    with pytest.raises(ValueError, match="one expert per device"):
        pep.moe_apply(expert_mesh[1])(tp, x)
    with pytest.raises(ValueError, match="one expert per device"):
        pep.moe_ffn(pmesh.dp_mp_mesh(1, 2, ["cpu"] * 2))(tp, x[None])
    # the reference raises the same for the same geometry
    jp, _ = _pair(4)
    with pytest.raises(ValueError, match="one expert per device"):
        jep.moe_ffn(jmesh.dp_mp_mesh(1, 2))(jp, jnp.asarray(x[None].numpy()))


def test_placed_experts_live_one_a_rank(expert_mesh):
    _, tp = _pair(8)
    placed = pep.place_moe_params(expert_mesh[1], tp)
    assert isinstance(placed.w1, pmesh.Shards) and len(placed.w1) == 8
    assert all(p.shape == (1, D, H) for p in placed.w1)
    assert torch.equal(torch.cat(list(placed.w2)), tp.w2)
    assert torch.equal(placed.wg, tp.wg)
    init = pep.init_moe_params(0, D, H, 4, device="cpu")
    assert [tuple(a.shape) for a in init] == [
        (D, 4), (4, D, H), (4, H), (4, H, D), (4, D)]
    assert float(init.b1.abs().max()) == 0.0


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_blocked_attention_matches_reference(causal):
    q, k, v = _qkv(2, 16, 3, 8, seed=20 + causal)
    _close(pattn.blocked_attention(*map(torch.from_numpy, (q, k, v)), 4,
                                   causal),
           jattn.blocked_attention(*map(jnp.asarray, (q, k, v)), 4, causal),
           1e-5)
    # and the dense attention it streams
    _close(pattn.blocked_attention(*map(torch.from_numpy, (q, k, v)), 4,
                                   causal),
           pattn.attention(*map(torch.from_numpy, (q, k, v)), causal),
           1e-5)


@pytest.mark.parametrize("head_axis", [None, "model"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(dp_mp, causal, head_axis):
    q, k, v = _qkv(2, 16, 4, 8, seed=30 + causal)
    jy = jsp.ring_attention(dp_mp[0], causal, head_axis)(
        *map(jnp.asarray, (q, k, v)))
    py = psp.ring_attention(dp_mp[1], causal, head_axis)(
        *map(torch.from_numpy, (q, k, v)))
    _close(py, jy, 1e-5)
    _close(py, pattn.attention(*map(torch.from_numpy, (q, k, v)), causal),
           1e-5)
