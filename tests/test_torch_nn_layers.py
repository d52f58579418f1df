"""The DL4J-era core of the port (``nn/``, ``rng``, ``dtypes``) held against
the JAX package's on the CPU: every activation, loss, preprocessor and
weight-init scheme; every layer's init, ``activate``, ``pre_output``,
score and gradient from the reference's own params carried over; the
reference's key stream (dropout, DropConnect, corruption, RBM sampling);
then the reference's behavioural tests (``tests/test_conf.py``,
``tests/test_layers.py``, the layer gradient checks of
``tests/test_gradients_determinism.py``) on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu import rng as jrng
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn import preprocessors as jpp
from deeplearning4j_tpu.nn import weights as jweights
from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.nn import activations, losses, preprocessors, weights
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad
from deeplearning4j_tpu_torch.nn.layers.convolution import hwio_to_oihw, oihw_to_hwio
from deeplearning4j_tpu_torch.utils import tree_math as tm

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

#: f32 outputs and scores, port vs reference (the frameworks sum in other
#: orders and round transcendental functions differently)
OUT_ATOL = 1e-5
#: f32 gradients: |g - g_ref| <= GRAD_RTOL * max|g_ref|, leaf by leaf
GRAD_RTOL = 1e-4
#: MIXED_BF16: ||a - a_ref|| <= BF16_RTOL * ||a_ref|| (bf16 products round
#: at other places)
BF16_RTOL = 2e-2
#: rng.normal vs jax.random.normal in ulps: XLA's log1p and PyTorch's
#: differ in the last bits (the rest of erf_inv is XLA's, fused)
NORMAL_ULPS = 3
#: an RBM draw u < p is a near-tie when |u - p| is below this: an ulp of
#: difference in p (a sigmoid summed in another order) may flip it
NEAR_TIE = 1e-6


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _carry(jparams: dict) -> dict:
    """A reference layer's params as the port's (conv kernels OIHW)."""
    out = {k: _t(v) for k, v in jparams.items()}
    if "convweights" in out:
        out["convweights"] = hwio_to_oihw(out["convweights"])
    return out


def _back(tparams: dict) -> dict:
    out = {k: v.detach().numpy() for k, v in tparams.items()}
    if "convweights" in out:
        out["convweights"] = oihw_to_hwio(
            torch.from_numpy(out["convweights"])).numpy()
    return out


def _conf(jconf) -> C.LayerConfig:
    return C.LayerConfig.from_json(jconf.to_json())


def _close(a, b, atol=OUT_ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=atol)


def _close_scaled(a, b):
    """OUT_ATOL on the scale of ``b``: the means and samples inside a Gibbs
    chain of gaussian and linear units grow past 1 (a few ulps there are
    more than 1e-5)."""
    _close(a, b, atol=OUT_ATOL * max(1.0, float(np.abs(np.asarray(b)).max())))


def _grads_close(tgrads: dict, jgrads: dict):
    back = _back(tgrads)
    for k, g_ref in jgrads.items():
        g_ref = np.asarray(g_ref)
        err = np.abs(back[k] - g_ref).max()
        assert err <= GRAD_RTOL * np.abs(g_ref).max() + 1e-12, (k, err)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


# -- registries: activations, losses, preprocessors ---------------------------

X = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32) * 2


@pytest.mark.parametrize("name", jact.names())
def test_activation_parity(name):
    assert activations.names() == jact.names()
    a = activations.get(name)(_t(X)).numpy()
    ref = np.asarray(jact.get(name)(jnp.asarray(X)))
    np.testing.assert_allclose(a, ref, rtol=1e-6, atol=1e-6)
    if name in ("sigmoid", "tanh", "hardtanh", "relu", "linear", "softmax"):
        np.testing.assert_allclose(
            activations.derivative(name, _t(ref)).numpy(),
            np.asarray(jact.derivative(name, jnp.asarray(ref))), rtol=0,
            atol=1e-6)


@pytest.mark.parametrize("name", jlosses.names())
def test_loss_parity(name):
    assert losses.names() == jlosses.names()
    rs = np.random.default_rng(1)
    labels = np.eye(5, dtype=np.float32)[rs.integers(0, 5, 6)]
    out = np.asarray(jax.nn.softmax(jnp.asarray(X), -1))
    got = losses.get(name)(_t(labels), _t(out)).item()
    ref = float(jlosses.get(name)(jnp.asarray(labels), jnp.asarray(out)))
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (got, ref)
    if name in ("MCXENT", "NEGATIVELOGLIKELIHOOD", "XENT",
                "RECONSTRUCTION_CROSSENTROPY"):
        got = losses.logits_loss(name, _t(labels), _t(X)).item()
        ref = float(jlosses.logits_loss(name, jnp.asarray(labels),
                                        jnp.asarray(X)))
        assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (got, ref)
    else:
        with pytest.raises(ValueError, match="fused"):
            losses.logits_loss(name, _t(labels), _t(X))


@pytest.mark.parametrize("name", ["flatten", "zero_mean_unit_variance",
                                  "zero_mean", "unit_variance", "reshape:5,1",
                                  "binomial_sampling"])
def test_preprocessor_parity(name):
    x = np.random.default_rng(2).random((6, 5), dtype=np.float32)
    got = preprocessors.get(name)(_t(x), rng.key_for(3)).numpy()
    ref = np.asarray(jpp.get(name)(jnp.asarray(x), jax.random.key(3)))
    if name == "binomial_sampling":
        np.testing.assert_array_equal(got, ref)  # the reference's draw
        np.testing.assert_array_equal(
            preprocessors.get(name)(_t(x), None).numpy(), x)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# -- the key stream and weight init -------------------------------------------

def test_key_stream_and_draws_are_the_reference():
    ks, jks = rng.KeyStream(5), jrng.KeyStream(5)
    for _ in range(3):
        assert ks.next() == tuple(int(w) for w in
                                  jax.random.key_data(jks.next()))
    subs, jsubs = ks.next_n(4), jks.next_n(4)
    assert subs == [tuple(int(w) for w in row)
                    for row in np.asarray(jax.random.key_data(jsubs))]
    assert rng.key_for(7) == tuple(int(w) for w in
                                   jax.random.key_data(jrng.key_for(7)))
    k, jk = rng.key_for(11), jax.random.key(11)
    np.testing.assert_array_equal(
        rng.uniform(k, (40, 30), -0.3, 0.7).numpy(),
        np.asarray(jax.random.uniform(jk, (40, 30), minval=-0.3, maxval=0.7)))
    p = np.random.default_rng(4).random((40, 30), dtype=np.float32)
    np.testing.assert_array_equal(
        rng.bernoulli(k, _t(p)).numpy(),
        np.asarray(jax.random.bernoulli(jk, jnp.asarray(p))))
    np.testing.assert_array_equal(
        rng.bernoulli(k, 0.3, (40, 30)).numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.3, (40, 30))))
    z = rng.normal(k, (200, 300)).numpy()
    z_ref = np.asarray(jax.random.normal(jk, (200, 300)))
    assert _ulps(z, z_ref) <= NORMAL_ULPS
    # most values are XLA's bit for bit
    assert (z != z_ref).mean() < 0.05


SCHEMES = [(s, None) for s in jweights.SCHEMES] + [
    ("distribution", ("uniform", -0.2, 0.3))]


@pytest.mark.parametrize("scheme,dist", SCHEMES,
                         ids=[f"{s}-{d[0] if d else 'default'}"
                              for s, d in SCHEMES])
def test_weight_init_parity(scheme, dist):
    """Bitwise for the uniform schemes; the normal scheme within
    NORMAL_ULPS."""
    w = weights.init_weights(rng.key_for(9), (48, 20), scheme, dist).numpy()
    ref = np.asarray(jweights.init_weights(jax.random.key(9), (48, 20),
                                           scheme, dist))
    if scheme == "distribution" and dist is None:  # N(0, 0.01)
        assert _ulps(w, ref) <= NORMAL_ULPS
    else:
        np.testing.assert_array_equal(w, ref)


# -- layers: init, forward, score and gradient from carried params ------------

def _layer_case(name):
    """(reference conf, reference input, port input) of a layer case."""
    rs = np.random.default_rng(5)
    if name == "conv":
        jc = JC.LayerConfig(layer_type="conv_downsample", n_in=2,
                            num_feature_maps=3, filter_size=(3, 3),
                            stride=(2, 2), activation="tanh")
        x = rs.normal(size=(2, 9, 9, 2)).astype(np.float32)
        return jc, x, x.transpose(0, 3, 1, 2).copy()
    if name == "lstm":
        jc = JC.LayerConfig(layer_type="lstm", n_in=6, n_out=6,
                            activation="tanh")
        x = np.eye(6, dtype=np.float32)[rs.integers(0, 6, (2, 5))]
        return jc, x, x
    if name == "recursive_autoencoder":
        jc = JC.LayerConfig(layer_type="recursive_autoencoder", n_in=4,
                            activation="tanh")
        x = rs.normal(size=(3, 5, 4)).astype(np.float32)
        return jc, x, x
    kind, act, loss = {
        "dense": ("dense", "tanh", "MSE"),
        "output_softmax": ("output", "softmax", "MCXENT"),
        "output_sigmoid": ("output", "sigmoid", "XENT"),
        "output_linear": ("output", "linear", "MSE"),
        "autoencoder": ("autoencoder", "sigmoid", "MSE"),
        "rbm": ("rbm", "sigmoid", "MSE"),
    }[name]
    jc = JC.LayerConfig(layer_type=kind, n_in=10, n_out=5, activation=act,
                        loss=loss, use_regularization=True, l2=0.01)
    x = rs.random((6, 10), dtype=np.float32)
    return jc, x, x


LAYER_CASES = ["dense", "output_softmax", "output_sigmoid", "output_linear",
               "conv", "rbm", "autoencoder", "lstm", "recursive_autoencoder"]


def _objective(mod, conf, x, y, key, port: bool):
    """The scalar each case's gradient is taken of: the supervised score
    of the output and LSTM layers, the unsupervised score of the pretrain
    layers, sum(activate**2) of the others."""
    if hasattr(mod, "supervised_score"):
        return lambda p: mod.supervised_score(p, conf, x, y)
    if hasattr(mod, "score") and not hasattr(mod, "prop_up"):
        return lambda p: mod.score(p, conf, x, key)
    if hasattr(mod, "prop_up"):  # the RBM's score: reconstruction (+ L2)
        return lambda p: mod.score(p, conf, x, key)
    return lambda p: (mod.activate(p, conf, x) ** 2).sum()


@pytest.mark.parametrize("name", LAYER_CASES)
def test_layer_parity_f32(name):
    jc, jx, tx = _layer_case(name)
    tc = _conf(jc)
    jmod, tmod = JL.get(jc.layer_type), L.get(tc.layer_type)
    jp = jmod.init(jax.random.key(0), jc)
    # init from the same key: the reference's weights, bit for bit
    for k, v in _back(tmod.init(rng.key_for(0), tc, device="cpu")).items():
        np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)
    tp = _carry(jp)
    x, xt = jnp.asarray(jx), _t(tx)
    out = tmod.activate(tp, tc, xt)
    ref = jmod.activate(jp, jc, x)
    if name == "conv":
        out = out.permute(0, 2, 3, 1)
    _close(out.numpy(), ref)
    if hasattr(jmod, "pre_output"):  # every layer but the LSTM
        pre = tmod.pre_output(tp, tc, xt)
        if name == "conv":
            pre = pre.permute(0, 2, 3, 1)
        _close(pre.numpy(), jmod.pre_output(jp, jc, x))
    y = None
    if hasattr(jmod, "supervised_score"):
        n_out = jc.n_out
        lab = np.eye(n_out, dtype=np.float32)[
            np.random.default_rng(6).integers(0, n_out, jx.shape[:-1])]
        y = lab
    jf = _objective(jmod, jc, x, None if y is None else jnp.asarray(y),
                    jax.random.key(4), False)
    tf = _objective(tmod, tc, xt, None if y is None else _t(y),
                    rng.key_for(4), True)
    ref_score, ref_grads = jax.value_and_grad(jf)(jp)
    score, grads = value_and_grad(tf)(tp)
    assert abs(score.item() - float(ref_score)) <= OUT_ATOL * max(
        1.0, abs(float(ref_score))), (score.item(), float(ref_score))
    _grads_close(grads, ref_grads)
    if hasattr(jmod, "gradient") and name != "rbm":
        # the module's own gradient: autodiff of its score
        s2, g2 = tmod.gradient(tp, tc, xt, rng.key_for(4))
        r2, rg2 = jmod.gradient(jp, jc, x, jax.random.key(4))
        assert abs(s2.item() - float(r2)) <= OUT_ATOL
        _grads_close(g2, rg2)


@pytest.mark.parametrize("name", ["dense", "output_softmax", "conv", "lstm"])
def test_layer_parity_mixed_bf16(name):
    """The layers that follow the dtype policy, under MIXED_BF16."""
    jc, jx, tx = _layer_case(name)
    tc = _conf(jc)
    jmod, tmod = JL.get(jc.layer_type), L.get(tc.layer_type)
    jp = jmod.init(jax.random.key(0), jc)
    tp = _carry(jp)
    with jdtypes.policy(jdtypes.MIXED_BF16), dtypes.policy(dtypes.MIXED_BF16):
        ref = np.asarray(jmod.activate(jp, jc, jnp.asarray(jx)), np.float32)
        out = tmod.activate(tp, tc, _t(tx))
        assert out.dtype == torch.bfloat16
        out = out.float()
        if name == "conv":
            out = out.permute(0, 2, 3, 1)
        out = out.numpy()
        assert (np.linalg.norm(out - ref)
                <= BF16_RTOL * np.linalg.norm(ref)), name
        if name == "output_softmax":
            lab = np.eye(5, dtype=np.float32)[[0, 1, 2, 3, 4, 0]]
            s = tmod.supervised_score(tp, tc, _t(tx), _t(lab))
            r = jmod.supervised_score(jp, jc, jnp.asarray(jx),
                                      jnp.asarray(lab))
            assert s.dtype == torch.float32  # the loss runs in accum dtype
            assert abs(s.item() - float(r)) <= BF16_RTOL * abs(float(r))


def test_dropout_and_dropconnect_masks_are_the_reference():
    jm = np.asarray(JL.api.dropout_mask(jax.random.key(2), (30, 20), 0.4,
                                        jnp.float32))
    tmask = L.api.dropout_mask(rng.key_for(2), (30, 20), 0.4, torch.float32,
                               "cpu").numpy()
    np.testing.assert_array_equal(tmask, jm)
    jc = JC.LayerConfig(n_in=8, n_out=4, dropout=0.5, use_drop_connect=True,
                        activation="linear")
    for drop_connect in (True, False):
        jc = jc.replace(use_drop_connect=drop_connect)
        tc = _conf(jc)
        jp = JL.get("dense").init(jax.random.key(0), jc)
        x = np.random.default_rng(3).random((5, 8), dtype=np.float32)
        ref = JL.get("dense").activate(jp, jc, jnp.asarray(x),
                                       key=jax.random.key(7), training=True)
        out = L.get("dense").activate(_carry(jp), tc, _t(x),
                                      key=rng.key_for(7), training=True)
        _close(out.numpy(), ref)


def test_autoencoder_corruption_is_the_reference():
    jc = JC.LayerConfig(layer_type="autoencoder", n_in=12, n_out=4,
                        corruption_level=0.3)
    x = np.random.default_rng(8).random((16, 12), dtype=np.float32)
    got = L.get("autoencoder").corrupt(rng.key_for(5), _conf(jc), _t(x))
    ref = JL.get("autoencoder").corrupt(jax.random.key(5), jc, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


RBM_UNITS = [
    (C.VisibleUnit.BINARY, C.HiddenUnit.BINARY),
    (C.VisibleUnit.GAUSSIAN, C.HiddenUnit.RECTIFIED),
    (C.VisibleUnit.BINARY, C.HiddenUnit.SOFTMAX),
    (C.VisibleUnit.SOFTMAX, C.HiddenUnit.BINARY),
    (C.VisibleUnit.LINEAR, C.HiddenUnit.GAUSSIAN),
]


@pytest.mark.parametrize("visible,hidden", RBM_UNITS)
def test_rbm_cdk_draws_are_the_reference(visible, hidden):
    """CD-3 from the same key: every draw of the chain, fed the reference's
    previous sample, equals the reference's except at near-ties (binary
    units: |u - p| < NEAR_TIE, counted and asserted) or within the normal
    draws' ulps; the free energy, reconstruction, score and gradient agree
    within the f32 bars."""
    jc = JC.LayerConfig(layer_type="rbm", n_in=16, n_out=12,
                        visible_unit=visible, hidden_unit=hidden, k=3)
    tc = _conf(jc)
    jmod, tmod = JL.get("rbm"), L.get("rbm")
    jp = jmod.init(jax.random.key(0), jc)
    tp = _carry(jp)
    x = np.random.default_rng(9).random((32, 16), dtype=np.float32)
    if visible == C.VisibleUnit.SOFTMAX:
        x = x / x.sum(-1, keepdims=True)

    mismatched = near_ties = 0

    def check(kind, key, jsample, tsample, tmean):
        nonlocal mismatched, near_ties
        jsample = np.asarray(jsample)
        tsample = tsample.numpy()
        binary = ((kind == "h" and hidden == C.HiddenUnit.BINARY)
                  or (kind == "v" and visible == C.VisibleUnit.BINARY))
        if binary:
            u = rng.uniform(key, tmean.shape).numpy()
            near = np.abs(u - tmean.numpy()) < NEAR_TIE
            diff = jsample != tsample
            assert not (diff & ~near).any(), kind
            mismatched += int(diff.sum())
            near_ties += int(near.sum())
        else:
            _close_scaled(tsample, jsample)

    jk = jax.random.key(13)
    tk = rng.key_for(13)
    jk_pos, jk_chain = jax.random.split(jk)
    tk_pos, tk_chain = rng.split(tk)
    jmean, jh = jmod.sample_h_given_v(jk_pos, jp, jc, jnp.asarray(x))
    tmean, th = tmod.sample_h_given_v(tk_pos, tp, tc, _t(x))
    _close(tmean.numpy(), jmean)
    check("h", tk_pos, jh, th, tmean)
    for jstep, tstep in zip(jax.random.split(jk_chain, 3),
                            rng.split(tk_chain, 3)):
        jkv, jkh = jax.random.split(jstep)
        tkv, tkh = rng.split(tstep)
        jvm, jv = jmod.sample_v_given_h(jkv, jp, jc, jh)
        tvm, tv = tmod.sample_v_given_h(tkv, tp, tc, _t(jh))
        _close_scaled(tvm.numpy(), jvm)
        check("v", tkv, jv, tv, tvm)
        jhm, jh = jmod.sample_h_given_v(jkh, jp, jc, jv)
        thm, th = tmod.sample_h_given_v(tkh, tp, tc, _t(jv))
        _close_scaled(thm.numpy(), jhm)
        check("h", tkh, jh, th, thm)
    assert mismatched <= near_ties
    assert near_ties == 0, near_ties  # none at this seed: every draw equal

    s, g = tmod.gradient(tp, tc, _t(x), tk)
    rs_, rg = jmod.gradient(jp, jc, jnp.asarray(x), jk)
    assert abs(s.item() - float(rs_)) <= OUT_ATOL * max(1, abs(float(rs_)))
    _grads_close(g, rg)
    _close(tmod.free_energy(tp, tc, _t(x)).item() / 32,
           float(jmod.free_energy(jp, jc, jnp.asarray(x))) / 32)
    _close(tmod.reconstruct(tp, tc, _t(x)).numpy(),
           jmod.reconstruct(jp, jc, jnp.asarray(x)))


def test_lstm_tick_matches_the_reference():
    jc = JC.LayerConfig(layer_type="lstm", n_in=5, n_out=5)
    jp = JL.get("lstm").init(jax.random.key(3), jc)
    tp = _carry(jp)
    e = np.eye(5, dtype=np.float32)
    jh = jcell = jnp.zeros(5)
    th = tcell = torch.zeros(5)
    for i in (1, 3, 0):
        jy, jh, jcell = JL.get("lstm").tick(jp, jc, jnp.asarray(e[i]), jh, jcell)
        ty, th, tcell = L.get("lstm").tick(tp, _conf(jc), _t(e[i]), th, tcell)
        _close(ty.numpy(), jy)
        _close(th.numpy(), jh)


# -- the reference's behavioural tests on the port ----------------------------
# tests/test_conf.py

def test_layer_config_json_roundtrip():
    c = C.LayerConfig(
        layer_type="rbm", n_in=784, n_out=500, activation="tanh",
        momentum_after={10: 0.9, 20: 0.99},
        visible_unit=C.VisibleUnit.GAUSSIAN,
        hidden_unit=C.HiddenUnit.RECTIFIED, k=3,
        dist=("normal", 0.0, 0.01), weight_init="distribution",
    )
    assert C.LayerConfig.from_json(c.to_json()) == c
    # either package reads the other's JSON
    assert JC.LayerConfig.from_json(c.to_json()).to_json() == c.to_json()


def test_multilayer_config_json_roundtrip():
    mc = C.list_builder(C.LayerConfig(activation="tanh", lr=1e-2),
                        sizes=[3, 2], n_in=4, n_out=3,
                        hidden_layer_type="rbm")
    assert C.MultiLayerConfig.from_json(mc.to_json()) == mc
    assert mc.n_layers == 3
    assert mc.confs[0].n_in == 4 and mc.confs[0].n_out == 3
    assert mc.confs[1].n_in == 3 and mc.confs[1].n_out == 2
    assert mc.confs[2].layer_type == "output"
    assert mc.confs[2].n_in == 2 and mc.confs[2].n_out == 3
    jmc = JC.list_builder(JC.LayerConfig(activation="tanh", lr=1e-2),
                          sizes=[3, 2], n_in=4, n_out=3,
                          hidden_layer_type="rbm")
    assert jmc.to_json() == mc.to_json()
    assert C.MultiLayerConfig.from_json(jmc.to_json()) == mc
    assert JC.MultiLayerConfig.from_json(mc.to_json()) == jmc


def test_list_builder_overrides():
    mc = C.list_builder(C.LayerConfig(), sizes=[5], n_in=4, n_out=3,
                        overrides={0: lambda c: c.replace(lr=0.5),
                                   1: lambda c: c.replace(loss="MSE")})
    assert mc.confs[0].lr == 0.5
    assert mc.confs[1].loss == "MSE"


def test_activation_registry():
    x = torch.tensor([-2.0, 0.0, 2.0])
    for name in activations.names():
        assert activations.get(name)(x).shape == x.shape
    s = activations.get("softmax")(torch.ones((2, 3)))
    assert torch.allclose(s.sum(-1), torch.ones(2))


def test_losses_basic():
    labels = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    good = torch.tensor([[0.9, 0.1], [0.1, 0.9]])
    bad = torch.tensor([[0.1, 0.9], [0.9, 0.1]])
    for name in losses.names():
        assert torch.isfinite(losses.get(name)(labels, good))
    assert losses.get("MCXENT")(labels, good) < losses.get("MCXENT")(labels, bad)
    assert losses.get("MSE")(labels, good) < losses.get("MSE")(labels, bad)


def test_fused_logits_loss_matches_unfused():
    labels = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    logits = torch.tensor([[2.0, -1.0, 0.3], [0.1, 0.2, 1.5]])
    fused = losses.logits_loss("MCXENT", labels, logits)
    unfused = losses.get("MCXENT")(labels, torch.softmax(logits, -1))
    assert torch.allclose(fused, unfused, atol=1e-4)


def test_weight_init_schemes():
    ks = rng.KeyStream(0)
    for scheme in weights.SCHEMES:
        w = weights.init_weights(ks.next(), (64, 32), scheme)
        assert w.shape == (64, 32)
        if scheme == "zero":
            assert torch.all(w == 0)
        else:
            assert torch.std(w) > 0
    wn = weights.init_weights(ks.next(), (1000, 10), "normalized")
    assert abs(float(wn.mean())) < 1e-3


# tests/test_layers.py (its three LSTM beam-search tests come with the
# char-LSTM model)

def _sgd(params, grads, lr):
    return tm.tree_map(lambda p, g: p - lr * g, params, grads)


def test_dense_forward_shapes():
    mod = L.get("dense")
    cfg = C.LayerConfig(layer_type="dense", n_in=10, n_out=5, activation="tanh")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    assert p["W"].shape == (10, 5) and p["b"].shape == (5,)
    x = torch.ones((4, 10))
    out = mod.activate(p, cfg, x)
    assert out.shape == (4, 5)
    assert torch.allclose(out, torch.tanh(x @ p["W"] + p["b"]))


def test_dense_dropout_only_in_training():
    mod = L.get("dense")
    cfg = C.LayerConfig(n_in=8, n_out=4, dropout=0.5)
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = torch.ones((2, 8))
    eval_out = mod.activate(p, cfg, x, key=rng.key_for(1), training=False)
    assert torch.allclose(eval_out, mod.activate(p, cfg, x))
    train_out = mod.activate(p, cfg, x, key=rng.key_for(1), training=True)
    assert not torch.allclose(eval_out, train_out)


def test_output_layer_gradient_improves_score():
    mod = L.get("output")
    cfg = C.LayerConfig(layer_type="output", n_in=4, n_out=3,
                        activation="softmax", loss="MCXENT")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = rng.normal(rng.key_for(42), (32, 4))
    y = torch.eye(3)[torch.from_numpy(np.random.default_rng(1).integers(0, 3, 32))]
    s0, g = mod.supervised_gradient(p, cfg, x, y)
    for _ in range(50):
        _, g = mod.supervised_gradient(p, cfg, x, y)
        p = _sgd(p, g, 0.5)
    assert mod.supervised_score(p, cfg, x, y) < s0


@pytest.mark.parametrize("visible,hidden", RBM_UNITS)
def test_rbm_unit_type_shapes(visible, hidden):
    mod = L.get("rbm")
    cfg = C.LayerConfig(layer_type="rbm", n_in=6, n_out=4,
                        visible_unit=visible, hidden_unit=hidden, k=2)
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = rng.uniform(rng.key_for(1), (8, 6))
    score, grads = mod.gradient(p, cfg, x, rng.key_for(2))
    assert torch.isfinite(score)
    assert grads["W"].shape == (6, 4)
    assert grads["b"].shape == (4,)
    assert grads["vb"].shape == (6,)
    assert mod.activate(p, cfg, x).shape == (8, 4)


_PROTOS = torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0],
                        [0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1]],
                       dtype=torch.float32)


def test_rbm_cdk_learns_mnist_like_patterns():
    """CD-1 reduces the reconstruction error on structured binary data."""
    mod = L.get("rbm")
    cfg = C.LayerConfig(layer_type="rbm", n_in=12, n_out=8, k=1, lr=0.1)
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    ks = rng.KeyStream(3)
    x = _PROTOS[torch.from_numpy(np.random.default_rng(3).integers(0, 2, 64))]
    flip = rng.bernoulli(ks.next(), 0.05, x.shape)
    x = torch.abs(x - flip.float())
    s0 = float(mod.score(p, cfg, x, ks.next()))
    for _ in range(100):
        p = _sgd(p, mod.gradient(p, cfg, x, ks.next())[1], 0.1)
    s1 = float(mod.score(p, cfg, x, ks.next()))
    assert s1 < s0 * 0.8, (s0, s1)


def test_rbm_free_energy_prefers_training_patterns():
    mod = L.get("rbm")
    cfg = C.LayerConfig(layer_type="rbm", n_in=12, n_out=8, k=1)
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = _PROTOS[torch.from_numpy(np.random.default_rng(1).integers(0, 2, 64))]
    ks = rng.KeyStream(2)
    for _ in range(150):
        p = _sgd(p, mod.gradient(p, cfg, x, ks.next())[1], 0.1)
    noise = (rng.uniform(ks.next(), (64, 12)) > 0.5).float()
    fe_data = float(mod.free_energy(p, cfg, x)) / 64
    fe_noise = float(mod.free_energy(p, cfg, noise)) / 64
    assert fe_data < fe_noise, (fe_data, fe_noise)


def test_autoencoder_denoising_learns():
    mod = L.get("autoencoder")
    cfg = C.LayerConfig(layer_type="autoencoder", n_in=10, n_out=6,
                        corruption_level=0.3)
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = (rng.uniform(rng.key_for(1), (32, 10)) > 0.5).float()
    ks = rng.KeyStream(2)
    s0 = float(mod.score(p, cfg, x, ks.next()))
    for _ in range(200):
        p = _sgd(p, mod.gradient(p, cfg, x, ks.next())[1], 0.5)
    s1 = float(mod.score(p, cfg, x, ks.next()))
    assert s1 < s0
    assert mod.encode(p, cfg, x).shape == (32, 6)
    assert mod.reconstruct(p, cfg, x).shape == x.shape


def test_conv_downsample_shapes_and_backward():
    mod = L.get("conv_downsample")
    cfg = C.LayerConfig(layer_type="conv_downsample", n_in=1,
                        num_feature_maps=4, filter_size=(5, 5),
                        stride=(2, 2), activation="relu")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = rng.normal(rng.key_for(1), (2, 1, 28, 28))  # NCHW
    out = mod.activate(p, cfg, x)
    assert out.shape == mod.output_shape(cfg, x.shape) == (2, 4, 12, 12)
    _, g = value_and_grad(lambda q: mod.activate(q, cfg, x).sum())(p)
    assert torch.all(torch.isfinite(g["convweights"]))
    assert float(g["convweights"].abs().max()) > 0


def test_lstm_forward_and_bptt():
    mod = L.get("lstm")
    v = 8
    cfg = C.LayerConfig(layer_type="lstm", n_in=v, n_out=v, activation="tanh")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    assert p["recurrentweights"].shape == (1 + v + v, 4 * v)
    x = torch.eye(v)[torch.from_numpy(np.random.default_rng(1).integers(0, v, (3, 11)))]
    assert mod.activate(p, cfg, x).shape == (3, 11, v)
    seq = torch.arange(v).repeat(3)[:17]
    xs = torch.eye(v)[seq[:-1]][None]
    ys = torch.eye(v)[seq[1:]][None]
    s0 = float(mod.supervised_score(p, cfg, xs, ys))
    for _ in range(100):
        _, g = value_and_grad(lambda q: mod.supervised_score(q, cfg, xs, ys))(p)
        p = _sgd(p, g, 1.0)
    s1 = float(mod.supervised_score(p, cfg, xs, ys))
    assert s1 < s0 * 0.5, (s0, s1)


# tests/test_gradients_determinism.py: the layer gradient checks

def _numeric_grad(f, params, eps=1e-2, sample=None, seed=0):
    """Central differences over the packed params (all of them, or a
    seeded sample of ``sample`` coordinates)."""
    flat, unravel = tm.ravel(params)
    flat = flat.double().numpy()
    idx = (np.arange(len(flat)) if sample is None
           else np.random.default_rng(seed).choice(len(flat), sample,
                                                   replace=False))
    g = np.zeros(len(idx))
    for j, i in enumerate(idx):
        up, down = flat.copy(), flat.copy()
        up[i] += eps
        down[i] -= eps
        g[j] = (float(f(unravel(torch.tensor(up, dtype=torch.float32))))
                - float(f(unravel(torch.tensor(down, dtype=torch.float32))))
                ) / (2 * eps)
    return g, idx


def _analytic(f, params):
    _, g = value_and_grad(f)(params)
    return tm.ravel(g)[0].numpy()


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
def test_dense_output_gradcheck(activation):
    mod, hmod = L.get("output"), L.get("dense")
    cfg = C.LayerConfig(layer_type="output", n_in=3, n_out=2,
                        activation="softmax", loss="MCXENT")
    hidden_cfg = C.LayerConfig(n_in=4, n_out=3, activation=activation)
    params = {"h": hmod.init(rng.key_for(0), hidden_cfg, device="cpu"),
              "o": mod.init(rng.key_for(1), cfg, device="cpu")}
    x = rng.normal(rng.key_for(2), (5, 4))
    y = torch.eye(2)[torch.tensor([0, 1, 0, 1, 1])]

    def f(p):
        return mod.supervised_score(p["o"], cfg,
                                    hmod.activate(p["h"], hidden_cfg, x), y)

    analytic = _analytic(f, params)
    numeric, _ = _numeric_grad(f, params)
    denom = np.maximum(np.abs(numeric) + np.abs(analytic), 1e-3)
    assert (np.abs(analytic - numeric) / denom).max() < 2e-2


def test_lstm_bptt_gradcheck():
    mod = L.get("lstm")
    v = 4
    cfg = C.LayerConfig(layer_type="lstm", n_in=v, n_out=v, activation="tanh")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = torch.eye(v)[torch.tensor([[0, 1, 2, 3, 1]])]
    y = torch.eye(v)[torch.tensor([[1, 2, 3, 1, 0]])]

    def f(q):
        return mod.supervised_score(q, cfg, x, y)

    numeric, idx = _numeric_grad(f, p, sample=48)
    analytic = _analytic(f, p)[idx]
    denom = np.maximum(np.abs(numeric) + np.abs(analytic), 1e-3)
    assert (np.abs(analytic - numeric) / denom).max() < 2e-2


def test_conv_gradcheck_small():
    mod = L.get("conv_downsample")
    cfg = C.LayerConfig(layer_type="conv_downsample", n_in=1,
                        num_feature_maps=2, filter_size=(3, 3),
                        stride=(2, 2), activation="tanh")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = rng.normal(rng.key_for(1), (2, 1, 8, 8))

    def f(q):
        # conv + a smooth activation (max-pool's argmax flips break
        # central differences)
        return torch.sum(torch.tanh(mod.conv(q, cfg, x)) ** 2)

    analytic = _analytic(f, p)
    numeric, _ = _numeric_grad(f, p)
    denom = np.maximum(np.abs(numeric) + np.abs(analytic), 1e-2)
    assert (np.abs(analytic - numeric) / denom).max() < 3e-2


def test_dropconnect_masks_weights():
    mod = L.get("dense")
    cfg = C.LayerConfig(n_in=6, n_out=4, dropout=0.5, use_drop_connect=True,
                        activation="linear")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    x = torch.ones((3, 6))
    eval_out = mod.activate(p, cfg, x)
    train1 = mod.activate(p, cfg, x, key=rng.key_for(1), training=True)
    train2 = mod.activate(p, cfg, x, key=rng.key_for(2), training=True)
    assert not torch.allclose(train1, eval_out)
    assert not torch.allclose(train1, train2)


def test_precision_scopes_tf32_to_the_call():
    """The layers run cuDNN and cuBLAS with the policy's TF32 switch and
    deterministic cuDNN, and leave the caller's process-wide settings as
    they found them."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (mm.allow_tf32, dnn.allow_tf32, dnn.deterministic)
    seen = []
    mod = L.get("conv_downsample")
    cfg = C.LayerConfig(layer_type="conv_downsample", n_in=1,
                        num_feature_maps=2, filter_size=(3, 3),
                        stride=(2, 2), activation="tanh")
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    real = torch.nn.functional.conv2d
    try:
        dnn.allow_tf32, dnn.deterministic = True, False

        def spy(*a, **kw):
            seen.append((mm.allow_tf32, dnn.allow_tf32, dnn.deterministic))
            return real(*a, **kw)

        torch.nn.functional.conv2d = spy
        mod.activate(p, cfg, torch.zeros((1, 1, 8, 8)))
        with dtypes.policy(dtypes.Policy(allow_tf32=True)):
            mod.activate(p, cfg, torch.zeros((1, 1, 8, 8)))
        assert seen == [(False, False, True), (True, True, True)]
        assert (dnn.allow_tf32, dnn.deterministic) == (True, False)
    finally:
        torch.nn.functional.conv2d = real
        mm.allow_tf32, dnn.allow_tf32, dnn.deterministic = prev


@pytest.mark.parametrize("draw", ["bits", "uniform", "bernoulli", "normal"])
def test_batch_rows_draws_are_rows_of_the_whole_batch_draw(draw):
    """Under ``rng.batch_rows(first, total)`` a batch draw (``batch=True``)
    is rows ``first..`` of the same draw over all ``total`` rows; a draw
    not over a batch (a weight mask) is left as it is."""
    key, shape = rng.key_for(4), (12, 5, 3)
    p = torch.linspace(0.0, 1.0, 5 * 3).reshape(5, 3)

    def run(rows, batch):
        if draw == "bits":
            return rng.random_bits(key, (rows, 5, 3), batch=batch)
        if draw == "uniform":
            return rng.uniform(key, (rows, 5, 3), -2.0, 3.0, batch=batch)
        if draw == "bernoulli":
            return rng.bernoulli(key, p.expand(rows, 5, 3), batch=batch)
        return rng.normal(key, (rows, 5, 3), batch=batch)

    whole = run(shape[0], True)
    for first, rows in ((0, 4), (4, 4), (8, 4), (3, 7)):
        with rng.batch_rows(first, shape[0]):
            assert torch.equal(run(rows, True), whole[first:first + rows])
            assert torch.equal(run(rows, False), whole[:rows])
    with rng.batch_rows(10, shape[0]), pytest.raises(ValueError):
        run(4, True)


def test_conv_dropout_is_the_reference_mask():
    """A conv layer's input dropout is the reference's mask over its NHWC
    block (C > 1, where NCHW's element order differs)."""
    jcfg = JC.LayerConfig(layer_type="conv_downsample", n_in=3,
                          num_feature_maps=4, filter_size=(3, 3),
                          stride=(2, 2), activation="tanh", dropout=0.5)
    cfg = C.LayerConfig(layer_type="conv_downsample", n_in=3,
                        num_feature_maps=4, filter_size=(3, 3),
                        stride=(2, 2), activation="tanh", dropout=0.5)
    jp = JL.get("conv_downsample").init(jax.random.key(0), jcfg)
    x = np.random.default_rng(0).standard_normal((2, 9, 9, 3)).astype(
        np.float32)
    want = np.asarray(JL.get("conv_downsample").activate(
        jp, jcfg, jnp.asarray(x), key=jax.random.key(7), training=True))
    got = L.get("conv_downsample").activate(
        _carry(jp), cfg, _t(x).permute(0, 3, 1, 2), key=rng.key_for(7),
        training=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=OUT_ATOL)
