"""The port's ``MultiLayerNetwork`` and LeNet held against the JAX
package's on the CPU, from the reference's own params carried over
(``params_from_jax``): LeNet's forward, loss and gradients, the conv ->
dense flatten order, a backprop fit iteration by iteration, DBN
pretraining on the reference's keys, the packed vector, merge, and serde
and checkpoints across the packages; then the reference's behavioural
tests (``tests/test_multilayer.py``, the determinism test of
``tests/test_gradients_determinism.py``) on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.models import lenet as jlenet
from deeplearning4j_tpu.models.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.optimize.api import ScoreIterationListener as JListener
from deeplearning4j_tpu.parallel import checkpoint as jckpt
from deeplearning4j_tpu_torch.datasets import ListDataSetIterator, fetchers
from deeplearning4j_tpu_torch.evaluation import Evaluation
from deeplearning4j_tpu_torch.models import lenet, multilayer
from deeplearning4j_tpu_torch.models.multilayer import (
    MultiLayerNetwork,
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad
from deeplearning4j_tpu_torch.optimize.api import ScoreIterationListener
from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.parallel.checkpoint import restore as trestore

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

#: f32 outputs and losses, port vs reference
OUT_ATOL = 1e-5
#: f32 gradients: |g - g_ref| <= GRAD_RTOL * max|g_ref|, leaf by leaf
GRAD_RTOL = 1e-4
#: per-iteration scores of a fit: rel
SCORE_RTOL = 1e-4


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _lenet_pair(seed=0):
    jnet, jparams = jlenet.build_lenet(seed)
    net, params = lenet.build_lenet(seed, device="cpu")
    return jnet, jparams, net, params


def _batch(n=8, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.random((n, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rs.integers(0, 10, n)]
    return x, y


# -- LeNet --------------------------------------------------------------------

def test_lenet_init_forward_loss_and_gradients_match_the_reference():
    jnet, jparams, net, params = _lenet_pair(0)
    # the same seed gives the reference's weights bit for bit
    for got, ref in zip(params_to_jax(params, net.conf), _np(jparams)):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # from here on, the reference's params carried over
    params = params_from_jax(_np(jparams), net.conf, device="cpu")
    x, y = _batch()
    np.testing.assert_allclose(
        lenet.lenet_apply(net)(params, torch.from_numpy(x)).numpy(),
        np.asarray(jlenet.lenet_apply(jnet)(jparams, jnp.asarray(x))),
        rtol=0, atol=OUT_ATOL)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jlenet.lenet_loss(jnet)))(
        jparams, jnp.asarray(x), jnp.asarray(y))
    loss, grads = value_and_grad(lenet.lenet_loss(net))(
        params, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(loss.item() - float(ref_loss)) <= OUT_ATOL
    for got, ref in zip(params_to_jax(grads, net.conf), _np(ref_grads)):
        for k in ref:
            err = np.abs(got[k] - ref[k]).max()
            assert err <= GRAD_RTOL * np.abs(ref[k]).max(), (k, err)


def test_conv_to_dense_flatten_order_is_the_reference(monkeypatch):
    """A conv block reaches the first dense layer flattened in the
    reference's H, W, C order: with the reference's dense weights carried
    over, LeNet's probabilities are the reference's; flattening the NCHW
    block as it lies (C, H, W) permutes the dense layer's 256 inputs and
    leaves them far off (this test sees that)."""
    jnet, jparams, net, _ = _lenet_pair(1)
    params = params_from_jax(_np(jparams), net.conf, device="cpu")
    x, _ = _batch(16, seed=3)
    ref = np.asarray(jnet.output(x))
    np.testing.assert_allclose(net.output(x).numpy(), ref, rtol=0,
                               atol=OUT_ATOL)
    # the second conv block as the reference flattens it, element for
    # element: (B, 4, 4, 16) NHWC
    jblock = np.asarray(jnet.feed_forward_fn(jparams, jnp.asarray(x),
                                             upto=2)[-1])
    block = net.feed_forward_fn(params, torch.from_numpy(x), upto=2)[-1]
    assert block.shape == (16, 16, 4, 4)  # NCHW in the port
    np.testing.assert_allclose(
        multilayer._adapt_input(block, "dense", 0).numpy(),
        jblock.reshape(16, -1), rtol=0, atol=OUT_ATOL)
    real = multilayer._adapt_input

    def naive(x, layer_type, channels):
        if layer_type == "dense" and x.ndim == 4:
            return x.reshape(x.shape[0], -1)  # C, H, W order
        return real(x, layer_type, channels)

    monkeypatch.setattr(multilayer, "_adapt_input", naive)
    assert np.abs(net.output(x).numpy() - ref).max() > 1e-3


# -- fits ---------------------------------------------------------------------

def _iris():
    ds = jfetchers.iris().normalize_zero_mean_unit_variance()
    return ds.split_test_and_train(110)


def _mlp_config(mod, n_in, n_out, hidden, **kw):
    base = mod.LayerConfig(
        activation="tanh", lr=kw.pop("lr", 0.1),
        num_iterations=kw.pop("num_iterations", 100),
        optimization_algo=kw.pop("optimization_algo",
                                 C.OptimizationAlgorithm.CONJUGATE_GRADIENT),
        use_adagrad=True, momentum=0.5, weight_init="vi")
    return mod.list_builder(base, sizes=hidden, n_in=n_in, n_out=n_out,
                            hidden_layer_type=kw.pop("hidden_layer_type",
                                                     "dense"), **kw)


@pytest.mark.parametrize("algo", [C.OptimizationAlgorithm.CONJUGATE_GRADIENT,
                                  C.OptimizationAlgorithm.HESSIAN_FREE])
def test_backprop_fit_matches_the_reference_iteration_by_iteration(algo):
    """A full-backprop MLP fit on Iris (CG, and Hessian-free through the
    forward/loss split): the listeners' scores over 10 iterations, then
    the params."""
    train, _ = _iris()
    jmc = _mlp_config(JC, 4, 3, [8], num_iterations=10, optimization_algo=algo)
    jmc.pretrain, jmc.backward = False, True
    mc = C.MultiLayerConfig.from_json(jmc.to_json())
    jnet = JNet(jmc, seed=42)
    jnet.init()
    net = MultiLayerNetwork(mc, seed=42, device="cpu")
    net.init()
    np.testing.assert_array_equal(net.params_vector(), np.asarray(
        jax.flatten_util.ravel_pytree(jnet.params)[0]))
    jl, tl = JListener(1000), ScoreIterationListener(1000)
    jnet.set_listeners([jl])
    net.set_listeners([tl])
    jnet.fit_dataset(train)
    net.fit_dataset(_to_port(train))
    assert len(tl.history) == len(jl.history) > 1
    np.testing.assert_allclose(tl.history, jl.history, rtol=SCORE_RTOL)
    ref = np.asarray(jax.flatten_util.ravel_pytree(jnet.params)[0])
    got = net.params_vector()
    assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref)


def _to_port(ds):
    from deeplearning4j_tpu_torch.datasets import DataSet

    return DataSet(ds.features, ds.labels)


def test_dbn_pretraining_matches_the_reference():
    """CD-1 pretraining of a two-RBM stack on the reference's key stream:
    every sample equal (no near-ties at this seed), so the pretrained
    params agree within f32 rounding carried through 20 updates."""
    train, _ = _iris()
    jbase = JC.LayerConfig(
        layer_type="rbm", activation="tanh",
        visible_unit=C.VisibleUnit.GAUSSIAN, hidden_unit=C.HiddenUnit.BINARY,
        lr=0.05, k=1, num_iterations=20)
    jmc = JC.list_builder(jbase, sizes=[6, 4], n_in=4, n_out=3,
                          hidden_layer_type="rbm")
    mc = C.MultiLayerConfig.from_json(jmc.to_json())
    jnet = JNet(jmc, seed=7)
    jnet.init()
    net = MultiLayerNetwork(mc, seed=7, device="cpu")
    net.init()
    from deeplearning4j_tpu.datasets import ListDataSetIterator as JIter

    jnet.pretrain(JIter(train, 110))
    net.pretrain(ListDataSetIterator(_to_port(train), 110))
    for got, ref in zip(params_to_jax(net.params, mc), _np(jnet.params)):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4,
                                       err_msg=k)


# -- the packed vector, merge, serde and checkpoints across the packages -----

def test_params_vector_merge_and_serde_interchange():
    jnet, jparams, net, _ = _lenet_pair(2)
    net.params = params_from_jax(_np(jparams), net.conf, device="cpu")
    vec = net.params_vector()
    np.testing.assert_array_equal(vec, np.asarray(jnet.params_vector()))
    # the port reads the reference's blob and the reference the port's
    net2 = MultiLayerNetwork.from_bytes(jnet.to_bytes(), device="cpu")
    np.testing.assert_array_equal(net2.params_vector(), vec)
    jnet2 = JNet.from_bytes(net.to_bytes())
    np.testing.assert_array_equal(np.asarray(jnet2.params_vector()), vec)
    assert jnet2.conf.to_json() == net.conf.to_json()
    # set_params_vector and merge in the reference's layout
    _, jp3 = jlenet.build_lenet(3)
    jnet3 = JNet(jnet.conf)
    jnet3.params = jp3
    net3 = MultiLayerNetwork(net.conf, device="cpu")
    net3.set_params_vector(np.asarray(jnet3.params_vector()))
    np.testing.assert_array_equal(net3.params_vector(),
                                  np.asarray(jnet3.params_vector()))
    jnet3.merge([jnet])
    net3.merge([net])
    np.testing.assert_array_equal(net3.params_vector(),
                                  np.asarray(jnet3.params_vector()))


def test_npz_checkpoints_cross_the_packages(tmp_path):
    jnet, jparams, net, _ = _lenet_pair(4)
    net.params = params_from_jax(_np(jparams), net.conf, device="cpu")
    # the port writes, the reference restores into its own tree
    CheckpointManager(tmp_path / "port").maybe_save(
        3, net.checkpoint_tree(), {"loss": 1.5})
    got, meta = jckpt.restore(tmp_path / "port" / "ckpt_3.npz", jparams)
    assert meta == {"loss": 1.5, "step": 3}
    for g, r in zip(_np(got), _np(jparams)):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])
    # the reference writes, the port restores into a fresh network
    jckpt.CheckpointManager(tmp_path / "ref").maybe_save(5, jparams)
    like = net.checkpoint_tree()
    tree, meta = trestore(tmp_path / "ref" / "ckpt_5.npz", like, device="cpu")
    fresh = MultiLayerNetwork(net.conf, device="cpu")
    fresh.params = fresh.from_checkpoint_tree(tree)
    np.testing.assert_array_equal(fresh.params_vector(), net.params_vector())


# -- the reference's behavioural tests on the port (tests/test_multilayer.py)

def test_evaluation_metrics_math():
    ev = Evaluation(3)
    ev.eval(np.array([0, 0, 1, 1, 2, 2]), np.array([0, 1, 1, 1, 2, 0]))
    assert ev.accuracy() == pytest.approx(4 / 6)
    assert ev.recall(0) == pytest.approx(0.5)
    assert ev.recall(1) == pytest.approx(1.0)
    assert ev.precision(1) == pytest.approx(2 / 3)
    assert 0 < ev.f1() <= 1
    assert "Accuracy" in ev.stats()


def test_evaluation_stats_per_class_report():
    ev = Evaluation(3)
    labels = np.array([0] * 8 + [1] * 4 + [2] * 2)
    preds = np.array([0, 0, 0, 0, 0, 0, 1, 2, 1, 1, 0, 0, 2, 0])
    ev.eval(labels, preds)
    s = ev.stats()
    assert "Actual Class 0 was predicted with Predicted 0 with count 6 times" in s
    assert "Actual Class 1 was predicted with Predicted 0 with count 2 times" in s
    assert "Actual Class 1 was predicted with Predicted 2" not in s
    assert ev.false_positives(0) == 3 and ev.false_negatives(0) == 2
    row0 = next(ln for ln in s.splitlines() if ln.strip().startswith("0 "))
    assert "     0     6     3     2        8" in row0
    assert f"{6/9:.4f}" in row0 and f"{6/8:.4f}" in row0
    row2 = next(ln for ln in s.splitlines() if ln.strip().startswith("2 "))
    assert "0.5000" in row2
    assert "Accuracy" in s and "F1 Score" in s


def _port_iris():
    ds = fetchers.iris().normalize_zero_mean_unit_variance()
    return ds.split_test_and_train(110)


def test_mlp_backprop_iris():
    train, test = _port_iris()
    mc = _mlp_config(C, 4, 3, [8], num_iterations=200)
    mc.pretrain, mc.backward = False, True
    net = MultiLayerNetwork(mc, seed=42, device="cpu")
    net.init()
    net.fit_dataset(train)
    ev = Evaluation(3)
    ev.eval(test.labels, net.output(test.features).numpy())
    assert ev.f1() > 0.85, ev.stats()


def test_dbn_pretrain_finetune_iris():
    train, test = _port_iris()
    base = C.LayerConfig(
        layer_type="rbm", activation="tanh",
        visible_unit=C.VisibleUnit.GAUSSIAN, hidden_unit=C.HiddenUnit.BINARY,
        lr=0.05, k=1, num_iterations=100,
        optimization_algo=C.OptimizationAlgorithm.CONJUGATE_GRADIENT)
    mc = C.list_builder(base, sizes=[6, 4], n_in=4, n_out=3,
                        hidden_layer_type="rbm")
    mc.backward = True
    net = MultiLayerNetwork(mc, seed=7, device="cpu")
    net.init()
    net.fit(ListDataSetIterator(train, 110))
    ev = Evaluation(3)
    ev.eval(test.labels, net.output(test.features).numpy())
    assert ev.accuracy() > 0.85, ev.stats()


def test_autoencoder_stack_pretrain():
    ds = fetchers.mnist(n=256).binarize()
    base = C.LayerConfig(
        layer_type="autoencoder", activation="sigmoid", corruption_level=0.3,
        lr=0.1, num_iterations=30,
        optimization_algo=C.OptimizationAlgorithm.GRADIENT_DESCENT)
    mc = C.list_builder(base, sizes=[64], n_in=784, n_out=10,
                        hidden_layer_type="autoencoder")
    net = MultiLayerNetwork(mc, seed=0, device="cpu")
    net.init()
    net.pretrain(ListDataSetIterator(ds, 128))
    recon = net.reconstruct(ds.features[:32], 1).numpy()
    assert recon.shape == (32, 784)
    err = float(((recon - ds.features[:32]) ** 2).mean())
    assert err < 0.25, err


def test_params_vector_roundtrip_and_merge():
    mc = _mlp_config(C, 4, 3, [5], num_iterations=5)
    net = MultiLayerNetwork(mc, seed=1, device="cpu")
    net.init()
    vec = net.params_vector()
    net2 = MultiLayerNetwork(mc, seed=2, device="cpu")
    net2.init()
    assert not np.allclose(vec, net2.params_vector())
    net2.set_params_vector(vec)
    assert np.allclose(vec, net2.params_vector())
    net3 = MultiLayerNetwork(mc, seed=3, device="cpu")
    net3.init()
    v3 = net3.params_vector()
    net3.merge([net2])
    assert np.allclose(net3.params_vector(), (v3 + vec) / 2, atol=1e-6)


def test_serde_roundtrip():
    mc = _mlp_config(C, 4, 3, [5], num_iterations=5)
    net = MultiLayerNetwork(mc, seed=1, device="cpu")
    net.init()
    net2 = MultiLayerNetwork.from_bytes(net.to_bytes(), device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    assert torch.allclose(net.output(x), net2.output(x), atol=1e-6)


def test_conv_network_lenet_style():
    """Conv + pool -> dense -> softmax on synthetic MNIST, trained."""
    ds = fetchers.mnist(n=512)
    train, test = ds.split_test_and_train(448)
    confs = [
        C.LayerConfig(layer_type="conv_downsample", n_in=1,
                      num_feature_maps=8, filter_size=(5, 5), stride=(2, 2),
                      activation="relu"),
        C.LayerConfig(layer_type="dense", n_in=8 * 12 * 12, n_out=64,
                      activation="relu"),
        C.LayerConfig(layer_type="output", n_in=64, n_out=10,
                      activation="softmax", loss="MCXENT", lr=0.05,
                      num_iterations=100, use_adagrad=True,
                      optimization_algo=C.OptimizationAlgorithm.GRADIENT_DESCENT),
    ]
    mc = C.MultiLayerConfig(confs=confs, pretrain=False, backward=True)
    net = MultiLayerNetwork(mc, seed=5, device="cpu")
    net.init()
    net.fit_dataset(train)
    ev = Evaluation(10)
    ev.eval(test.labels, net.output(test.features).numpy())
    assert ev.accuracy() > 0.8, ev.stats()


def test_training_is_deterministic_by_seed():
    train, _ = _port_iris()

    def run():
        mc = C.list_builder(C.LayerConfig(activation="tanh", num_iterations=30),
                            sizes=[5], n_in=4, n_out=3, pretrain=False,
                            backward=True)
        net = MultiLayerNetwork(mc, seed=99, device="cpu")
        net.init()
        net.fit_dataset(train)
        return net.params_vector()

    assert np.array_equal(run(), run())
