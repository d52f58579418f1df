"""The port's RNTN held against the JAX package's on the CPU: the initial
tables from the reference's keys, the packing of trees into node tables,
the first step's loss and gradients (``jax.grad`` of the reference's
vmapped loss), the parameters after one AdaGrad step, the losses of a few
epochs, the untied per-production tables and their growth, node
predictions and ``RNTNEval``; then the reference's behavioural tests
(tests/test_rntn_utils.py, tests/test_nlp.py) on the port.

Tolerances (the first AdaGrad step is sign-like, ``lr * g / (|g| + 1e-8)``,
so an entry whose gradient is near 0 may move by up to ``lr`` either way
on a last-bit difference of ``g``): ``GRAD_RTOL`` of each leaf's largest
|g|; ``LOSS_RTOL`` for the first loss, ``EPOCH_RTOL`` for the losses of
later epochs; ``STEP_ATOL`` for the parameters after one step on the
entries whose reference |g| exceeds ``SMALL_G`` of the leaf's largest, the
rest counted and bounded by ``lr``.
"""

import copy

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import rntn as pr
from deeplearning4j_tpu_torch.nlp import parser as pparser
from deeplearning4j_tpu_torch.nlp.tree import binarize, right_branching_tree

torch.set_num_threads(1)

GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
EPOCH_RTOL = 1e-4
STEP_ATOL = 1e-5
SMALL_G = 1e-4
#: rng.normal vs jax.random.normal in ulps (XLA's log1p and PyTorch's
#: differ in the last bits; the uniform draws are bitwise)
NORMAL_ULPS = 3


@pytest.fixture
def ref():
    jax = pytest.importorskip("jax")
    from types import SimpleNamespace

    from deeplearning4j_tpu.models import rntn
    from deeplearning4j_tpu.nlp import parser, tree

    return SimpleNamespace(jax=jax, jnp=jax.numpy, rntn=rntn, parser=parser,
                           tree=tree)


def _sentiment_trees(tree_mod, n=60, seed=0):
    """The reference test's task: label 1 trees hold 'good'-like words,
    label 0 'bad'-like ones; every node carries the root's label."""
    rng = np.random.default_rng(seed)
    pos_words = ["good", "great", "fine", "nice"]
    neg_words = ["bad", "awful", "poor", "sad"]
    fill = ["movie", "film", "plot", "was", "the"]
    trees = []
    for _ in range(n):
        pos = rng.random() < 0.5
        words = list(rng.choice(pos_words if pos else neg_words, 2)) + list(
            rng.choice(fill, 2))
        rng.shuffle(words)
        t = tree_mod.binarize(tree_mod.right_branching_tree(
            words, label="1" if pos else "0"))
        for node in t.subtrees():
            node.label = t.label
        trees.append(t)
    return trees


class _PortTrees:
    binarize = staticmethod(binarize)
    right_branching_tree = staticmethod(right_branching_tree)


def _relabeled(parser_mod, tree_mod, rntn_mod, n):
    """The bundled treebank's first ``n`` trees, binarized, each node
    relabelled by its category's index (the reference's untied-table
    test)."""
    trees = [tree_mod.binarize(t) for t in parser_mod.bundled_treebank()[:n]]
    cats = sorted({rntn_mod.basic_category(x.label, False)
                   for t in trees for x in t.subtrees()})
    cat_id = {c: i for i, c in enumerate(cats)}

    def relabel(t):
        cat = rntn_mod.basic_category(t.label, False)
        for c in t.children:
            relabel(c)
        t.label = str(cat_id[cat])

    out = [copy.deepcopy(t) for t in trees]
    for t in out:
        relabel(t)
    return out, len(cats)


SIMPLE = dict(num_classes=2, dim=8, lr=0.1, seed=1, max_nodes=16)
UNTIED = dict(dim=6, lr=0.1, seed=3, max_nodes=40, simplified_model=False,
              combine_classification=False, batch_size=10)


@pytest.fixture(scope="module")
def built():
    """Per case, built once for the module (the reference's programs
    compile per model): the port's and the reference's trees, the
    reference model with its vocabulary, productions and tables, and its
    initial tables as numpy."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.models import rntn
    from deeplearning4j_tpu.nlp import parser, tree

    out = {}
    for case in ("simplified", "untied"):
        if case == "simplified":
            kw = SIMPLE
            pt, jt = _sentiment_trees(_PortTrees, 30), _sentiment_trees(tree,
                                                                        30)
        else:
            pt, nc = _relabeled(pparser, _PortTrees, pr, 20)
            jt, _ = _relabeled(parser, tree, rntn, 20)
            kw = dict(UNTIED, num_classes=nc)
        r = rntn.RNTN(**kw)
        r.cache.fit([t.words() for t in jt])
        r.discover_productions(jt)
        r.init_params()
        init = {k: np.asarray(v) for k, v in r.params.items()}
        out[case] = (kw, pt, jt, r, init, jax)
    return out


def _models(ref, built, case):
    """(port model, reference model, port trees, reference trees): the
    port's vocabulary, productions and tables initialized, the reference
    model back at its initial tables."""
    kw, pt, jt, r, init, jax = built[case]
    r.params = {k: ref.jnp.asarray(v) for k, v in init.items()}
    r._adagrad = jax.tree.map(ref.jnp.zeros_like, r.params)
    p = pr.RNTN(device="cpu", **kw)
    p.cache.fit([t.words() for t in pt])
    p.discover_productions(pt)
    p.init_params()
    return p, r, pt, jt


def _ulps(a, b):
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("case", ["simplified", "untied"])
def test_initial_tables_are_the_reference_draws(ref, built, case):
    """W, V, Wc, Wc_bin and Wc_un bit for bit (uniforms from
    ``split(key(seed), 6)``), the embeddings within NORMAL_ULPS."""
    p, r, _, _ = _models(ref, built, case)
    assert sorted(p.params) == sorted(r.params)
    for k, v in r.params.items():
        a, b = p.params[k].numpy(), np.asarray(v)
        if k == "emb":
            assert _ulps(a, b) <= NORMAL_ULPS
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert not p._adagrad[k].any()
    assert p.prod_index == r.prod_index and p.unary_index == r.unary_index


def test_untensored_v_is_zero(ref):
    p = pr.RNTN(device="cpu", dim=4, use_tensor=False)
    p.init_params()
    r = ref.rntn.RNTN(dim=4, use_tensor=False)
    r.init_params()
    assert not p.params["V"].any()
    np.testing.assert_array_equal(p.params["W"].numpy(),
                                  np.asarray(r.params["W"]))


def test_packing_matches_reference(ref, built):
    """topo_pack, the untied packing and the padding equal the
    reference's, children before parents."""
    p, r, pt, jt = _models(ref, built, "untied")
    for a, b in zip(pt, jt):
        for x, y in zip(pr.topo_pack(a, p.cache, 4),
                        ref.rntn.topo_pack(b, r.cache, 4)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(p._pack_padded(a), r._pack_padded(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        words, left, right, leaf, _ = pr.topo_pack(a, p.cache, 4)
        inner = leaf == 0
        assert (left[inner] < np.arange(len(words))[inner]).all()
    with pytest.raises(ValueError, match="max_nodes"):
        pr.RNTN(device="cpu", max_nodes=2)._pad(
            pr._pack_full(pt[0], p.cache, 4))


def _first_batch(ref, p, r, jt, bs):
    cols = [np.stack(c) for c in zip(*[r._pack_padded(t) for t in jt[:bs]])]
    w = np.ones(bs, np.float32)
    w[-1] = 0.0  # a padding repeat, weight 0

    def mean_loss(params):
        per_tree, _ = ref.jax.vmap(lambda *a: r._tree_loss(params, *a))(
            *[ref.jnp.asarray(c) for c in cols])
        return ref.jnp.sum(per_tree * w) / ref.jnp.maximum(ref.jnp.sum(w),
                                                           1.0)

    return cols, w, mean_loss


@pytest.mark.parametrize("case", ["simplified", "untied"])
def test_first_step_loss_gradients_and_params(ref, built, case):
    """The first batch's loss within LOSS_RTOL and every gradient leaf
    within GRAD_RTOL of its largest |g| (``jax.grad`` of the reference's
    loss, from the same tables); the parameters after the AdaGrad step
    within STEP_ATOL where the reference |g| exceeds SMALL_G of the leaf's
    largest, and the others (counted) within the step's bound ``lr``."""
    p, r, _, jt = _models(ref, built, case)
    p.params = pr.params_from_jax({k: np.asarray(v)
                                   for k, v in r.params.items()}, "cpu")
    bs = 8
    cols, w, mean_loss = _first_batch(ref, p, r, jt, bs)
    loss_ref, g_ref = ref.jax.value_and_grad(mean_loss)(r.params)
    batch = p._upload(cols)
    loss, grads = p._batch_loss_and_grads(p.params, batch, torch.tensor(w))
    assert float(loss) == pytest.approx(float(loss_ref), rel=LOSS_RTOL)
    for k, g in g_ref.items():
        g = np.asarray(g)
        top = np.abs(g).max()
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * top, err_msg=k)
    lr = np.float32(p.lr)
    new_ref, _, _ = r._batch_step(r.params, r._adagrad, tuple(
        ref.jnp.asarray(c) for c in cols), ref.jnp.asarray(w), lr)
    new, _, _ = p._batch_step(p.params, p._adagrad, batch, torch.tensor(w),
                              float(lr))
    small = total = 0
    for k, g in g_ref.items():
        g = np.abs(np.asarray(g))
        big = g > SMALL_G * max(g.max(), 1e-30)
        a, b = new[k].numpy(), np.asarray(new_ref[k])
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=STEP_ATOL,
                                   err_msg=k)
        assert (np.abs(a[~big] - b[~big]) <= 2 * lr).all(), k
        small += int((np.abs(a[~big] - b[~big]) > STEP_ATOL).sum())
        total += g.size
    # the sign-like entries that moved apart are few
    assert small <= 0.01 * total, (small, total)


@pytest.mark.parametrize("case", ["simplified", "untied"])
def test_epoch_losses_match_reference(ref, built, case):
    p, r, pt, jt = _models(ref, built, case)
    p.params = pr.params_from_jax({k: np.asarray(v)
                                   for k, v in r.params.items()}, "cpu")
    bs = 8 if case == "simplified" else 10
    got = p.fit_trees(pt, epochs=3, batch_size=bs)
    want = r.fit_trees(jt, epochs=3, batch_size=bs)
    np.testing.assert_allclose(got, want, rtol=EPOCH_RTOL)
    assert got[-1] < got[0]


def test_params_round_trip():
    p = pr.RNTN(device="cpu", dim=3, num_classes=2)
    p.init_params()
    back = pr.params_from_jax(pr.params_to_jax(p.params), "cpu")
    for k in p.params:
        assert torch.equal(back[k], p.params[k])


def test_grow_tables_matches_reference(ref, built):
    """A second fit on trees with new categories grows the untied tables:
    trained slots kept, new slots the reference's draws from
    ``key(seed + 1)``, fresh AdaGrad history."""
    p, r, pt, jt = _models(ref, built, "untied")
    p.params = pr.params_from_jax({k: np.asarray(v)
                                   for k, v in r.params.items()}, "cpu")
    p._adagrad = pr.params_from_jax({k: np.asarray(v) + 1.0
                                     for k, v in r._adagrad.items()}, "cpu")
    r._adagrad = {k: v + 1.0 for k, v in r._adagrad.items()}
    before = {k: v.clone() for k, v in p.params.items()}
    more_p, _ = _relabeled(pparser, _PortTrees, pr, 60)
    more_j, _ = _relabeled(ref.parser, ref.tree, ref.rntn, 60)
    for m, trees in ((p, more_p), (r, more_j)):
        # new labels past the first model's classes become new categories
        for t in trees:
            for x in t.subtrees():
                x.label = "X" + x.label
        m.discover_productions(trees)
        m._grow_tables()
    assert len(p.prod_index) > before["W"].shape[0]
    for k, v in r.params.items():
        a, b = p.params[k].numpy(), np.asarray(v)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        n0 = before[k].shape[0]
        assert torch.equal(p.params[k][:n0], before[k])
        np.testing.assert_array_equal(p._adagrad[k].numpy(),
                                      np.asarray(r._adagrad[k]))
        assert not p._adagrad[k][n0:].any()


def test_predict_nodes_and_eval_match_reference(ref, built):
    p, r, pt, jt = _models(ref, built, "simplified")
    r.fit_trees(jt, epochs=2)
    p.params = pr.params_from_jax({k: np.asarray(v)
                                   for k, v in r.params.items()}, "cpu")
    pt, jt = pt[:6], jt[:6]
    for a, b in zip(pt, jt):
        np.testing.assert_array_equal(p.predict_nodes(a), r.predict_nodes(b))
        assert p.predict_root(a) == r.predict_root(b)
    ev, rev = pr.RNTNEval(), ref.rntn.RNTNEval()
    ev.eval(p, pt)
    rev.eval(r, jt)
    assert (ev.correct, ev.total) == (rev.correct, rev.total)
    assert pr.RNTNEval().accuracy() == 0.0


def test_predict_ties_go_to_the_lowest_class():
    """Equal logits everywhere (zero classifier): every node predicts class
    0, as ``jnp.argmax``."""
    p = pr.RNTN(device="cpu", num_classes=3, dim=4, max_nodes=8)
    t = binarize(right_branching_tree(["a", "b", "c"], label="2"))
    p.cache.fit([t.words()])
    p.init_params()
    p.params["Wc"] = torch.zeros_like(p.params["Wc"])
    assert not p.predict_nodes(t).any()


def test_basic_category():
    assert pr.basic_category("NP-SBJ=2", simplified=False) == "NP"
    assert pr.basic_category("@VP", simplified=False) == "VP"
    assert pr.basic_category("NP") == ""


# -- the reference's behavioural tests, on the port ----------------------------

def test_rntn_learns_sentiment():
    trees = _sentiment_trees(_PortTrees)
    model = pr.RNTN(num_classes=2, dim=8, lr=0.1, seed=1, max_nodes=16,
                    device="cpu")
    losses = model.fit_trees(trees, epochs=6)
    assert losses[-1] < losses[0]
    ev = pr.RNTNEval()
    ev.eval(model, trees)
    assert ev.accuracy() > 0.85, ev.accuracy()


def test_rntn_per_label_tables_on_treebank():
    trees, n_cats = _relabeled(pparser, _PortTrees, pr, 40)
    assert n_cats >= 10
    model = pr.RNTN(num_classes=n_cats, dim=12, lr=0.1, seed=3, max_nodes=32,
                    simplified_model=False, combine_classification=False,
                    batch_size=10, device="cpu")
    losses = model.fit_trees(trees, epochs=14)
    assert len(model.prod_index) > 5
    assert model.params["W"].shape[0] == len(model.prod_index)
    assert model.params["Wc_un"].shape[0] == len(model.unary_index)
    assert losses[-1] < losses[0] / 10
    correct = total = 0
    for t in trees:
        gold = pr._pack_full(t, model.cache, model.num_classes,
                             model.prod_index, model.unary_index,
                             False)["labels"]
        pred = model.predict_nodes(t)
        correct += int((pred == gold).sum())
        total += len(gold)
    assert correct / total > 0.9, correct / total


def test_rntn_refit_grows_per_label_tables():
    """tests/test_nlp.py's refit case: a second fit_trees with new
    categories grows the tables and keeps training."""
    from deeplearning4j_tpu_torch.nlp.tree import parse_ptb

    t1 = parse_ptb("(S (NP (DT the) (NN cat)) (VP (VBD sat)))")
    t2 = parse_ptb("(S (NP (DT a) (NN dog)) (VP (VBD ran) (PP (IN in) "
                   "(NP (DT the) (NN park)))))")
    model = pr.RNTN(num_classes=3, dim=6, seed=0, max_nodes=32,
                    simplified_model=False, combine_classification=False,
                    device="cpu")
    model.fit_trees([binarize(t1)], epochs=1)
    n_prod = model.params["W"].shape[0]
    model.fit_trees([binarize(t2)], epochs=1)
    assert model.params["W"].shape[0] == len(model.prod_index) > n_prod
    assert model.params["Wc_un"].shape[0] == len(model.unary_index)
    assert all(torch.isfinite(v).all() for v in model.params.values())


@pytest.mark.cuda
def test_first_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trees = _sentiment_trees(_PortTrees, 16)
    out = []
    for dev in ("cpu", "cuda"):
        m = pr.RNTN(device=dev, **SIMPLE)
        out.append(m.fit_trees(trees, epochs=1))
    assert out[0] == pytest.approx(out[1], rel=LOSS_RTOL)
