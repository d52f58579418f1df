"""The port's Word2Vec and ParagraphVectors held against the JAX package's
on the CPU: one HS and one NS batch update (saturated dots planted), the
HS scan, whole fits from the same carried-over tables (HS, HS+NS, several
epochs with a carried tail, subsampling, NS alone), the label pass of
ParagraphVectors, and the WordVectors queries; then the reference's
behavioural tests re-run on the port.

The reference draws its initial tables from ``jax.random``, which the port
cannot reproduce, so every parity test starts both sides from the same
numpy tables (``word2vec_state_from_jax``). The reference is imported by a
fixture, so the ``cuda`` case (a fit on the card against the same fit on
the CPU, and repeated bitwise) also runs where JAX is not installed.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import word2vec as w2v
from deeplearning4j_tpu_torch.models.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.models.word2vec import (
    Word2Vec,
    word2vec_state_from_jax,
)
from deeplearning4j_tpu_torch.nlp import serializer
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator,
)

# one batch update, f32 on both sides: the dots and the grad_in sums are
# added up in other orders (XLA's dot vs an elementwise product summed)
STEP_ATOL = 1e-5
# whole fits: those last-bit differences carried through every later batch
# (measured up to 3e-6 on these tables, whose entries reach 1.5)
FIT_ATOL = 1e-4


@pytest.fixture
def ref():
    """The reference: JAX and the JAX package's Word2Vec modules."""
    jax = pytest.importorskip("jax")
    pv = pytest.importorskip("deeplearning4j_tpu.models.paragraph_vectors")
    w2v_ref = pytest.importorskip("deeplearning4j_tpu.models.word2vec")
    it = pytest.importorskip("deeplearning4j_tpu.nlp.sentence_iterator")
    return SimpleNamespace(jax=jax, jnp=jax.numpy, w2v=w2v_ref, pv=pv,
                           Sentences=it.CollectionSentenceIterator)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


def _synthetic_corpus(n=300, seed=0):
    """Two topic clusters: day/sun/light/morning vs night/moon/dark/evening
    (the reference's test corpus, tests/test_nlp.py)."""
    rng = np.random.default_rng(seed)
    day = ["day", "sun", "light", "morning", "bright", "noon"]
    night = ["night", "moon", "dark", "evening", "stars", "midnight"]
    fillers = ["the", "a", "was", "very", "and", "it", "sky", "time"]
    sents = []
    for _ in range(n):
        topic = day if rng.random() < 0.5 else night
        words = list(rng.choice(topic, size=4)) + list(rng.choice(fillers, size=3))
        rng.shuffle(words)
        sents.append(" ".join(words))
    return sents


def _tables(v, d, seed, n1=None):
    """Carried-over tables: syn0 as the reference initializes it, syn1 and
    syn1neg nonzero so every update path moves."""
    rng = np.random.default_rng(seed)
    syn0 = ((rng.random((v, d)) - 0.5) / d).astype(np.float32)
    syn1 = rng.normal(0, 0.1, (n1 or max(v - 1, 1), d)).astype(np.float32)
    syn1neg = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    return syn0, syn1, syn1neg


def _assert_tables(port, ref, names, atol):
    for name in names:
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


def _pair(r, cls_port, cls_ref, sents, **kw):
    """A port model and a reference model with the same vocabulary and the
    same carried-over tables."""
    port = cls_port(device="cpu", **kw)
    ref = cls_ref(**kw)
    port.build_vocab(CollectionSentenceIterator(sents))
    ref.build_vocab(r.Sentences(sents))
    assert port.cache.words() == ref.cache.words()
    syn0, syn1, syn1neg = _tables(len(ref.cache), kw["layer_size"], seed=11)
    st = word2vec_state_from_jax(syn0, syn1, syn1neg, device="cpu")
    port.syn0, port.syn1, port.syn1neg = st["syn0"], st["syn1"], st["syn1neg"]
    ref.syn0, ref.syn1, ref.syn1neg = (r.jnp.asarray(x)
                                       for x in (syn0, syn1, syn1neg))
    return port, ref


def _step_inputs(seed, v=40, n1=39, d=16, b=64, L=6):
    rng = np.random.default_rng(seed)
    S = rng.normal(0, 0.3, (v + n1, d)).astype(np.float32)
    inputs = rng.integers(0, 8, b)  # few rows: collisions accumulate
    codes = rng.integers(0, 2, (b, L)).astype(np.float32)
    points = rng.integers(0, n1, (b, L))
    mask = (rng.random((b, L)) > 0.2).astype(np.float32)
    # plant saturated dots: input rows 0-1 scaled up against syn1 rows 0-3
    S[:2] *= 12.0
    S[v:v + 4] = 3.0 * S[:2].repeat(2, 0) / np.linalg.norm(
        S[:2].repeat(2, 0), axis=1, keepdims=True)
    inputs[:16] = np.arange(16) % 2
    points[:16, :2] = np.arange(32).reshape(16, 2) % 4
    return S, inputs, codes, points, mask


def test_hs_math_merged_matches_reference(ref):
    jnp = ref.jnp
    v = 40
    S, inputs, codes, points, mask = _step_inputs(0, v=v)
    h = S[inputs].astype(np.float64)
    dot = np.einsum("bd,bld->bl", h, S[v + points].astype(np.float64))
    assert (np.abs(dot) >= 6).sum() > 8 and (np.abs(dot) < 6).sum() > 100
    lr = np.float32(0.05)
    want = np.asarray(ref.w2v._hs_math_merged(
        jnp.asarray(S), v, jnp.asarray(inputs, jnp.int32),
        jnp.asarray(codes, jnp.int32), jnp.asarray(points, jnp.int32),
        jnp.asarray(mask), lr))
    St = torch.from_numpy(S.copy())
    out = w2v._hs_math_merged(St, v, torch.from_numpy(inputs),
                              torch.from_numpy(codes),
                              torch.from_numpy(points),
                              torch.from_numpy(mask), float(lr))
    assert out is St  # in place
    np.testing.assert_allclose(St.numpy(), want, atol=STEP_ATOL, rtol=0)
    # the saturated pairs were skipped: clipping them instead moves rows
    # the reference leaves
    assert np.abs(St.numpy() - S).max() > 1e-3
    syn0, syn1 = w2v._hs_math(torch.from_numpy(S[:v]),
                              torch.from_numpy(S[v:]),
                              torch.from_numpy(inputs),
                              torch.from_numpy(codes),
                              torch.from_numpy(points),
                              torch.from_numpy(mask), float(lr))
    np.testing.assert_array_equal(torch.cat([syn0, syn1]).numpy(),
                                  St.numpy())


def test_ns_step_matches_reference(ref):
    jnp = ref.jnp
    v, d, b, k = 40, 16, 64, 5
    S, inputs, _, _, _ = _step_inputs(1, v=v, n1=v)
    rng = np.random.default_rng(2)
    targets = rng.integers(0, v, b)
    negatives = rng.integers(0, v, (b, k))
    # saturated both ways: rows 0-1 against syn1neg rows of 0-1 and -(0-1)
    S[v:v + 2] = 3.0 * S[:2] / np.linalg.norm(S[:2], axis=1, keepdims=True)
    S[v + 2:v + 4] = -S[v:v + 2]
    targets[:8], negatives[:8, 0] = np.arange(8) % 2, 2 + np.arange(8) % 2
    lr = np.float32(0.025)
    r0, r1 = ref.w2v._ns_step(
        jnp.asarray(S[:v]), jnp.asarray(S[v:]),
        jnp.asarray(inputs, jnp.int32), jnp.asarray(targets, jnp.int32),
        jnp.asarray(negatives, jnp.int32), lr)
    p0, p1 = w2v._ns_step(torch.from_numpy(S[:v]), torch.from_numpy(S[v:]),
                          torch.from_numpy(inputs),
                          torch.from_numpy(targets),
                          torch.from_numpy(negatives), float(lr))
    np.testing.assert_allclose(p0.numpy(), np.asarray(r0), atol=STEP_ATOL,
                               rtol=0)
    np.testing.assert_allclose(p1.numpy(), np.asarray(r1), atol=STEP_ATOL,
                               rtol=0)


def test_hs_scan_matches_reference_and_skips_lr0_batches(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(3)
    V, D, L, B, K = 30, 8, 5, 16, 4
    syn0 = rng.normal(0, 0.1, (V, D)).astype(np.float32)
    syn1 = rng.normal(0, 0.1, (V - 1, D)).astype(np.float32)
    codes = (rng.random((V, L)) > 0.5).astype(np.float32)
    points = rng.integers(0, V - 1, (V, L))
    mask = (rng.random((V, L)) > 0.2).astype(np.float32)
    ins = rng.integers(0, V, (K, B))
    tgts = rng.integers(0, V, (K, B))
    lrs = np.array([0.05, 0.04, 0.0, 0.0], np.float32)  # two filler batches
    r0, r1 = ref.w2v._hs_scan(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(ins, jnp.int32),
        jnp.asarray(tgts, jnp.int32), jnp.asarray(codes),
        jnp.asarray(points, jnp.int32), jnp.asarray(mask), jnp.asarray(lrs))
    t = [torch.from_numpy(x) for x in (syn0, syn1, ins, tgts, codes, points,
                                       mask)]
    p0, p1 = w2v._hs_scan(*t, lrs)
    np.testing.assert_allclose(p0.numpy(), np.asarray(r0), atol=STEP_ATOL,
                               rtol=0)
    np.testing.assert_allclose(p1.numpy(), np.asarray(r1), atol=STEP_ATOL,
                               rtol=0)
    # the same as the two trained batches alone
    q0, q1 = w2v._hs_scan(*t[:2], t[2][:2], t[3][:2], *t[4:], lrs[:2])
    assert torch.equal(q0, p0) and torch.equal(q1, p1)


@pytest.mark.parametrize("n,window", [(0, 2), (1, 3), (4, 2), (9, 5)])
def test_skipgram_pairs_equal_reference(ref, n, window):
    """The per-sentence enumerator, from the same numpy generator: the same
    pairs in the same order, and the generator left in the same state."""
    ids = list(np.random.default_rng(n).integers(0, 50, n))
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    a = w2v.skipgram_pairs(ids, window, ra)
    b = ref.w2v.skipgram_pairs(ids, window, rb)
    for x, y in zip(a, b):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    assert ra.integers(1 << 30) == rb.integers(1 << 30)


FIT_CASES = {
    "hs": dict(),
    "hs_ns": dict(negative=3),
    "epochs_tail": dict(epochs=4, batch_pairs=300),
    "sample": dict(sample=1e-2, negative=2),
    "ns_only": dict(use_hierarchical_softmax=False, negative=5),
    # chip_smoke.py phase 6's card-vs-CPU fit
    "smoke_topic": dict(layer_size=32, window=5, epochs=4, seed=1,
                        sentences=300),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_reference(ref, case):
    r = ref
    kw = dict(layer_size=16, window=3, epochs=2, lr=0.05, seed=2,
              batch_pairs=256)
    kw.update(FIT_CASES[case])
    sents = _synthetic_corpus(kw.pop("sentences", 150))
    port, ref = _pair(r, Word2Vec, r.w2v.Word2Vec, sents, **kw)
    port.fit(CollectionSentenceIterator(sents))
    ref.fit(r.Sentences(sents))
    _assert_tables(port, ref, ("syn0", "syn1", "syn1neg"), FIT_ATOL)
    for word in ("night", "day", "the"):
        assert port.words_nearest(word, top=5) == ref.words_nearest(word, top=5)
    assert port._lr_now == ref._lr_now


PV_CASES = {
    "hs": dict(),
    "ns": dict(use_hierarchical_softmax=False, negative=5),
    "frozen_words_hs_ns": dict(train_words=False, negative=3),
}


def _labeled_docs(n=60, n_labels=20):
    rng = np.random.default_rng(0)
    topics = [["day", "sun", "light", "bright"],
              ["night", "moon", "dark", "stars"],
              ["cat", "dog", "pet", "fur"]]
    fillers = [f"w{k}" for k in range(30)]
    return [(f"doc{i % n_labels}",
             " ".join(list(rng.choice(topics[i % 3], 4))
                      + list(rng.choice(fillers, 3))))
            for i in range(n)]


@pytest.mark.parametrize("case", sorted(PV_CASES))
def test_paragraph_vectors_match_reference(ref, case):
    r = ref
    kw = dict(layer_size=16, epochs=3, lr=0.05, seed=6, batch_pairs=128)
    kw.update(PV_CASES[case])
    docs = _labeled_docs()
    port, ref = _pair(r, ParagraphVectors, r.pv.ParagraphVectors,
                      [s for _, s in docs], **kw)
    # the reference's label init (jax.random, seed + 1), carried over
    n_labels, d = len({lab for lab, _ in docs}), kw["layer_size"]
    labels = np.asarray((r.jax.random.uniform(
        r.jax.random.key(kw["seed"] + 1), (n_labels, d)) - 0.5) / d)
    port._reset_label_weights = lambda: setattr(
        port, "syn0_labels", word2vec_state_from_jax(
            labels, labels, labels, device="cpu")["syn0"])
    syn0_before = port.syn0.clone()
    port.fit_labeled(docs)
    ref.fit_labeled(docs)
    _assert_tables(port, ref, ("syn0", "syn1", "syn1neg", "syn0_labels"),
                   FIT_ATOL)
    assert port.labels == ref.labels
    if not port.train_words:
        assert torch.equal(port.syn0, syn0_before)
    for text in ("sun light", "moon stars dark", "pet fur"):
        assert port.infer_nearest_label(text) == ref.infer_nearest_label(text)


def test_word_vectors_api_matches_reference(ref, tmp_path):
    r = ref
    sents = _synthetic_corpus(100)
    port, ref = _pair(r, Word2Vec, r.w2v.Word2Vec, sents, layer_size=16)
    qfile = tmp_path / "questions-words.txt"
    qfile.write_text(
        ": capital-common\nday sun night moon\nday sun night stars\n"
        "bad line\n: family\nmorning noon evening midnight\n"
        "day unseen night moon\n\n")
    questions = [("day", "sun", "night", "moon"),
                 ("sun", "day", "moon", "night"),
                 ("day", "nope", "night", "moon")]
    assert w2v.parse_questions_words(qfile) == r.w2v.parse_questions_words(qfile)
    assert port.accuracy_report(qfile) == ref.accuracy_report(qfile)
    assert port.accuracy_report(str(qfile)) == ref.accuracy_report(str(qfile))
    assert port.accuracy(questions) == ref.accuracy(questions)
    for a, b in (("day", "sun"), ("day", "night"), ("day", "unseen")):
        np.testing.assert_allclose(port.similarity(a, b),
                                   ref.similarity(a, b), atol=1e-6)
    vec = port.get_word_vector("moon")
    np.testing.assert_array_equal(vec, np.asarray(ref.get_word_vector("moon")))
    vec[:] = 0  # a copy, not a view of the table
    assert port.get_word_vector("moon").any()
    assert port.get_word_vector("unseen") is None
    assert port.words_nearest("sky", top=4, exclude={"the"}) == \
        ref.words_nearest("sky", top=4, exclude={"the"})
    assert port.words_nearest(vec + 1.0, top=3) == ref.words_nearest(vec + 1.0, top=3)
    assert port.words_nearest("unseen") == []


def test_fit_is_deterministic():
    sents = _synthetic_corpus(80)
    runs = []
    for _ in range(2):
        m = Word2Vec(layer_size=8, window=3, epochs=2, negative=2,
                     batch_pairs=128, device="cpu")
        m.fit(CollectionSentenceIterator(sents))
        runs.append((m.syn0, m.syn1, m.syn1neg))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hs", "hs_ns"])
def test_fit_on_card_matches_cpu_and_repeats_bitwise(cuda_device, case):
    """A fit on the card (kernel #5, the sorted scatter) against the same
    fit on the CPU from the same tables within FIT_ATOL, and a second card
    fit bitwise equal to the first, the first with TF32 allowed."""
    sents = _synthetic_corpus(150)
    kw = dict(layer_size=16, window=3, epochs=2, lr=0.05, seed=2,
              batch_pairs=256, negative=3 if case == "hs_ns" else 0)
    syn0 = syn1 = syn1neg = None

    def fit(device):
        nonlocal syn0, syn1, syn1neg
        m = Word2Vec(device=device, **kw)
        m.build_vocab(CollectionSentenceIterator(sents))
        if syn0 is None:
            syn0, syn1, syn1neg = _tables(len(m.cache), 16, seed=11)
        st = word2vec_state_from_jax(syn0, syn1, syn1neg, device=device)
        m.syn0, m.syn1, m.syn1neg = st["syn0"], st["syn1"], st["syn1neg"]
        m.fit(CollectionSentenceIterator(sents))
        return m

    host = fit("cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        first = fit(cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    from deeplearning4j_tpu_torch.ops import emb_dot

    emb_dot.reset_launches()
    again = fit(cuda_device)
    assert emb_dot.launches > 0
    for name in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_allclose(getattr(first, name).cpu().numpy(),
                                   getattr(host, name).numpy(),
                                   atol=FIT_ATOL, rtol=0, err_msg=name)
        assert torch.equal(getattr(first, name), getattr(again, name)), name


def _colliding_updates(n, n_rows, d, seed):
    """Rows with runs of every length around the piece size and one run
    of a quarter of the entries (the Huffman root), half the others
    skipped with exact-zero deltas."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n)
    rows[rng.random(n) < 0.25] = n_rows // 2
    runs = np.repeat([1, 2, 3], w2v._PIECE + np.arange(3) - 1)
    if n > len(runs):  # runs just under, at and over one piece
        rows[:len(runs)] = runs
    keep = rng.random(n) < 0.5
    keep[0] = True
    deltas = rng.normal(0, 1, (n, d)).astype(np.float32)
    deltas[~keep] = 0.0
    base = rng.normal(0, 1, (n_rows + 3, d)).astype(np.float32)
    return (torch.from_numpy(base), torch.from_numpy(rows),
            torch.from_numpy(deltas), torch.from_numpy(keep))


@pytest.mark.parametrize("n,use_keep", [(1, False), (500, True),
                                        (5000, False), (5000, True)])
def test_sorted_scatter_add_matches_index_add(n, use_keep):
    """The card's scatter, run here on CPU tensors: the same sums as the
    CPU's in-order index_add_ within f32 rounding of sums of up to 1,300
    unit normals, skipped entries ignored, untouched rows bitwise kept, and
    the same bits on a second run. Its two halves, the index-only plan and
    the apply, give the same bits from deltas written at the plan's sorted
    positions (``dest``) into a NaN-filled buffer, the skipped entries left
    NaN: the apply never reads them."""
    base, rows, deltas, keep = _colliding_updates(n, 40, 7, seed=n)
    want = base.clone()
    w2v._scatter_add_rows(want, rows, deltas)
    outs = []
    for _ in range(2):
        S = base.clone()
        w2v._sorted_scatter_add(S, rows, deltas, keep if use_keep else None)
        outs.append(S)
    assert torch.equal(outs[0], outs[1])
    plan = w2v._scatter_plan(rows, keep if use_keep else None, len(base),
                             inverse=True)
    assert torch.equal(plan.perm[plan.dest], torch.arange(n))
    kept = keep if use_keep else torch.ones(n, dtype=torch.bool)
    buf = torch.full_like(deltas, float("nan"))
    buf[plan.dest[kept]] = deltas[kept]
    S = base.clone()
    w2v._scatter_apply(S, plan, buf)
    assert torch.equal(S, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), atol=1e-4,
                               rtol=0)
    untouched = torch.ones(len(base), dtype=torch.bool)
    untouched[rows] = False
    assert torch.equal(outs[0][untouched], base[untouched])


@pytest.mark.cuda
def test_scatter_is_deterministic_on_card(cuda_device):
    """Heavily colliding row updates: the card's accumulation is the same
    bit for bit every time, and within f32 rounding of the CPU's."""
    base, rows, deltas, keep = _colliding_updates(90_000, 5000, 100, seed=0)
    want = base.clone()
    w2v._scatter_add_rows(want, rows, deltas)
    outs = []
    for _ in range(3):
        S = base.to(cuda_device)
        w2v._scatter_add_rows(S, rows.to(cuda_device),
                              deltas.to(cuda_device), keep.to(cuda_device))
        outs.append(S.cpu())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), atol=1e-3,
                               rtol=0)


def test_state_from_jax_and_distributed_slice():
    syn0, syn1, syn1neg = _tables(5, 4, seed=0)
    st = word2vec_state_from_jax(syn0, syn1, syn1neg, syn0_labels=syn0[:2],
                                 device="cpu")
    assert sorted(st) == ["syn0", "syn0_labels", "syn1", "syn1neg"]
    for name, x in (("syn0", syn0), ("syn1", syn1), ("syn1neg", syn1neg)):
        assert st[name].dtype == torch.float32
        np.testing.assert_array_equal(st[name].numpy(), x)
    syn0[0, 0] = 99.0  # the tensors own their memory
    assert st["syn0"][0, 0] != 99.0
    m = Word2Vec(device="cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        m.fit_distributed(CollectionSentenceIterator(["a b c"]))


def test_reset_weights_shapes_and_range():
    m = Word2Vec(layer_size=8, device="cpu", seed=4)
    m.build_vocab(CollectionSentenceIterator(_synthetic_corpus(20)))
    m.reset_weights()
    v = len(m.cache)
    assert m.syn0.shape == (v, 8) and m.syn1.shape == (v - 1, 8)
    assert m.syn1neg.shape == (v, 8)
    assert m.syn0.abs().max() <= 0.5 / 8 and not m.syn1.any()
    again = Word2Vec(layer_size=8, device="cpu", seed=4)
    again.cache = m.cache
    again.reset_weights()
    assert torch.equal(again.syn0, m.syn0)


# -- the reference's behavioural tests (tests/test_nlp.py), on the port ------

def test_word2vec_learns_topic_similarity():
    sents = _synthetic_corpus(400)
    m = Word2Vec(layer_size=32, window=5, epochs=24, lr=0.05, seed=1,
                 device="cpu")
    m.fit(CollectionSentenceIterator(sents))
    assert m.similarity("day", "sun") > m.similarity("day", "moon")
    near = m.words_nearest("night", top=5)
    night_topic = {"moon", "dark", "evening", "stars", "midnight"}
    assert len(night_topic & set(near)) >= 2, near


def test_word2vec_negative_sampling_path():
    sents = _synthetic_corpus(200)
    m = Word2Vec(layer_size=16, window=3, epochs=4, lr=0.05,
                 use_hierarchical_softmax=False, negative=5, seed=2,
                 device="cpu")
    m.fit(CollectionSentenceIterator(sents))
    assert torch.isfinite(m.syn0).all()
    assert m.similarity("day", "sun") > m.similarity("day", "midnight")


def test_word2vec_many_epochs_stays_bounded():
    """Saturated-dot updates must be skipped: clipping instead diverges on
    small corpora at high epochs."""
    corpus = [
        "the day was bright and the night was dark",
        "day follows night and night follows day",
    ] * 100
    m = Word2Vec(layer_size=16, window=3, min_word_frequency=1, seed=7,
                 epochs=15, device="cpu")
    s = CollectionSentenceIterator(corpus)
    m.build_vocab(s)
    s.reset()
    m.fit(s)
    assert torch.isfinite(m.syn0).all()
    assert m.syn0.abs().max().item() < 50.0
    assert np.isfinite(m.similarity("day", "night"))


def test_paragraph_vectors_dbow():
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(100):
        pairs.append(("daytime", " ".join(rng.choice(["day", "sun", "light", "bright"], 5))))
        pairs.append(("nighttime", " ".join(rng.choice(["night", "moon", "dark", "stars"], 5))))
    pv = ParagraphVectors(layer_size=16, epochs=12, lr=0.05, seed=6,
                          train_words=True, device="cpu")
    pv.fit_labeled(pairs)
    assert pv.get_label_vector("daytime") is not None
    assert pv.get_label_vector("unseen") is None
    assert pv.infer_nearest_label("sun light bright day") == "daytime"
    assert pv.infer_nearest_label("moon stars dark night") == "nighttime"


def test_paragraph_vectors_negative_sampling():
    """PV-DBOW through the negative-sampling update: same-topic label
    vectors cluster, cross-topic ones do not (184 fillers: V = 200)."""
    rng = np.random.default_rng(0)
    topics = [
        ["day", "sun", "light", "bright"],
        ["night", "moon", "dark", "stars"],
        ["cat", "dog", "pet", "fur"],
        ["car", "road", "drive", "wheel"],
    ]
    fillers = [f"w{k}" for k in range(184)]
    docs = []
    for i in range(1000):
        words = list(rng.choice(topics[i % 4], 5)) + list(
            rng.choice(fillers, 5)
        )
        rng.shuffle(words)
        docs.append((f"doc{i}", " ".join(words)))
    pv = ParagraphVectors(
        layer_size=32, epochs=8, lr=0.05, seed=6, train_words=False,
        use_hierarchical_softmax=False, negative=5, device="cpu",
    )
    pv.fit_labeled(docs)
    assert len(pv.cache) == 200
    vecs = np.stack([pv.get_label_vector(f"doc{i}") for i in range(120)])
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-9
    sims = vecs @ vecs.T
    same_topic = (np.arange(120)[:, None] % 4) == (np.arange(120)[None] % 4)
    off_diag = ~np.eye(120, dtype=bool)
    same = sims[same_topic & off_diag].mean()
    cross = sims[~same_topic].mean()
    assert same > cross + 0.3, (same, cross)


def test_paragraph_vectors_freezes_words_and_scratch_padding():
    """train_words=False leaves the word vectors untouched even when the
    pair stream is not a whole number of batches (the padded tail rides on
    the scratch row, not word row 0)."""
    docs = [("a", "day sun light"), ("b", "night moon dark")]
    pv = ParagraphVectors(layer_size=8, epochs=3, lr=0.1, seed=2,
                          train_words=False, device="cpu")
    pv.build_vocab(CollectionSentenceIterator([s for _, s in docs]))
    pv.reset_weights()
    syn0_before = pv.syn0.clone()
    pv.fit_labeled(docs)
    assert torch.equal(pv.syn0, syn0_before)
    assert pv.syn0_labels.shape == (2, 8)


def test_serializer_roundtrips(tmp_path):
    words = ["alpha", "beta"]
    vecs = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], dtype=np.float32)
    serializer.write_text(tmp_path / "v.txt", words, vecs)
    w2, v2 = serializer.read_text(tmp_path / "v.txt")
    assert w2 == words and np.allclose(v2, vecs, atol=1e-5)

    serializer.write_binary(tmp_path / "v.bin", words, torch.from_numpy(vecs))
    w3, v3 = serializer.read_binary(tmp_path / "v.bin")
    assert w3 == words and np.allclose(v3, vecs)

    m = serializer.load_into_word2vec(Word2Vec, words, vecs, device="cpu")
    assert np.allclose(m.get_word_vector("beta"), [4, 5, 6])
    assert m.words_nearest("alpha", top=1) == ["beta"]
    out_words, out_vecs = serializer.from_word2vec(m)
    assert out_words == words and np.array_equal(out_vecs, vecs)
