"""The port's GloVe held against the JAX package's on the CPU: the
co-occurrence triples bit for bit and in order, the initial tables bit for
bit, one AdaGrad step from a carried-over state, whole fits (``fit``,
``fit_cooccurrences`` with continue-training and the out-of-vocabulary
drop), ``fit_distributed`` over 2 and 8 data ranks against the reference's
over ``data_parallel_mesh(8)``'s first devices, and the reference's
behavioural tests on the port; then the data axis across two gloo processes
(this file run as a script is the worker; it imports no JAX) for GloVe and
Word2Vec, against one process of two ranks.

Tolerances: ``STEP_RTOL`` for one step (the dots summed in other orders);
``FIT_RTOL`` for whole fits, relative to each table's largest entry (those
last-bit differences carried through every later batch).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deeplearning4j_tpu_torch.models import glove as pg  # noqa: E402
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec  # noqa: E402
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (  # noqa: E402
    CollectionSentenceIterator,
)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel_mesh,
)

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

STEP_RTOL = 1e-6
FIT_RTOL = 1e-5
KW = dict(layer_size=8, window=4, epochs=3, lr=0.05, batch=64, seed=4)


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    from types import SimpleNamespace

    from deeplearning4j_tpu.models import glove
    from deeplearning4j_tpu.nlp.sentence_iterator import (
        CollectionSentenceIterator as Sentences,
    )
    from deeplearning4j_tpu.parallel.mesh import data_parallel_mesh as jmesh

    return SimpleNamespace(glove=glove, Sentences=Sentences, mesh=jmesh,
                           jnp=pytest.importorskip("jax.numpy"))


def _corpus(n=200, seed=0):
    """Two topic clusters (the reference's tests/test_nlp.py corpus)."""
    rng = np.random.default_rng(seed)
    day = ["day", "sun", "light", "morning", "bright", "noon"]
    night = ["night", "moon", "dark", "evening", "stars", "midnight"]
    fillers = ["the", "a", "was", "very", "and", "it", "sky", "time"]
    sents = []
    for _ in range(n):
        topic = day if rng.random() < 0.5 else night
        words = list(rng.choice(topic, size=4)) + list(
            rng.choice(fillers, size=3))
        rng.shuffle(words)
        sents.append(" ".join(words))
    return sents


def _glove_corpus(n):
    """The reference's tests/test_gapfill.py pairs corpus."""
    pairs = [("ice", "cold"), ("fire", "hot"), ("king", "crown"),
             ("sea", "salt")]
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        a, b = pairs[rng.integers(len(pairs))]
        filler = ["the", "of", "and"][rng.integers(3)]
        out.append(f"{a} {b} {filler} {a} {b}")
    return out


def _assert_tables(port, reference, rtol):
    for name in pg.TABLES[:4]:
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(reference, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max(),
                                   err_msg=name)
    for a, b in zip(port._acc, reference._acc):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rtol * np.abs(b).max())


CORPORA = {
    "random": lambda g: [list(g.integers(0, 30, g.integers(0, 25)))
                         for _ in range(40)],
    "repeats": lambda g: [[1, 2, 1, 2, 1, 2, 1], [2, 1], [1, 1, 1, 1]] * 5,
    "short": lambda g: [[3], [], [4, 5], [5, 4], [6]],
    "zipf": lambda g: [list(g.zipf(1.3, 200) % 500) for _ in range(30)],
}


@pytest.mark.parametrize("window", [1, 5])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_cooccurrences_bitwise_in_order(ref, corpus, window):
    """The triples equal the reference's ``Counter`` bit for bit and in its
    first-occurrence order, repeated pairs and short sentences included."""
    sents = CORPORA[corpus](np.random.default_rng(len(corpus) + window))
    got = pg.count_cooccurrences(sents, window)
    want = ref.glove.count_cooccurrences(sents, window)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cooccurrences_empty():
    rows, cols, vals = pg.count_cooccurrences([[1], []], 5)
    assert len(rows) == len(cols) == len(vals) == 0
    assert vals.dtype == np.float32 and rows.dtype == np.int32


def test_initial_tables_are_the_reference_bits(ref):
    port = pg.Glove(device="cpu", **KW)
    port._prepare(CollectionSentenceIterator(_corpus(40)))
    r = ref.glove.Glove(**KW)
    r._prepare(ref.Sentences(_corpus(40)))
    for name in pg.TABLES[:4]:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(r, name)))


def test_one_step_matches_reference(ref):
    """One AdaGrad step from a carried-over state (accumulators above 1,
    rows repeated in the batch) against the reference's ``_glove_math``,
    its eight tables merged into the port's four and read back."""
    g = np.random.default_rng(0)
    v, d, b = 13, 6, 40
    state = [g.normal(0, 0.3, (v, d)), g.normal(0, 0.3, (v, d)),
             g.normal(0, 0.3, v), g.normal(0, 0.3, v),
             1 + g.random((v, d)), 1 + g.random((v, d)), 1 + g.random(v),
             1 + g.random(v)]
    state = [s.astype(np.float32) for s in state]
    rows = g.integers(0, v, b).astype(np.int32)
    cols = g.integers(0, v, b).astype(np.int32)
    logx = g.normal(0, 1, b).astype(np.float32)
    fx = g.random(b).astype(np.float32)
    want = ref.glove._glove_math(
        *(ref.jnp.asarray(a) for a in (*state, rows, cols, logx, fx)),
        ref.jnp.float32(0.05))
    m = pg.Glove(device="cpu", layer_size=d)
    pg.load_state(m, pg.glove_state_from_jax(*state, device="cpu"))
    *m._tables, loss = pg._glove_math(
        *m._tables, torch.tensor(rows, dtype=torch.int64),
        torch.tensor(cols, dtype=torch.int64), torch.tensor(logx),
        torch.tensor(fx), 0.05)
    got = (m.w, m.wc, m.b, m.bc, *m._acc, loss)
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=STEP_RTOL * max(np.abs(w).max(), 1))


def test_fit_matches_reference(ref):
    port = pg.Glove(device="cpu", **KW)
    port.fit(CollectionSentenceIterator(_corpus(100)))
    r = ref.glove.Glove(**KW)
    r.fit(ref.Sentences(_corpus(100)))
    assert port.cache.words() == r.cache.words()
    _assert_tables(port, r, FIT_RTOL)
    np.testing.assert_allclose(port.loss_history, r.loss_history, rtol=1e-5)
    for w1, w2 in (("day", "sun"), ("day", "moon")):
        assert port.similarity(w1, w2) == pytest.approx(r.similarity(w1, w2),
                                                        abs=1e-5)


def test_fit_cooccurrences_continues_and_drops_oov(ref):
    """Continue-training keeps the tables and the AdaGrad history; a triple
    with an out-of-vocabulary word is dropped; a fresh model builds its
    vocabulary from the triples."""
    kw = dict(layer_size=8, window=4, epochs=3, lr=0.05, batch=64, seed=1)
    triples = [("day", "sun", 5.0), ("night", "moon", 4.0),
               ("unseenword", "day", 3.0), ("sun", "light", 0.0)]
    port = pg.Glove(device="cpu", **kw)
    port.fit(CollectionSentenceIterator(_corpus(60)))
    acc_before = [a.clone() for a in port._acc]
    port.fit_cooccurrences(triples)
    r = ref.glove.Glove(**kw)
    r.fit(ref.Sentences(_corpus(60)))
    r.fit_cooccurrences(triples)
    assert "unseenword" not in port.cache.vocab
    assert port.cache.words() == r.cache.words()
    _assert_tables(port, r, FIT_RTOL)
    assert not torch.equal(port._acc[0], acc_before[0])  # history kept on
    fresh = pg.Glove(device="cpu", layer_size=8, epochs=2, batch=8, seed=2)
    fresh.fit_cooccurrences([("a", "b", 2.0), ("b", "c", 1.5)])
    rf = ref.glove.Glove(layer_size=8, epochs=2, batch=8, seed=2)
    rf.fit_cooccurrences([("a", "b", 2.0), ("b", "c", 1.5)])
    assert len(fresh.cache) == 3
    _assert_tables(fresh, rf, FIT_RTOL)
    with pytest.raises(ValueError, match="empty"):
        pg.Glove(device="cpu").fit_cooccurrences([("a", "b", 0.0)])


def test_state_round_trip():
    g = np.random.default_rng(1)
    arrays = [g.random((4, 3)).astype(np.float32) for _ in range(2)] + [
        g.random(4).astype(np.float32) for _ in range(2)] + [
        g.random((4, 3)).astype(np.float32) for _ in range(2)] + [
        g.random(4).astype(np.float32) for _ in range(2)]
    st = pg.glove_state_from_jax(*arrays, device="cpu")
    assert list(st) == list(pg.TABLES)
    m = pg.Glove(device="cpu", layer_size=3)
    pg.load_state(m, st)
    np.testing.assert_array_equal(m.syn0.numpy(), arrays[0] + arrays[1])
    np.testing.assert_array_equal(m._acc[3].numpy(), arrays[7])


@pytest.mark.parametrize("n", [2, 8])
def test_fit_distributed_matches_reference(ref, n):
    """``fit_distributed`` over ``["cpu"] * n`` against the reference's over
    ``data_parallel_mesh(n)``: the tables, the accumulators and the losses
    (each batch's mean of the ranks')."""
    sents = _corpus(100)
    port = pg.Glove(device="cpu", **KW)
    port.fit_distributed(CollectionSentenceIterator(sents),
                         mesh=data_parallel_mesh(devices=["cpu"] * n))
    r = ref.glove.Glove(**KW)
    r.fit_distributed(ref.Sentences(sents), mesh=ref.mesh(n))
    _assert_tables(port, r, FIT_RTOL)
    np.testing.assert_allclose(port.loss_history, r.loss_history, rtol=1e-5)


def test_fit_distributed_batch_smaller_than_mesh():
    m = pg.Glove(device="cpu", batch=2, epochs=1)
    with pytest.raises(ValueError, match="smaller than mesh"):
        m.fit_distributed(CollectionSentenceIterator(["a b"]),
                          mesh=data_parallel_mesh(devices=["cpu"] * 8))


# -- the reference's behavioural tests, on the port ----------------------------

def test_glove_learns_cooccurrence_structure():
    g = pg.Glove(layer_size=16, window=4, epochs=30, lr=0.05, batch=512,
                 seed=4, device="cpu")
    g.fit(CollectionSentenceIterator(_corpus(200)))
    assert g.loss_history[-1] < g.loss_history[0]
    assert g.similarity("day", "sun") > g.similarity("day", "moon")


def test_glove_distributed_matches_local_structure():
    g = pg.Glove(layer_size=16, epochs=8, batch=512, seed=7, device="cpu")
    g.fit_distributed(CollectionSentenceIterator(_glove_corpus(150)),
                      mesh=data_parallel_mesh(devices=["cpu"] * 8))
    assert g.loss_history[-1] < g.loss_history[0]
    assert g.similarity("ice", "cold") > g.similarity("ice", "crown")


@pytest.mark.cuda
def test_fit_on_card_matches_cpu_and_repeats():
    """Seeded fits on the card (the sorted scatter) repeat bit for bit and
    stay within FIT_RTOL of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        m = pg.Glove(device=dev, **KW)
        m.fit(CollectionSentenceIterator(_corpus(100)))
        runs.append(m)
    for name in pg.TABLES[:4]:
        a, b, c = (getattr(m, name).cpu() for m in runs)
        assert torch.equal(a, b), name
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                   atol=FIT_RTOL * c.abs().max().item())


# -- the data axis across two processes ----------------------------------------

W2V_KW = dict(layer_size=16, window=3, lr=0.05, seed=3, batch_pairs=256)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _both_models(mesh):
    """GloVe and Word2Vec fitted over ``mesh``; their tables, flattened."""
    g = pg.Glove(device="cpu", **KW)
    g.fit_distributed(CollectionSentenceIterator(_corpus(60)), mesh=mesh)
    w = Word2Vec(device="cpu", **W2V_KW)
    w.fit_distributed(CollectionSentenceIterator(_corpus(60)), mesh=mesh)
    return [g.w, g.wc, g.b, g.bc, *g._acc, torch.tensor(g.loss_history),
            w.syn0, w.syn1]


def _worker(port: int, pid: int) -> None:
    """Process ``pid`` of 2, one data rank each: prints the tables."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import hybrid_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=pid)
    mesh = hybrid_mesh({"data": 1}, {"data": 2}, ["cpu"])
    for i, t in enumerate(_both_models(mesh)):
        print("T", i, " ".join(repr(v) for v in t.reshape(-1).tolist()),
              flush=True)
    dist.destroy_process_group()


def test_fit_distributed_across_two_processes():
    """Two gloo processes of one data rank each equal one process of two
    ranks bit for bit (a mean of two is the same sum either way), for
    GloVe's eight tables and losses and Word2Vec's syn0 and syn1."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(pid)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    runs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        runs.append([np.array([float(v) for v in line.split()[2:]])
                     for line in out.splitlines() if line.startswith("T ")])
    want = _both_models(data_parallel_mesh(devices=["cpu"] * 2))
    assert len(runs[0]) == len(runs[1]) == len(want)
    for a, b, w in zip(*runs, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w.reshape(-1).double().numpy())


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
