"""Embeddings through the port's serving engine and ``POST /v1/embeddings``,
held against the reference.

- The reference's ``test_embeddings_ride_the_scheduler``
  (tests/test_serving_tenancy.py:514) on the port: embedding requests share
  the queue, the metrics and the lifecycle with generation but never take a
  KV slot (they are served with every slot taken), an unknown word maps to
  None, an unknown model fails that request alone.
- ``serve --embed-models word2vec``'s demo model is the reference's: the
  vector of every vocabulary word is bitwise the reference's
  ``_demo_embedders()["word2vec"]``'s.
- The endpoint: 200 with the vectors (``null`` for an unknown word), 400 on
  an empty or non-string ``words``, 503 on an engine without models, 500
  for an unknown model; embedding requests interleaved with generation
  leave the generated streams byte-identical; ``--embed-models glove``
  serves the reference's GloVe demo (its one-epoch fit, within 1e-5), and an
  unknown model beside it exits 2.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    Request,
    RequestStatus,
    ServingEngine,
    ServingServer,
    TenantConfig,
    TenantRegistry,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionError,
    EmbeddingRequest,
    RequestScheduler,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

CFG = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                           n_layers=2, d_ff=64, max_len=32)


@pytest.fixture(scope="module")
def params():
    return pt.init_params(CFG, seed=0, device="cpu")


class _StubEmbedder:
    """The reference test's zoo-shaped model: the engine needs only
    ``get_word_vector(word) -> array or None``."""

    def __init__(self, dim=4):
        self.dim = dim

    def get_word_vector(self, word):
        if word.startswith("oov"):
            return None
        rng = np.random.default_rng(sum(map(ord, word)))
        return rng.standard_normal(self.dim).astype(np.float32)


def _gen_requests(n, seed, max_new):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, 64, int(rng.integers(3, 9))),
                    max_new=max_new) for _ in range(n)]


def test_embeddings_ride_the_scheduler(params):
    """The reference's test on the port's engine."""
    engine = ServingEngine(CFG, params, n_slots=2, temperature=0.0,
                           device="cpu", embedders={"stub": _StubEmbedder()})
    gen = _gen_requests(4, seed=10, max_new=6)  # 4 requests > 2 slots
    emb = EmbeddingRequest(words=("alpha", "oov_x", "beta"), model="stub",
                           done=threading.Event())
    bad = EmbeddingRequest(words=("alpha",), model="nope",
                           done=threading.Event())
    for r in gen:
        engine.submit(r)
    engine.submit(emb)
    engine.submit(bad)
    engine.run()
    assert emb.status is RequestStatus.FINISHED and emb.done.is_set()
    assert set(emb.result) == {"alpha", "oov_x", "beta"}
    assert emb.result["oov_x"] is None
    assert emb.result["alpha"].shape == (4,)
    assert bad.status is RequestStatus.FAILED and "nope" in bad.error
    for r in gen:
        assert r.status is RequestStatus.FINISHED
    s = engine.metrics.summary()
    assert s["n_embeddings"] == 1 and "embedding_p50_s" in s
    prom = engine.metrics.render_prometheus()
    assert 'serve_embeddings_total{model="stub"} 1' in prom
    assert "serve_embedding_seconds_count 1" in prom


def test_embedding_served_with_every_slot_taken(params):
    """With both slots decoding and a generation request waiting for one,
    an embedding request (even of a lower priority class, since a blocked
    class does not idle admission) is served at the next admission
    boundary while the generation request still waits."""
    engine = ServingEngine(CFG, params, n_slots=2, temperature=0.0,
                           device="cpu", decode_horizon=1,
                           embedders={"stub": _StubEmbedder()})
    gen = _gen_requests(2, seed=1, max_new=12)
    for r in gen:
        engine.submit(r)
    engine.step()  # both slots taken
    waiting = Request(prompt=np.arange(4), max_new=2)
    engine.submit(waiting)
    emb = EmbeddingRequest(words=("w",), model="stub", priority=2)
    engine.submit(emb)
    engine.step()
    assert engine.pool.n_free == 0
    assert waiting.status is RequestStatus.QUEUED
    assert emb.status is RequestStatus.FINISHED
    engine.run()
    assert waiting.status is RequestStatus.FINISHED
    solo = ServingEngine(CFG, params, n_slots=1, temperature=0.0,
                         device="cpu", embedders={"stub": _StubEmbedder()})
    busy = Request(prompt=np.arange(5), max_new=20)
    solo.submit(busy)
    solo.step()
    e2 = EmbeddingRequest(words=("a", "b"), model="stub")
    solo.submit(e2)
    solo.step()
    assert solo.pool.n_free == 0 and e2.status is RequestStatus.FINISHED


def test_embedding_request_validation_and_cost():
    with pytest.raises(AdmissionError):
        EmbeddingRequest(words=())
    r = EmbeddingRequest(words=["a", "b", "c"])
    assert r.kind == "embedding" and r.token_cost() == 3
    assert r.words == ("a", "b", "c") and len(r.prompt) == 0
    sched = RequestScheduler(max_total_tokens=2)
    sched.submit(r)  # the slot budget applies to generation only
    assert sched.has_kind("embedding") and not sched.has_kind("kv_export")


def test_demo_model_is_the_references():
    """``serve --embed-models word2vec``'s demo: the reference's corpus,
    vocabulary and initial table, vector for vector."""
    assert cli._DEMO_SENTENCES == jcli._DEMO_SENTENCES
    ours = cli._demo_embedders(["word2vec"], device="cpu")["word2vec"]
    ref = jcli._demo_embedders(["word2vec"])["word2vec"]
    words = [ref.cache.index_to_word[i] for i in range(len(ref.cache))]
    assert len(words) == 27 == len(ours.cache)
    for w in words:
        a, b = ours.get_word_vector(w), np.asarray(ref.get_word_vector(w))
        assert a.dtype == np.float32 and np.array_equal(a, b), w
    assert ours.get_word_vector("zebra") is None
    # glove: the reference's one-epoch fit over the same corpus, vector for
    # vector within the fit's f32 rounding
    ours = cli._demo_embedders(["glove"], device="cpu")["glove"]
    ref = jcli._demo_embedders(["glove"])["glove"]
    assert len(ours.cache) == len(ref.cache) == 27
    for w in words:
        a, b = ours.get_word_vector(w), np.asarray(ref.get_word_vector(w))
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=w)
    with pytest.raises(ValueError, match="unknown"):
        cli._demo_embedders(["fasttext"], device="cpu")


def _post(base, path, body, headers=None):
    req = urllib.request.Request(
        base + path, method="POST", data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_embeddings_endpoint(params):
    """200 with the demo model's vectors (null for an unknown word), 400
    on an empty or non-string ``words``, 500 for an unknown model, 503
    without models; a tenant's request is counted under it."""
    emb = cli._demo_embedders(["word2vec", "glove"], device="cpu")
    tenancy = TenantRegistry([TenantConfig("t1", api_key="k1")])
    engine = ServingEngine(CFG, params, n_slots=2, temperature=0.0,
                           device="cpu", embedders=emb, tenancy=tenancy,
                           scheduler=RequestScheduler(tenancy=tenancy))
    srv = ServingServer(engine, port=0).start()
    try:
        base = "http://%s:%d" % srv.address
        k = {"X-API-Key": "k1"}
        code, out = _post(base, "/v1/embeddings",
                          {"words": ["fox", "zebra", "the"]}, k)
        assert code == 200 and out["model"] == "word2vec"
        for w in ("fox", "the"):
            want = emb["word2vec"].get_word_vector(w)
            assert np.array_equal(np.asarray(out["vectors"][w], np.float32),
                                  want)
        assert out["vectors"]["zebra"] is None
        assert _post(base, "/v1/embeddings", {"words": "dog day"}, k)[0] == 200
        assert _post(base, "/v1/embeddings", {"words": []}, k)[0] == 400
        assert _post(base, "/v1/embeddings", {"words": [1, 2]}, k)[0] == 400
        code, out = _post(base, "/v1/embeddings",
                          {"words": ["fox"], "model": "glove"}, k)
        assert code == 200 and out["model"] == "glove"
        np.testing.assert_array_equal(
            np.asarray(out["vectors"]["fox"], np.float32),
            emb["glove"].get_word_vector("fox"))
        code, out = _post(base, "/v1/embeddings",
                          {"words": ["fox"], "model": "fasttext"}, k)
        assert code == 500 and "fasttext" in out["error"]
        assert _post(base, "/v1/embeddings", {"words": ["fox"]},
                     {"X-API-Key": "nope"})[0] == 401
    finally:
        srv.stop()
    t = engine.metrics.summary()["tenants"]["t1"]
    assert t["n_finished"] == 3
    bare = ServingServer(ServingEngine(CFG, params, n_slots=1,
                                       device="cpu"), port=0).start()
    try:
        code, out = _post("http://%s:%d" % bare.address, "/v1/embeddings",
                          {"words": ["fox"]})
        assert code == 503 and "no embedding models" in out["error"]
    finally:
        bare.stop()


def test_interleaved_embeddings_keep_the_generate_streams(params):
    """Embedding lookups between generation requests change no generated
    token: the same traffic with and without them."""
    emb = {"word2vec": cli._demo_embedders(["word2vec"],
                                           device="cpu")["word2vec"]}

    def run(with_emb):
        engine = ServingEngine(CFG, params, n_slots=2, temperature=0.0,
                               device="cpu", embedders=emb,
                               decode_horizon=2)
        gen = _gen_requests(5, seed=4, max_new=7)
        extra = []
        for i, r in enumerate(gen):
            engine.submit(r)
            if with_emb:
                extra.append(EmbeddingRequest(words=("fox", f"w{i}")))
                engine.submit(extra[-1])
        res = engine.run()
        assert all(e.status is RequestStatus.FINISHED for e in extra)
        assert engine.metrics.n_embeddings == len(extra)
        return [res[r.id] for r in gen]

    for a, b in zip(run(False), run(True)):
        np.testing.assert_array_equal(a, b)


def test_cli_glove_exits_2(capsys):
    """``serve --embed-models glove,...`` accepts glove (its demo model is
    fitted) and exits 2 on an unknown model beside it, naming it, before
    the server starts."""
    rc = cli.main(["serve", "--demo", "--device", "cpu", "--port", "0",
                   "--embed-models", "glove,fasttext"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "fasttext" in err and "word2vec|glove" in err
