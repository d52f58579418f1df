"""The serving engine's sampling surface on the port: the engine cases of
``tests/test_serving_grammar.py`` (:315-:632; tensor parallelism left
out) on the port's engine, the server's surface fields, and one
cross-package case against the reference's masked engine.

Two contracts, as in the reference. (1) Parity: an engine armed with the
surface runs every decode dispatch through the masked step, yet
unconstrained traffic streams byte-identical tokens to the plain engine,
greedy and sampled, at K 1 and 4, paged, with piggyback, with the prefix
cache and across crash recovery. (2) Validity: a request with a regex or
JSON-schema ``response_format`` emits only DFA-permitted tokens and ends
in an accepting state, greedy and sampled (those cases, and constrained
crash recovery, are in ``test_torch_sampling_surface_constrained.py``,
which uses this module's model and helpers)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    Request,
    ServingEngine,
    ServingServer,
)
from deeplearning4j_tpu_torch.serving import engine as eng_mod

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

JCFG = jt.TransformerConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_len=64, rope=True, decode_kernel=False,
)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
EOS = 127
#: logprobs of the port's masked engine vs the reference's, f32 (the two
#: frameworks' logits agree to ~1e-5 at this size)
LOGPROB_ATOL = 1e-4
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "tag": {"enum": ["a", "bb"]}},
          "required": ["ok", "tag"]}
_P = {}


def _jparams():
    if "j" not in _P:
        _P["j"] = jt.init_transformer(jax.random.key(0), JCFG)
    return _P["j"]


def _params():
    if "t" not in _P:
        _P["t"] = pt.params_from_jax(jax.tree.map(np.asarray, _jparams()),
                                     CFG, device="cpu")
    return _P["t"]


def _seeded_schemas(n=20, seed=7):
    """The reference suite's 20 seeded schemas (its slow test's generator;
    tests/test_torch_grammar.py holds their tables against the
    reference's)."""
    rng = np.random.default_rng(seed)

    def rand_leaf():
        kind = rng.integers(0, 4)
        if kind == 0:
            return {"type": "boolean"}
        if kind == 1:
            m = int(rng.integers(2, 4))
            return {"enum": ["".join(chr(97 + int(c)) for c in rng.integers(
                0, 26, rng.integers(1, 4))) for _ in range(m)]}
        if kind == 2:
            return {"const": int(rng.integers(0, 100))}
        return {"type": "null"}

    def rand_schema():
        props = {}
        for j in range(int(rng.integers(1, 3))):
            name = "".join(chr(97 + int(c))
                           for c in rng.integers(0, 26, 2)) + str(j)
            if rng.integers(0, 4) == 0:
                props[name] = {"type": "array", "items": rand_leaf(),
                               "minItems": 1, "maxItems": 2}
            else:
                props[name] = rand_leaf()
        return {"type": "object", "properties": props,
                "required": list(props)}

    return [rand_schema() for _ in range(n)]


def _engine(surface=False, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("max_total", 64)
    kw.setdefault("decode_horizon", 2)
    kw.setdefault("prefill_max_bucket", 8)
    kw.setdefault("n_slots", 4)
    return ServingEngine(CFG, _params(), sampling_surface=surface,
                         retry_backoff_s=0.001, max_backoff_s=0.004,
                         device="cpu", **kw)


def _surface(**kw):
    eng = _engine(surface=True, **kw)
    assert eng._surface, "sampling surface silently fell back"
    return eng


def _requests(n=8, seed=1, max_new=6, cls=Request):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        ln = int(rng.integers(3, 40)) if i % 3 else 36
        p = ((1 + np.arange(ln)) % 127).astype(np.int32)
        reqs.append(cls(id=f"r{i}", prompt=p, max_new=max_new))
    return reqs


def _run(engine, reqs, **run_kw):
    for r in reqs:
        engine.submit(r)
    engine.run(**run_kw)
    return {r.id: np.asarray(engine.results[r.id]) for r in reqs}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _generated(res, req):
    toks = [int(t) for t in np.asarray(res)[len(req.prompt):]]
    if toks and toks[-1] == req.eos_token:
        toks = toks[:-1]
    return toks


def _decode(toks):
    return bytes(t for t in toks if t < 256).decode("latin-1")


def _count_masked(monkeypatch, eng):
    calls = []
    fn = eng._masked_fn
    monkeypatch.setattr(eng, "_masked_fn",
                        lambda *a: calls.append(1) or fn(*a))
    return calls


# -- unconstrained byte parity through the masked step ------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("horizon", [1, 4])
def test_unconstrained_parity_grid(monkeypatch, temperature, paged, horizon):
    """Plain traffic through an armed engine is byte-identical to the plain
    engine's, greedy and sampled, slab and paged, K 1 and 4."""
    kw = dict(temperature=temperature, decode_horizon=horizon)
    if paged:
        kw.update(paged=True, block_size=8)
    reqs = _requests()
    ref = _run(_engine(**kw), [Request(id=r.id, prompt=r.prompt,
                                       max_new=r.max_new) for r in reqs])
    eng = _surface(**kw)
    assert eng._paged == paged
    calls = _count_masked(monkeypatch, eng)
    _assert_same(ref, _run(eng, reqs))
    assert calls, "masked step never dispatched"


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_unconstrained_piggyback_and_prefix_parity(temperature):
    """With piggyback (chunks behind the masked dispatch) and the prefix
    cache on, plain traffic keeps the plain engine's bytes."""
    kw = dict(temperature=temperature, piggyback=True, prefix_cache=True)
    reqs = _requests() + [Request(id="rep", prompt=_requests()[0].prompt,
                                  max_new=6)]
    ref = _run(_engine(**kw), [Request(id=r.id, prompt=r.prompt,
                                       max_new=r.max_new) for r in reqs])
    eng = _surface(**kw)
    _assert_same(ref, _run(eng, reqs))
    assert eng.metrics.n_prefill_chunks > 0
    assert eng.metrics.n_prefix_hits_full > 0


def test_masked_parity_probe_gates_the_surface(monkeypatch):
    """A masked step that is not the base step bitwise leaves the surface
    off (``masked_parity_probe_failed``), and surface requests 400."""
    real = eng_mod._masked_draw

    def off_by_one(*a):
        toks, aux = real(*a)
        return toks + 1, aux

    monkeypatch.setattr(eng_mod, "_masked_draw", off_by_one)
    eng = _engine(surface=True, temperature=0.9)
    assert not eng._surface and eng._gtable is None
    monkeypatch.setattr(eng_mod, "_masked_draw", real)
    assert _engine(surface=True, temperature=0.9)._surface


# -- constrained decoding ----------------------------------------------------


# -- sampling controls ---------------------------------------------------------

def test_stop_sequence_truncates_exactly():
    base = Request(id="b", prompt=np.arange(8, dtype=np.int32), max_new=8)
    ref = _run(_engine(), [base])["b"][8:].tolist()
    assert len(ref) == 8
    stop = ref[3:5]
    cut = next(i for i in range(len(ref) - 1) if ref[i:i + 2] == stop)
    eng = _surface()
    r = Request(id="s", prompt=np.arange(8, dtype=np.int32), max_new=8,
                stop=[stop])
    got = _run(eng, [r])["s"][8:].tolist()
    assert got == ref[:cut], "stream must end right before the match"
    assert eng.metrics._c_stop_hits.value() == 1


def test_logit_bias_forces_token():
    r = Request(prompt=np.arange(4, dtype=np.int32), max_new=5,
                logit_bias={7: 1000.0})
    assert _run(_surface(), [r])[r.id][4:].tolist() == [7] * 5


def test_logprobs_records_match_reference():
    """One record a generated token; under greedy the chosen token is the
    top alternative; the records (chosen and top 3) are the reference
    engine's within LOGPROB_ATOL, ids equal."""
    kw = dict(n_slots=4, max_total=64, decode_horizon=2, temperature=0.0)

    def make(cls):
        return [cls(id=f"l{i}", prompt=np.arange(4 + i, dtype=np.int32),
                    max_new=6, logprobs=True, top_logprobs=3)
                for i in range(2)]

    je = JEngine(JCFG, _jparams(), sampling_surface=True,
                 adaptive_horizon=False, **kw)
    jreqs, preqs = make(JRequest), make(Request)
    for r in jreqs:
        je.submit(r)
    jres = je.run()
    pres = _run(_surface(**kw), preqs)
    for jr, r in zip(jreqs, preqs):
        got = pres[r.id][len(r.prompt):].tolist()
        assert got == np.asarray(jres[jr.id])[len(jr.prompt):].tolist()
        recs = r.logprobs_out
        assert recs is not None and len(recs) == len(got) == 6
        for tok, rec, jrec in zip(got, recs, jr.logprobs_out):
            assert rec["token"] == tok == jrec["token"]
            assert rec["logprob"] <= 0.0
            assert abs(rec["logprob"] - jrec["logprob"]) <= LOGPROB_ATOL
            tops = rec["top_logprobs"]
            assert [t["token"] for t in tops] == [
                t["token"] for t in jrec["top_logprobs"]]
            for a, b in zip(tops, jrec["top_logprobs"]):
                assert abs(a["logprob"] - b["logprob"]) <= LOGPROB_ATOL
            lps = [t["logprob"] for t in tops]
            assert lps == sorted(lps, reverse=True)
            assert tops[0]["token"] == tok
            assert tops[0]["logprob"] == pytest.approx(rec["logprob"])


def test_per_request_temperature_and_topk_override():
    reqs = _requests(n=4)
    ref = _run(_engine(temperature=0.0), [Request(
        id=r.id, prompt=r.prompt, max_new=r.max_new) for r in reqs])
    greedy = [Request(id=r.id, prompt=r.prompt, max_new=r.max_new,
                      temperature=0.0) for r in reqs]
    _assert_same(ref, _run(_surface(temperature=0.9), greedy))
    topk1 = [Request(id=r.id, prompt=r.prompt, max_new=r.max_new, top_k=1)
             for r in reqs]
    _assert_same(ref, _run(_surface(temperature=0.9), topk1))


@pytest.mark.parametrize("n_slots", [1, 4])
def test_top_k_above_vocab_means_no_filter(n_slots):
    """Every slot asks for a k above the vocabulary (a client may): the
    filter keeps every token, as the reference's per-slot filter does, and
    the stream is the unfiltered sampled one."""
    reqs = _requests(n=4)
    ref = _run(_engine(temperature=0.9, n_slots=n_slots), [Request(
        id=r.id, prompt=r.prompt, max_new=r.max_new) for r in reqs])
    big = [Request(id=r.id, prompt=r.prompt, max_new=r.max_new,
                   top_k=100_000) for r in reqs]
    _assert_same(ref, _run(_surface(temperature=0.9, n_slots=n_slots), big))


def test_top_p_nucleus_collapses_to_greedy():
    ref = _run(_engine(temperature=0.0), _requests(n=4))
    reqs = [Request(id=r.id, prompt=r.prompt, max_new=r.max_new, top_p=1e-9)
            for r in _requests(n=4)]
    _assert_same(ref, _run(_surface(temperature=0.9), reqs))


def test_top_p_one_folds_out_bitwise():
    """top_p 1 (a request that names the default) keeps the base stream."""
    reqs = _requests(n=4)
    ref = _run(_engine(temperature=0.9), [Request(
        id=r.id, prompt=r.prompt, max_new=r.max_new) for r in reqs])
    ones = [Request(id=r.id, prompt=r.prompt, max_new=r.max_new, top_p=1.0)
            for r in reqs]
    _assert_same(ref, _run(_surface(temperature=0.9), ones))


def test_masked_engine_keeps_one_host_sync_per_horizon(monkeypatch):
    """A masked run with every stage in use (a grammar, a bias, per-slot
    top-k and top-p, sampling, logprobs): the only read of a device value
    on the host during the steps is each horizon's aux block. The grammar
    tables and the per-slot rows go up pinned and non-blocking; the FSM
    state is seated by ``fill_``."""
    import torch

    from deeplearning4j_tpu_torch.ops import attention as attention_mod

    eng = _surface(temperature=0.9, decode_horizon=4)
    reqs = _requests(n=3, max_new=8) + [
        Request(id="c", prompt=np.arange(4, dtype=np.int32), max_new=20,
                eos_token=EOS, response_format={"type": "json_schema",
                                                "schema": SCHEMA}),
        Request(id="b", prompt=np.arange(6, dtype=np.int32), max_new=6,
                logit_bias={9: 2.0}, top_k=5, top_p=0.8, logprobs=True,
                top_logprobs=2)]
    for r in reqs:
        eng.submit(r)
    counts = {"reads": 0, "horizons": 0, "quiet": 0}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def f(self, *a, **kw):
            if not counts["quiet"]:
                counts["reads"] += 1
            return orig(self, *a, **kw)
        return f

    for name in ("numpy", "item", "tolist", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    process, scalar = eng._process, pt.dtype_scalar

    def on_process(h):
        counts["horizons"] += 1
        return process(h)

    def quiet_scalar(*a, **kw):  # the attention's host-made scale constant
        counts["quiet"] += 1
        try:
            return scalar(*a, **kw)
        finally:
            counts["quiet"] -= 1

    monkeypatch.setattr(eng, "_process", on_process)
    monkeypatch.setattr(pt, "dtype_scalar", quiet_scalar)
    monkeypatch.setattr(attention_mod, "dtype_scalar", quiet_scalar)
    while not eng.idle:
        eng.step()
    assert counts["horizons"] > 0
    assert counts["reads"] == counts["horizons"]
    assert reqs[-1].logprobs_out and all(
        r.status.value == "finished" for r in reqs)


# -- crash recovery ------------------------------------------------------------


# -- cross-package ---------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_masked_engine_matches_reference(temperature):
    """The port's masked engine against the reference's on the same
    weights, rng_seed and request order: plain, constrained, biased,
    per-request top-k and top-p traffic, K 2. The streams are identical
    (every draw of either takes the same key, and the masks and filters
    are the same functions)."""
    kw = dict(n_slots=4, max_total=64, decode_horizon=2,
              temperature=temperature, rng_seed=5)

    def make(cls):
        reqs = _requests(n=4, max_new=8, cls=cls)
        reqs.append(cls(id="c", prompt=np.arange(4, dtype=np.int32),
                        max_new=30, eos_token=EOS,
                        response_format={"type": "json_schema",
                                         "schema": SCHEMA}))
        reqs.append(cls(id="b", prompt=np.arange(6, dtype=np.int32),
                        max_new=6, logit_bias={9: 2.0}, top_k=5))
        reqs.append(cls(id="p", prompt=np.arange(7, dtype=np.int32),
                        max_new=6, top_p=0.8, temperature=0.7))
        return reqs

    je = JEngine(JCFG, _jparams(), sampling_surface=True,
                 adaptive_horizon=False, **kw)
    jreqs, preqs = make(JRequest), make(Request)
    for r in jreqs:
        je.submit(r)
    jres = je.run()
    pres = _run(_surface(**kw), preqs)
    for jr, r in zip(jreqs, preqs):
        np.testing.assert_array_equal(pres[r.id], np.asarray(jres[jr.id]))


# -- the server ------------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_surface_fields_and_400s():
    """``/v1/generate`` takes the surface fields (a string stop on a byte
    vocabulary, logprobs in the response); an engine without the surface
    answers them 400, as it does a bad response_format."""
    server = ServingServer(_surface(), port=0).start()
    plain = ServingServer(_engine(), port=0).start()
    try:
        base = "http://%s:%d/v1/generate" % server.address
        code, out = _post(base, {
            "prompt": "q: ", "max_new": 8, "eos_token": EOS,
            "response_format": {"type": "regex", "regex": "(yes|no)"}})
        assert code == 200 and out["text"][3:].rstrip("\x7f") in ("yes",
                                                                   "no")
        code, out = _post(base, {"prompt": [1, 2, 3], "max_new": 4,
                                 "logprobs": True, "top_logprobs": 2,
                                 "stop": ["zzz"], "logit_bias": {"7": 3}})
        assert code == 200 and len(out["logprobs"]) == 4
        assert len(out["logprobs"][0]["top_logprobs"]) == 2
        code, out = _post(base, {"prompt": [1, 2], "max_new": 4,
                                 "response_format": {"type": "nope"}})
        assert code == 400
        code, out = _post(base, {"prompt": [1, 2], "max_new": 4,
                                 "stop": 5})
        assert code == 400
        pbase = "http://%s:%d/v1/generate" % plain.address
        code, out = _post(pbase, {"prompt": [1, 2], "max_new": 4,
                                  "top_p": 0.5})
        assert code == 400 and "sampling_surface" in out["error"]
        code, out = _post(pbase, {"prompt": [1, 2], "max_new": 4})
        assert code == 200 and "logprobs" not in out
    finally:
        server.stop()
        plain.stop()
    assert not [t for t in threading.enumerate()
                if t.name == "engine-loop" and t.is_alive()]
