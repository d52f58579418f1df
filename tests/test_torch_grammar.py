"""The port's grammar module (``serving/grammar.py``, a copy that imports
only the standard library and numpy) against the reference's: the same
token tables, bitwise, for the reference tests' regexes and schemas; and
the unit and admission cases of ``tests/test_serving_grammar.py``
(:138-:299) on the port: DFA permissions, schema lowering and validation,
the compile cache in memory and on disk, the combined table's seat,
release and eviction, the stop matcher, request validation, and the
engine's submit-time gates."""

import numpy as np
import pytest

from deeplearning4j_tpu.serving import grammar as jg
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import Request, ServingEngine
from deeplearning4j_tpu_torch.serving import grammar as pg
from deeplearning4j_tpu_torch.serving.grammar import (
    GrammarBudgetError,
    GrammarCache,
    GrammarTable,
    StopMatcher,
    compile_json_schema,
    compile_regex,
    default_token_bytes,
    schema_to_regex,
    validate_json_value,
)
from deeplearning4j_tpu_torch.serving.scheduler import AdmissionError

CFG = pt.TransformerConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_len=64, rope=True, decode_kernel=False,
)
EOS = 127
TOKEN_BYTES = default_token_bytes(CFG.vocab_size)

#: the reference grammar tests' regexes, and a few of this suite's
REGEXES = ["(yes|no)", "(a|b)c*", "aaaa", "bbbb", "(yes|no|maybe)!?",
           "[a-c]{2,5}", "-?[0-9]{1,3}", "[A-Z][a-z]{1,4}",
           "(0|[1-9][0-9]?)", r"\d+\.\d*", "x(ab)*y", "[^\n]{0,3}"]


def _seeded_schemas(n=20, seed=7):
    """The reference suite's 20 seeded schemas (its slow test's generator)."""
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


SCHEMAS = [
    {"type": "object", "properties": {"ok": {"type": "boolean"},
                                      "tag": {"enum": ["a", "b"]}},
     "required": ["ok", "tag"]},
    {"type": "object", "properties": {"ok": {"type": "boolean"},
                                      "tag": {"enum": ["a", "bb"]}},
     "required": ["ok", "tag"]},
    {"type": "object", "properties": {"k": {"enum": ["x", "yy", "zzz"]}},
     "required": ["k"]},
    {"type": "object", "properties": {"n": {"type": "integer"},
                                      "s": {"type": "string"}},
     "required": ["n"]},
] + _seeded_schemas()


def _same_tables(a, b):
    assert a.key == b.key and a.start == b.start
    assert a.eos_token == b.eos_token
    np.testing.assert_array_equal(a.trans, b.trans)
    np.testing.assert_array_equal(a.mask_words, b.mask_words)
    np.testing.assert_array_equal(a.accepting, b.accepting)
    assert a.mask_words.dtype == b.mask_words.dtype == np.uint32


@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_tables_match_reference(pattern):
    _same_tables(compile_regex(pattern, TOKEN_BYTES, EOS),
                 jg.compile_regex(pattern, TOKEN_BYTES, EOS))


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_tables_match_reference(i):
    schema = SCHEMAS[i]
    assert schema_to_regex(schema) == jg.schema_to_regex(schema)
    _same_tables(compile_json_schema(schema, TOKEN_BYTES, EOS),
                 jg.compile_json_schema(schema, TOKEN_BYTES, EOS))


def test_tables_match_reference_at_full_vocab():
    """GPT-2-small's vocabulary: only tokens below 256 have bytes."""
    tb = default_token_bytes(50304)
    _same_tables(compile_json_schema(SCHEMAS[0], tb, 0),
                 jg.compile_json_schema(SCHEMAS[0], tb, 0))


def test_module_imports_only_stdlib_and_numpy():
    import ast
    from pathlib import Path

    tree = ast.parse(Path(pg.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert roots <= {"__future__", "hashlib", "json", "os", "tempfile",
                     "threading", "collections", "numpy"}, roots
    for name in ("MAX_LOGIT_BIAS", "MAX_TOP_LOGPROBS", "MAX_STOP_SEQUENCES",
                 "MAX_STOP_LEN", "DEFAULT_MAX_STATES"):
        assert getattr(pg, name) == getattr(jg, name)


# -- grammar units (tests/test_serving_grammar.py :138-:240) ------------------

def test_regex_dfa_token_permissions():
    cg = compile_regex("(yes|no)", TOKEN_BYTES, EOS)
    start = cg.start
    permitted = {t for t in range(128) if cg.trans[start, t] >= 0}
    assert permitted == {ord("y"), ord("n")}
    s = start
    for b in b"no":
        assert cg.trans[s, b] >= 0
        s = int(cg.trans[s, b])
    assert cg.accepting[s]
    assert cg.trans[s, EOS] == s, "EOS must self-loop at accepting"
    assert cg.trans[start, EOS] < 0, "EOS permitted before accepting"


def test_schema_to_regex_and_validator():
    schema = SCHEMAS[0]
    pat = schema_to_regex(schema)
    cg = compile_json_schema(schema, TOKEN_BYTES, EOS)
    assert cg.n_states > 1
    assert pat.startswith("\\{")
    assert validate_json_value({"ok": True, "tag": "a"}, schema)
    assert not validate_json_value({"ok": 1, "tag": "a"}, schema)
    assert not validate_json_value({"ok": True, "tag": "z"}, schema)


def test_grammar_cache_memory_and_disk(tmp_path):
    """A fresh compile is a miss, the second lookup hits memory, a new
    cache over the same directory hits disk; the reference's cache reads
    the port's files (the same on-disk format)."""
    path = str(tmp_path / "grammars")
    c1 = GrammarCache(path)
    cg1, how1 = c1.get_or_compile("regex", "(a|b)c*", TOKEN_BYTES, EOS)
    assert how1 == "miss"
    cg2, how2 = c1.get_or_compile("regex", "(a|b)c*", TOKEN_BYTES, EOS)
    assert how2 == "hit" and cg2 is cg1
    c2 = GrammarCache(path)
    cg3, how3 = c2.get_or_compile("regex", "(a|b)c*", TOKEN_BYTES, EOS)
    assert how3 == "hit", "on-disk entry not found by a fresh cache"
    _same_tables(cg3, cg1)
    cg4, how4 = jg.GrammarCache(path).get_or_compile(
        "regex", "(a|b)c*", TOKEN_BYTES, EOS)
    assert how4 == "hit"
    _same_tables(cg4, cg1)


def test_grammar_table_seat_release_evict():
    a = compile_regex("aaaa", TOKEN_BYTES, EOS)
    b = compile_regex("bbbb", TOKEN_BYTES, EOS)
    big = compile_regex("cccc", TOKEN_BYTES, EOS)
    assert big.n_states == a.n_states
    gt = GrammarTable(1 + a.n_states + b.n_states, CFG.vocab_size)
    assert gt.allows(0, 5) and gt.advance(0, 5) == 0  # sentinel
    sa = gt.seat(a)
    assert sa >= 1
    assert gt.seat(a) == sa, "re-seat must return the same start"
    v0 = gt.version
    gt.release(a.key)
    gt.release(a.key)
    assert gt.base_of(a.key) is not None
    gt.seat(b)
    gt.seat(big)  # must evict a (refcount 0) to fit
    assert gt.base_of(a.key) is None
    assert gt.version > v0
    with pytest.raises(GrammarBudgetError):
        gt.seat(compile_regex("dddd", TOKEN_BYTES, EOS))
    with pytest.raises(GrammarBudgetError):
        gt.seat(compile_regex("e" * (gt.capacity + 4), TOKEN_BYTES, EOS))


def test_stop_matcher_holdback_and_flush():
    m = StopMatcher([[5, 6]])
    assert m.push(1) == ([1], 0)
    assert m.push(5) == ([], 0), "possible stop prefix must be held"
    assert m.push(6) == ([], 2), "match strips the stop sequence"
    m2 = StopMatcher([[5, 6]])
    m2.push(5)
    assert m2.push(7) == ([5, 7], 0), "failed prefix is released"
    m3 = StopMatcher([[5, 6]])
    m3.push(5)
    assert m3.flush() == [5]


def test_request_field_validation():
    p = np.arange(4, dtype=np.int32)
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, temperature=-0.5)
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, top_k=0)
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, top_p=0.0)
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, logit_bias={i: 1.0 for i in range(9)})
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, stop=[[1]] * 5)
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, stop=[list(range(17))])
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, top_logprobs=9)
    with pytest.raises(AdmissionError):
        Request(prompt=p, max_new=2, response_format={"type": "nope"})
    r = Request(prompt=p, max_new=2, top_logprobs=3)
    assert r.logprobs, "top_logprobs must imply logprobs"
    assert r.uses_sampling_surface
    assert not Request(prompt=p, max_new=2).uses_sampling_surface


# -- admission gates (:243-:299) ---------------------------------------------

_PARAMS = []


def _engine(surface=False, **kw):
    if not _PARAMS:
        _PARAMS.append(pt.init_params(CFG, seed=0, device="cpu"))
    kw.setdefault("temperature", 0.0)
    return ServingEngine(CFG, _PARAMS[0], n_slots=4, max_total=64,
                         decode_horizon=2, prefill_max_bucket=8,
                         sampling_surface=surface, device="cpu", **kw)


def test_plain_engine_rejects_surface_requests():
    eng = _engine()
    with pytest.raises(AdmissionError):
        eng.submit(Request(prompt=np.arange(4, dtype=np.int32), max_new=2,
                           top_p=0.5))


def test_constrained_requires_eos_token():
    eng = _engine(surface=True)
    assert eng._surface
    with pytest.raises(AdmissionError):
        eng.submit(Request(
            prompt=np.arange(4, dtype=np.int32), max_new=4,
            response_format={"type": "regex", "regex": "(yes|no)"}))


def test_approx_top_k_disables_surface(caplog):
    eng = _engine(surface=True, temperature=0.9, top_k=8, approx_top_k=True)
    assert not eng._surface
    assert "sampling_surface_disabled" in caplog.text
    with pytest.raises(AdmissionError):
        eng.submit(Request(prompt=np.arange(4, dtype=np.int32), max_new=2,
                           top_k=3))


def test_compile_budget_overflow_rejected():
    eng = _engine(surface=True, grammar_states=8)
    with pytest.raises(AdmissionError):
        eng.submit(Request(
            prompt=np.arange(4, dtype=np.int32), max_new=8, eos_token=EOS,
            response_format={"type": "regex", "regex": "a" * 64}))
    assert eng.metrics._c_grammar_compiles.value(result="error") == 1
    reqs = [Request(prompt=np.arange(3 + i, dtype=np.int32), max_new=4)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    assert all(len(res[r.id]) == len(r.prompt) + 4 for r in reqs)


def test_compile_cache_hit_miss_metrics():
    eng = _engine(surface=True)
    rf = {"type": "regex", "regex": "(yes|no)"}
    reqs = [Request(prompt=np.arange(4, dtype=np.int32), max_new=8,
                    eos_token=EOS, response_format=rf) for _ in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    m = eng.metrics._c_grammar_compiles
    assert m.value(result="miss") == 1
    assert m.value(result="hit") == 2
    assert "serve_grammar_compiles_total" in eng.metrics.render_prometheus()
    assert "serve_grammar_table_rows" in eng.metrics.render_prometheus()
