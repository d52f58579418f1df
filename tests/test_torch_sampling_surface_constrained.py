"""The sampling surface's constrained decoding on the port's engine:
validity of regex and JSON-schema outputs, greedy and sampled, and crash
recovery with constrained, stop, bias and logprob traffic in flight (the
engine cases of ``tests/test_serving_grammar.py``; split from
``test_torch_sampling_surface.py``, whose model and helpers it uses, so
that the test run spreads the two files over its workers)."""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.serving import FaultInjector, Request
from deeplearning4j_tpu_torch.serving.grammar import validate_json_value
from test_torch_sampling_surface import (
    EOS,
    SCHEMA,
    _assert_same,
    _decode,
    _generated,
    _requests,
    _run,
    _seeded_schemas,
    _surface,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)


@pytest.mark.parametrize("temperature", [None, 0.9])
def test_constrained_tokens_all_dfa_permitted(temperature):
    eng = _surface(temperature=0.0)
    r = Request(prompt=np.arange(4, dtype=np.int32), max_new=20,
                eos_token=EOS, temperature=temperature,
                response_format={"type": "regex",
                                 "regex": "(yes|no|maybe)!?"})
    res = _run(eng, [r])
    toks = _generated(res[r.id], r)
    assert toks, "constrained stream emitted nothing"
    cg = r._grammar
    s = cg.start
    for t in toks:
        assert cg.trans[s, t] >= 0, f"token {t} not permitted at {s}"
        s = int(cg.trans[s, t])
    assert cg.accepting[s]
    assert _decode(toks) in ("yes", "no", "maybe", "yes!", "no!", "maybe!")


@pytest.mark.parametrize("temperature", [None, 0.9])
def test_constrained_json_schema_parses_and_validates(temperature):
    eng = _surface(temperature=0.0, decode_horizon=4)
    r = Request(prompt=np.arange(4, dtype=np.int32), max_new=30,
                eos_token=EOS, temperature=temperature,
                response_format={"type": "json_schema", "schema": SCHEMA})
    res = _run(eng, [r])
    assert validate_json_value(json.loads(_decode(_generated(res[r.id], r))),
                               SCHEMA)


@pytest.mark.parametrize("temperature", [None, 0.9])
def test_twenty_seeded_schemas_validate(temperature):
    """The reference suite's 20 seeded schemas, greedy and sampled, in one
    engine (grammars seated and released side by side): every output
    parses and validates."""
    schemas = _seeded_schemas()
    eng = _surface(temperature=0.0, decode_horizon=4)
    reqs = [Request(id=f"s{i}", prompt=np.arange(3, dtype=np.int32),
                    max_new=52, eos_token=EOS, temperature=temperature,
                    response_format={"type": "json_schema", "schema": sc})
            for i, sc in enumerate(schemas)]
    res = _run(eng, reqs)
    for r, sc in zip(reqs, schemas):
        value = json.loads(_decode(_generated(res[r.id], r)))
        assert validate_json_value(value, sc), (sc, value)
    assert eng._gtable.rows_used >= 1


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("crash_at", [2, 4])
def test_crash_recovery_constrained_byte_parity(temperature, crash_at):
    """A crash with constrained, stop, bias and logprobs traffic in flight:
    recovery re-seats the FSM states (re-walked from the seat state over
    the recorded tokens), the stop matchers and the bias rows, and the
    streams and logprob records are the no-fault run's."""
    schema = {"type": "object",
              "properties": {"k": {"enum": ["x", "yy", "zzz"]}},
              "required": ["k"]}

    def make_reqs():
        reqs = _requests(n=4, max_new=8)
        reqs.append(Request(
            id="cons", prompt=np.arange(4, dtype=np.int32), max_new=20,
            eos_token=EOS, temperature=temperature or None,
            response_format={"type": "json_schema", "schema": schema}))
        reqs.append(Request(id="bias", prompt=np.arange(6, dtype=np.int32),
                            max_new=6, logit_bias={9: 5.0}, logprobs=True))
        reqs.append(Request(id="stop", prompt=np.arange(5, dtype=np.int32),
                            max_new=8, stop=[[5, 6]]))
        return reqs

    ref_reqs = make_reqs()
    ref = _run(_surface(temperature=temperature), ref_reqs)
    eng = _surface(temperature=temperature,
                   faults=FaultInjector().plan("step", crash_at, "crash"))
    reqs = make_reqs()
    got = _run(eng, reqs, max_restarts=5)
    _assert_same(ref, got)
    assert eng.metrics.n_restarts >= 1, "crash never fired"
    assert reqs[5].logprobs_out == ref_reqs[5].logprobs_out
    value = json.loads(_decode(_generated(got["cons"], reqs[4])))
    assert validate_json_value(value, schema)
