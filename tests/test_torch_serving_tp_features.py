"""Every engine feature of the port under exact tensor parallelism, held
against the same engine at tp 1: the reference's bar for paged
(``tests/test_serving_paged.py:290``), piggyback
(``test_serving_piggyback.py:185``), the grammar surface
(``test_serving_grammar.py:361``) and batched LoRA
(``test_serving_tenancy.py:423``), plus the prefix cache, batched
admission, int8 and the KV wire.

Every TP=2 engine here runs over ``["cpu"] * 2`` and must come up at tp 2
(the parity probe passing); its streams, greedy and T 0.8, are byte-
identical to the TP=1 engine's of the same config; prefix hits give the
bytes of the cache off; int8 KV rows and scales (the sharded pool made
whole) are TP=1's bitwise; a TP=2 engine's exported frame is TP=1's byte
for byte, and each seats the other's.
"""

import dataclasses
import json
import re
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    KVExportRequest,
    KVIngestRequest,
    KVSessionRequest,
    Request,
    RequestStatus,
    ServingEngine,
    decode_segment,
    encode_segment,
)

pytestmark = pytest.mark.tp_serve

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

CFG = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                           d_ff=64, max_len=64, decode_kernel=False)
CFG8 = dataclasses.replace(CFG, decode_int8=True)
#: the grammar surface needs the byte vocabulary's JSON punctuation
GCFG = pt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                            n_kv_heads=2, n_layers=2, d_ff=128, max_len=64,
                            rope=True, decode_kernel=False)
EOS = 127
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "tag": {"enum": ["a", "bb"]}},
          "required": ["ok", "tag"]}
BUCKET = 8
TEMP = 0.8
_P = {}


def _params(cfg=CFG):
    key = cfg.to_json()
    if key not in _P:
        p = pt.init_params(cfg, seed=0, device="cpu")
        if cfg.decode_int8:
            p = pt.quantize_decode_params(p, cfg)
        _P[key] = p
    return _P[key]


def _engine(tp=1, cfg=CFG, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("decode_horizon", 2)
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_max_bucket", BUCKET)
    eng = ServingEngine(cfg, _params(cfg), device="cpu", tp=tp,
                        tp_devices=["cpu"] * tp if tp > 1 else None,
                        retry_backoff_s=0.001, max_backoff_s=0.004, **kw)
    assert eng.tp == tp, eng.probes_run
    return eng


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.id: engine.pop_result(r.id) for r in reqs}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _reqs(seed=0, n=6, lo=3, hi=20, max_new=(4, 9), **kw):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, 60, (int(rng.integers(lo, hi)),))
                    .astype(np.int32), max_new=int(rng.integers(*max_new)),
                    id=f"q{seed}-{i}", **kw)
            for i in range(n)]


def _clone(reqs):
    return [dataclasses.replace(r, prompt=np.array(r.prompt), done=None,
                                stream=None) for r in reqs]


def _tp_vs_tp1(reqs, temperature=0.0, cfg=CFG, **kw):
    """The same requests through a TP=1 and a TP=2 engine: both streams
    and both engines."""
    e1 = _engine(1, cfg, temperature=temperature, **kw)
    e2 = _engine(2, cfg, temperature=temperature, **kw)
    s1 = _run(e1, _clone(reqs))
    s2 = _run(e2, _clone(reqs))
    _same(s1, s2)
    return e1, e2, s1, s2


@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_paged_tp2_parity(temperature):
    """Block-paged (bs 8) at tp 2: the pool's blocks per rank, tables
    uploaded to each rank; the paged probe passes on the sharded programs
    and the streams are TP=1 paged's, and every block comes back."""
    e1, e2, _, _ = _tp_vs_tp1(_reqs(1), temperature, paged=True,
                              block_size=8)
    assert e1._paged and e2._paged
    assert "paged_parity" in e2.probes_run
    assert e2.pool.n_blocks_in_use == 0
    assert len(e2.pool.operand()["tables"]) == 2


@pytest.mark.parametrize("paged", [False, True])
def test_piggyback_tp2_parity(paged):
    """Prompts past one bucket deferred behind decode horizons, chunk by
    chunk, at tp 2: the TP=1 piggyback streams (and those of a blocking
    TP=1 engine)."""
    reqs = _reqs(2, n=6, lo=3, hi=40, max_new=(6, 12))
    e1, e2, s1, _ = _tp_vs_tp1(reqs, TEMP, piggyback=True, paged=paged)
    assert e2.metrics.n_prefill_chunks > 0
    _same(s1, _run(_engine(1, temperature=TEMP, paged=paged),
                   _clone(reqs)))


@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_grammar_surface_tp2_parity(temperature):
    """The masked step at tp 2 (its probe passing): a regex and a JSON
    schema request beside plain ones give TP=1's streams; the constrained
    outputs end in EOS and parse."""
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(1, 100, (6,)).astype(np.int32),
                    max_new=8, id=f"plain{i}") for i in range(2)]
    reqs += [Request(prompt=np.arange(4, dtype=np.int32), max_new=12,
                     eos_token=EOS, id="re",
                     response_format={"type": "regex",
                                      "regex": "(yes|no)[0-9]{1,3}"}),
             Request(prompt=np.arange(5, dtype=np.int32), max_new=24,
                     eos_token=EOS, id="js",
                     response_format={"type": "json_schema",
                                      "schema": SCHEMA})]
    e1, e2, _, s2 = _tp_vs_tp1(reqs, temperature, cfg=GCFG,
                               sampling_surface=True)
    assert e2._surface and "masked_parity" in e2.probes_run
    out = {}
    for r in reqs[2:]:
        gen = s2[r.id][len(r.prompt):]
        assert gen[-1] == EOS, gen
        out[r.id] = bytes(gen[:-1].astype(np.uint8))
    assert re.fullmatch(rb"(yes|no)[0-9]{1,3}", out["re"])
    assert set(json.loads(out["js"].decode())) == {"ok", "tag"}


@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_lora_bank_tp2_parity(temperature):
    """A bank of 4 adapters (rank 2) sharded with the params (B factors on
    their output dim): a mixed batch over adapters 0-3 gives TP=1's
    streams, and adapter 0 greedy the bank-free model's (the probe passing
    on the sharded programs)."""
    bank = pt.init_lora_bank(1, CFG, 4, 2, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 64, (7,)).astype(np.int32)
    reqs = [Request(prompt=prompt.copy(), max_new=6, adapter=a, id=f"a{a}")
            for a in (1, 2, 3, 0)]
    e1, e2, _, s2 = _tp_vs_tp1(reqs, temperature, lora_bank=bank)
    assert e2.n_adapters == 4 and "lora_zero" in e2.probes_run
    assert isinstance(e2.params["lora"]["b_q"], tuple)
    assert len({s2[f"a{a}"].tobytes() for a in range(4)}) > 1
    if temperature == 0.0:  # sampled, a0's key is the fourth split
        base = _run(_engine(2), [Request(prompt=prompt.copy(), max_new=6,
                                         id="a0")])
        np.testing.assert_array_equal(base["a0"], s2["a0"])


def test_batched_admission_tp2_parity():
    """Four same-bucket misses in one admission round: one batched
    prefill program at tp 2 (its probe passing), TP=1's streams."""
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, 64, (6 + i % 3,)).astype(
        np.int32), max_new=5, id=f"b{i}") for i in range(4)]
    e1, e2, _, _ = _tp_vs_tp1(reqs, batch_admission="auto")
    assert e2.batch_verdicts == {("miss", 8, 4): True}
    assert e2.prefill_dispatches == e1.prefill_dispatches == 1
    assert e2.metrics.n_batched_admissions == 4


def _prefix_traffic():
    a = np.arange(1, 21, dtype=np.int32)
    b = np.arange(30, 42, dtype=np.int32)
    return [Request(prompt=p, max_new=5, id=f"x{i}") for i, p in enumerate(
        [a, b, a.copy(), np.concatenate([a, [60, 61, 62, 63]]), b.copy(),
         np.concatenate([a[:17], [5, 6, 7, 8, 9]])])]


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_hits_tp2_same_bytes_as_cache_off(paged):
    """The prefix cache at tp 2 (its probe passing on the sharded
    programs): full and partial hits, the region (slab) or the aliased
    blocks (paged) sharded, the bytes of the cache off and of TP=1 with
    the cache on."""
    def drive(eng):
        out = {}
        for r in _clone(_prefix_traffic()):
            out.update(_run(eng, [r]))
        return out

    off = drive(_engine(2, paged=paged))
    e1 = _engine(1, paged=paged, prefix_cache=True)
    e2 = _engine(2, paged=paged, prefix_cache=True)
    _same(off, drive(e2))
    _same(drive(e1), off)
    assert e2.metrics.n_prefix_hits_full >= 2
    assert e2.metrics.n_prefix_hits_partial >= 1
    assert e2.metrics.prefix_tokens_saved == e1.metrics.prefix_tokens_saved


def test_int8_full_tp2_rows_and_scales_bitwise():
    """int8 weights and the int8 KV cache at tp 2: one row scale across
    every rank's heads (a cross-rank max), so after a run the pool made
    whole holds TP=1's int8 rows and scale plane bitwise, and each rank's
    scale plane is the same; streams TP=1's."""
    reqs = _reqs(4, n=4, max_new=(3, 6))
    e1, e2, _, _ = _tp_vs_tp1(reqs, TEMP, cfg=CFG8, decode_horizon=1)
    whole = pt.unshard_cache(e2.pool.caches)
    assert torch.equal(whole["kv"], e1.pool.caches["kv"])
    assert torch.equal(whole["scale"], e1.pool.caches["scale"])
    sc = e2.pool.caches["scale"]
    assert torch.equal(sc[0], sc[1]) and sc[0].abs().sum() > 0


def _drain_one(engine, req, max_steps=500):
    engine.submit(req)
    for _ in range(max_steps):
        engine.step()
        if req.done.is_set():
            return req
    raise AssertionError(f"request {req.id} never finished")


def _frame(res: dict, gen=None) -> bytes:
    return encode_segment(config_hash=res["config_hash"],
                          tokens=res["tokens"], leaves=res["leaves"],
                          logits=res["logits"], layout=res["layout"],
                          block_size=res["block_size"], gen=gen)


@pytest.mark.parametrize("mode", ["slab", "paged", "int8"])
def test_export_frame_byte_equal_and_seats_both_ways(mode):
    """A TP=2 engine's exported frame is TP=1's byte for byte (rank order
    is head order); a TP=1 frame seats in a TP=2 decode engine and a TP=2
    frame in a TP=1 one, and each follow-up full-hits (0 prefill
    dispatches) with the monolithic stream."""
    cfg = CFG8 if mode == "int8" else CFG
    kw = dict(cfg=cfg, paged=mode == "paged", temperature=TEMP, rng_seed=5)
    prompt = np.random.default_rng(31).integers(1, 60, 16).astype(np.int32)
    frames = {}
    for tp in (1, 2):
        req = _drain_one(_engine(tp, **kw), KVExportRequest(
            prompt=prompt.copy(), done=threading.Event()))
        assert req.status == RequestStatus.FINISHED, req.error
        frames[tp] = _frame(req.result)
    assert frames[1] == frames[2]
    mono = _run(_engine(1, **kw), [Request(prompt=prompt.copy(), max_new=6,
                                           id="m")])["m"]
    for src, dst in ((1, 2), (2, 1)):
        dc = _engine(dst, prefix_cache=True, **kw)
        seg = decode_segment(frames[src], expect_hash=dc.config_hash)
        ing = _drain_one(dc, KVIngestRequest(segment=seg,
                                             done=threading.Event()))
        assert ing.result["stored"], ing.result["reason"]
        got = _drain_one(dc, Request(prompt=prompt.copy(), max_new=6,
                                     done=threading.Event()))
        assert dc.prefill_dispatches == 0
        np.testing.assert_array_equal(dc.pop_result(got.id), mono)


@pytest.mark.parametrize("src_tp,dst_tp", [(2, 1), (1, 2)])
def test_session_migrates_across_widths(src_tp, dst_tp):
    """A live session exported mid-generation by one width and seated by
    the other (another master seed: the key travels) finishes with the
    uninterrupted stream, sampled."""
    prompt = np.random.default_rng(35).integers(1, 60, 8).astype(np.int32)
    src = _engine(src_tp, temperature=TEMP, rng_seed=5)
    dst = _engine(dst_tp, temperature=TEMP, rng_seed=99)
    req = Request(prompt=prompt.copy(), max_new=10, done=threading.Event())
    src.submit(req)
    while not any(st is not None and st.req is req and len(st.tokens) >= 2
                  for st in src._slots):
        src.step()
    sess, = src.export_sessions()
    seg = decode_segment(_frame(sess, sess["gen"]),
                         expect_hash=dst.config_hash)
    gen = seg["gen"]
    seat = _drain_one(dst, KVSessionRequest(
        prompt=[int(t) for t in prompt], max_new=int(gen["max_new"]),
        eos_token=gen.get("eos_token"), segment=seg,
        gen_tokens=tuple(gen["tokens"]),
        key_data=np.asarray(gen["key_data"], np.int64),
        done=threading.Event()))
    ref = _run(_engine(1, temperature=TEMP, rng_seed=5),
               [Request(prompt=prompt.copy(), max_new=10, id="u")])["u"]
    np.testing.assert_array_equal(dst.pop_result(seat.id), ref)
