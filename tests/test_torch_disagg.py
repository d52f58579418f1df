"""The port's KV wire at the engine level: export on one engine, ingest on
another, a full hit there; live-session export and seat.

Bars:

- within the port, the transfer path is the monolithic engine byte for
  byte: a prompt exported by a prefill engine and ingested by a decode
  engine with the prefix cache generates with 0 prefill dispatches and the
  stream of an engine that never saw the wire, greedy and T 0.8, in slab,
  paged and int8; across a decode-engine crash too; a session exported
  mid-generation and seated on another engine (another master seed: the
  key travels) finishes with the uninterrupted stream;
- declines are soft and named; the disagg probe passes on the CPU;
- across the packages: the port's export leaves are within 1e-5 of the
  reference's for the same prompt, a frame the reference exported seats in
  the port (0 prefill dispatches) and its stream is the reference's
  monolithic stream, as is a migrated session's, except where a near-tie
  flips a token (the reference's top-2 gap, or its perturbed sampling
  margin, at the first divergence within twice the frameworks' largest
  logit difference there).

The reference's own engine-level transfer tests fail on this CPU (its
ingest needs its prefix probe, which declines here), so the port's
transfer path is held against the port's monolithic engine, and against
the reference's monolithic streams at the near-tie rule. The engines run
with ``prefill_max_bucket=8``: the port's hit grain is the largest bucket,
and a segment shorter than it is not seatable.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import KVExportRequest as JKVExportRequest
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving import disagg as jdisagg
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.serving import (
    FaultInjector,
    KVExportRequest,
    KVIngestRequest,
    KVSessionRequest,
    Request,
    RequestStatus,
    ServingEngine,
    decode_segment,
    encode_segment,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

JCFG = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_len=32)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
CFG8 = dataclasses.replace(CFG, decode_int8=True)
BUCKET = 8
TEMP = 0.8
SLACK = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _engine(params, mode="slab", **kw):
    cfg = CFG
    if mode == "int8":
        cfg, params = CFG8, pt.quantize_decode_params(params, CFG8)
    kw.setdefault("n_slots", 2)
    kw.setdefault("decode_horizon", 2)
    return ServingEngine(cfg, params, device="cpu",
                         prefill_max_bucket=BUCKET, paged=mode == "paged",
                         **kw)


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


def _export(engine, prompt):
    req = _drain_one(engine, KVExportRequest(
        prompt=np.asarray(prompt, np.int32), done=threading.Event()))
    assert req.status == RequestStatus.FINISHED, req.error
    return req.result


def _ingest(engine, frame):
    seg = decode_segment(frame, expect_hash=engine.config_hash)
    req = _drain_one(engine, KVIngestRequest(segment=seg,
                                             done=threading.Event()))
    assert req.status == RequestStatus.FINISHED
    return req.result


def _gen(engine, prompt, max_new=5):
    req = _drain_one(engine, Request(prompt=np.asarray(prompt, np.int32),
                                     max_new=max_new,
                                     done=threading.Event()))
    assert req.status == RequestStatus.FINISHED, req.error
    return engine.pop_result(req.id)


def _prompt(seed, n=16):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 60, n)]


# -- within the port -----------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
@pytest.mark.parametrize("mode", ["slab", "paged", "int8"])
def test_engine_disagg_parity(params, mode, temperature):
    """Prefill on engine A, frame, seat on engine B, decode: the stream of
    a monolithic engine that never saw the wire, and the seated generate
    runs no prefill program (the full hit is a copy)."""
    prompts = [_prompt(7), _prompt(8, 12)]
    kw = dict(temperature=temperature, rng_seed=5)
    pf = _engine(params, mode, **kw)
    dc = _engine(params, mode, prefix_cache=True, **kw)
    mono = _engine(params, mode, **kw)
    # both exports in one run: each must copy its rows out of the slot
    # before the next export reuses it
    exports = [KVExportRequest(prompt=np.asarray(p, np.int32),
                               done=threading.Event()) for p in prompts]
    for r in exports:
        pf.submit(r)
    pf.run()
    for r in exports:
        res = r.result
        assert res["layout"] == ("paged" if mode == "paged" else "slab")
        assert len(res["leaves"]) == (2 if mode == "int8" else 1)
        out = _ingest(dc, _frame(res))
        assert out["stored"], out["reason"]
    assert dc.prefill_dispatches == 0
    got = [_gen(dc, p) for p in prompts]
    assert dc.prefill_dispatches == 0  # full hits: copies
    for g, p in zip(got, prompts):
        np.testing.assert_array_equal(g, _gen(mono, p))
    assert "disagg_wire" in pf.probes_run and "disagg_wire" in dc.probes_run


def test_engine_disagg_parity_across_decode_crash(params):
    """The decode engine crashes after seating a wire segment; replay
    recovery finishes the stream byte for byte."""
    prompt = _prompt(11)
    kw = dict(temperature=TEMP, rng_seed=3, retry_backoff_s=0.001,
              max_backoff_s=0.004)
    pf = _engine(params, **kw)
    dc = _engine(params, prefix_cache=True,
                 faults=FaultInjector().plan("step", at=1, kind="crash"),
                 **kw)
    mono = _engine(params, **kw)
    assert _ingest(dc, _frame(_export(pf, prompt)))["stored"]
    req = Request(prompt=np.asarray(prompt, np.int32), max_new=6,
                  done=threading.Event())
    dc.submit(req)
    dc.run()  # crash, recover, finish
    assert dc.metrics.n_restarts == 1
    assert req.status == RequestStatus.FINISHED, req.error
    np.testing.assert_array_equal(dc.pop_result(req.id),
                                  _gen(mono, prompt, max_new=6))


def test_engine_ingest_declines_are_soft(params):
    """Every decline is ``stored=False`` with a reason and the engine
    serves on: another model's hash (checked at seat time too), no prefix
    cache, a segment shorter than the hit grain; an export that cannot fit
    fails its request alone."""
    eng = _engine(params, prefix_cache=True, temperature=0.0)
    pf = _engine(params, temperature=0.0)
    prompt = _prompt(9)
    frame = _frame(_export(pf, prompt))
    seg = decode_segment(frame)
    seg["config_hash"] = "not-this-model"
    req = _drain_one(eng, KVIngestRequest(segment=seg,
                                          done=threading.Event()))
    assert req.result["stored"] is False and "hash" in req.result["reason"]
    bare = _engine(params, temperature=0.0)
    res = _ingest(bare, frame)
    assert res["stored"] is False and "prefix cache" in res["reason"]
    short = _frame(_export(pf, prompt[:BUCKET - 1]))
    res = _ingest(eng, short)
    assert res["stored"] is False and "not seatable" in res["reason"]
    too_long = _drain_one(pf, KVExportRequest(
        prompt=np.arange(1, CFG.max_len + 1, dtype=np.int32) % 60,
        done=threading.Event()))
    assert too_long.status == RequestStatus.FAILED
    assert "cannot be exported" in too_long.error
    assert eng.metrics.summary()["disagg"]["kv_ingests_declined"] == 2
    np.testing.assert_array_equal(_gen(eng, prompt), _gen(pf, prompt))


@pytest.mark.parametrize("mode", ["slab", "paged", "int8"])
def test_disagg_probe_passes_on_the_cpu(params, mode, tmp_path):
    """The wire probe's verdict on this CPU, persisted under its name: a
    second engine reads it instead of probing."""
    cache = tmp_path / "probes.json"
    eng = _engine(params, mode, probe_cache=str(cache))
    assert eng._disagg_ok() and "disagg_wire" in eng.probes_run
    again = _engine(params, mode, probe_cache=str(cache))
    assert again._disagg_ok()
    assert "disagg_wire" in again.probes_from_cache
    assert "disagg_wire" not in again.probes_run


# -- live sessions within the port ------------------------------------------------


def _step_until_generated(eng, req, n=2, max_steps=500):
    """Step until ``req`` holds at least n tokens and is not finished."""
    for _ in range(max_steps):
        eng.step()
        assert not req.done.is_set(), "finished before the export point"
        for st in eng._slots:
            if st is not None and st.req is req and len(st.tokens) >= n:
                return len(st.tokens)
    raise AssertionError("never reached the export point")


def _seat_request(seg, prompt):
    gen = seg["gen"]
    return KVSessionRequest(
        prompt=[int(t) for t in prompt], max_new=int(gen["max_new"]),
        eos_token=gen.get("eos_token"), segment=seg,
        gen_tokens=tuple(gen["tokens"]),
        key_data=np.asarray(gen["key_data"], np.int64),
        done=threading.Event())


def _export_session(src, prompt, max_new=10):
    req = Request(prompt=np.asarray(prompt, np.int32), max_new=max_new,
                  done=threading.Event())
    src.submit(req)
    _step_until_generated(src, req, n=2)
    sessions = src.export_sessions()
    assert len(sessions) == 1
    assert not req.done.is_set()  # parked, not failed
    assert all(st is None for st in src._slots)  # its slot freed
    return req, sessions[0]


@pytest.mark.parametrize("mode", ["slab", "paged", "int8"])
@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_migration_mid_generation_is_byte_identical(params, mode,
                                                    temperature):
    """A live slot exported mid-generation, framed, seated on an engine
    with another master seed and finished there: the uninterrupted stream,
    and the parked source request settles with it."""
    prompt = _prompt(21, 8)
    kw = dict(temperature=temperature)
    src = _engine(params, mode, rng_seed=5, **kw)
    dst = _engine(params, mode, rng_seed=99, **kw)
    mono = _engine(params, mode, rng_seed=5, **kw)
    req, sess = _export_session(src, prompt)
    seg = decode_segment(_frame(sess, sess["gen"]),
                         expect_hash=dst.config_hash)
    assert seg["gen"]["req_id"] == req.id
    seat = _drain_one(dst, _seat_request(seg, prompt))
    assert seat.status == RequestStatus.FINISHED, seat.error
    assert seat.result["seated"] is True
    migrated = dst.pop_result(seat.id)
    ref = _gen(mono, prompt, max_new=10)
    np.testing.assert_array_equal(migrated, ref)
    src.complete_migrated(sess["req"], migrated,
                          n_streamed=sess["n_streamed"])
    assert req.done.is_set() and req.status == RequestStatus.FINISHED
    np.testing.assert_array_equal(src.pop_result(req.id), ref)
    assert {"migrate_out", "migrate_settled"} <= {
        e[2] for e in src.flight._events}
    assert "migrate_seated" in [e[2] for e in dst.flight._events]
    # the seat split no key: the destination's own next admission draws
    # a fresh seed-99 engine's first key
    fresh = _engine(params, mode, rng_seed=99, **kw)
    np.testing.assert_array_equal(_gen(dst, prompt, 4),
                                  _gen(fresh, prompt, 4))


def test_migration_seat_survives_destination_crash_recovery(params):
    """The destination crashes after seating a sampled session; replay of
    prompt + tokens so far with the migrated key finishes the
    uninterrupted stream."""
    prompt = _prompt(23, 8)
    kw = dict(temperature=TEMP, retry_backoff_s=0.001, max_backoff_s=0.004)
    src = _engine(params, rng_seed=5, **kw)
    dst = _engine(params, rng_seed=99,
                  faults=FaultInjector().plan("step", at=1, kind="crash"),
                  **kw)
    mono = _engine(params, rng_seed=5, **kw)
    req, sess = _export_session(src, prompt)
    seat = _seat_request(decode_segment(_frame(sess, sess["gen"])), prompt)
    dst.submit(seat)
    dst.run()
    assert dst.metrics.n_restarts == 1
    assert seat.status == RequestStatus.FINISHED, seat.error
    np.testing.assert_array_equal(dst.pop_result(seat.id),
                                  _gen(mono, prompt, max_new=10))
    src.fail_migrated(sess["req"], "test over", partial=sess["gen"]["tokens"])
    assert req.status == RequestStatus.CANCELLED


def test_migration_declines_are_soft(params):
    """Another model's hash, a key of the wrong size and a frame that
    disagrees with its claim are declined with ``seated=False`` and a
    reason; the engine serves on."""
    prompt = _prompt(25, 8)
    src = _engine(params, temperature=0.0)
    dst = _engine(params, temperature=0.0)
    req, sess = _export_session(src, prompt, max_new=8)
    seg = decode_segment(_frame(sess, sess["gen"]))
    foreign = dict(seg, config_hash="f" * 64)
    r = _drain_one(dst, _seat_request(foreign, prompt))
    assert r.status == RequestStatus.FAILED
    assert r.result["seated"] is False and "hash" in r.result["reason"]
    bad_key = dict(seg, gen=dict(seg["gen"], key_data=[1, 2, 3, 4, 5, 6]))
    r = _drain_one(dst, _seat_request(bad_key, prompt))
    assert r.result["seated"] is False
    assert "sampling key" in r.result["reason"]
    short = dict(seg, gen=dict(seg["gen"], tokens=seg["gen"]["tokens"][:-1]))
    r = _drain_one(dst, _seat_request(short, prompt))
    assert r.result["seated"] is False and "covers" in r.result["reason"]
    assert "migrate_declined" in [e[2] for e in dst.flight._events]
    assert _gen(dst, prompt, 4) is not None  # still serving
    src.complete_migrated(sess["req"], list(req.prompt))


def test_export_skips_sampling_surface_sessions(params):
    """Sessions that use the sampling surface (grammar state, stop
    hold-back, bias rows do not travel) stay local."""
    eng = _engine(params, temperature=0.0, sampling_surface=True)
    req = Request(prompt=np.asarray(_prompt(27, 8), np.int32), max_new=10,
                  top_k=3, done=threading.Event())
    eng.submit(req)
    _step_until_generated(eng, req, n=2)
    assert eng.export_sessions() == []
    assert any(st is not None and st.req is req for st in eng._slots)


# -- across the packages ------------------------------------------------------------


def _port_logits(params, seq):
    return pt.transformer_apply(CFG)(
        params, torch.as_tensor(np.asarray(seq)[None]).long())[0][0, -1]


def _check_near_tie(jparams, params, ref, got, temperature, key_data):
    """Equal streams, or at the first divergence i a near-tie in the
    reference: its top-2 logit gap (greedy), or its perturbed top-2 margin
    of the draw fold_in(slot key, i) (sampled), within twice the largest
    difference between the two frameworks' logits there."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    diff = np.nonzero(ref != got)[0]
    if not diff.size:
        return None
    i = int(diff[0])
    lg_ref = np.asarray(jt.transformer_apply(JCFG)(
        jparams, jax.numpy.asarray(ref[:i])[None])[0][0, -1], np.float32)
    delta = float(np.abs(_port_logits(params, ref[:i]).numpy()
                         - lg_ref).max())
    if temperature == 0.0:
        top2 = np.sort(lg_ref)[-2:]
        assert top2[1] - top2[0] <= 2 * delta + SLACK, (i, top2, delta)
        return i
    noise = np.asarray(jax.random.gumbel(jax.random.fold_in(
        jax.random.wrap_key_data(np.asarray(key_data, np.uint32)), i),
        (JCFG.vocab_size,)))
    top2 = np.sort(noise + lg_ref / np.float32(temperature))[-2:]
    assert top2[1] - top2[0] <= 2 * delta / temperature + SLACK, (i, delta)
    return i


def _ref_stream(jparams, prompt, max_new, temperature, seed):
    je = JEngine(JCFG, jparams, n_slots=2, temperature=temperature,
                 decode_horizon=2, rng_seed=seed)
    r = JRequest(prompt=np.asarray(prompt, np.int32), max_new=max_new,
                 done=threading.Event())
    je.submit(r)
    return np.asarray(je.run()[r.id])


def test_export_leaves_match_the_references(jparams, params):
    """The port's exported segment (KV rows and logits row) is within 1e-5
    of the reference's for the same prompt, in the same layout."""
    prompt = _prompt(31)
    je = JEngine(JCFG, jparams, n_slots=2, temperature=0.0,
                 decode_horizon=2)
    jr = _drain_one(je, JKVExportRequest(prompt=np.asarray(prompt, np.int32),
                                         done=threading.Event()))
    assert jr.status.value == "finished", jr.error
    mine = _export(_engine(params, temperature=0.0), prompt)
    assert mine["config_hash"] == jr.result["config_hash"]
    n = len(prompt)
    for a, b in zip(mine["leaves"], jr.result["leaves"]):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy()[:, :, :, :n],
                                   np.asarray(b)[:, :, :, :n], atol=1e-5)
    np.testing.assert_allclose(mine["logits"].numpy(),
                               np.asarray(jr.result["logits"]), atol=1e-5)


@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_reference_frame_seats_in_the_port(jparams, params, temperature):
    """A frame the reference's prefill engine exported and framed seats
    in the port's decode engine; the follow-up generate runs no prefill
    program, and its stream is the reference's monolithic stream (or a
    near-tie at the first divergence)."""
    prompt = _prompt(33)
    je = JEngine(JCFG, jparams, n_slots=2, temperature=temperature,
                 decode_horizon=2, rng_seed=5)
    jr = _drain_one(je, JKVExportRequest(prompt=np.asarray(prompt, np.int32),
                                         done=threading.Event()))
    res = jr.result
    frame = jdisagg.encode_segment(
        config_hash=res["config_hash"], tokens=res["tokens"],
        leaves=res["leaves"], logits=res["logits"], layout=res["layout"],
        block_size=res["block_size"])
    dc = _engine(params, prefix_cache=True, temperature=temperature,
                 rng_seed=5)
    out = _ingest(dc, frame)
    assert out["stored"], out["reason"]
    got = _gen(dc, prompt, max_new=8)
    assert dc.prefill_dispatches == 0
    ref = _ref_stream(jparams, prompt, 8, temperature, 5)
    _check_near_tie(jparams, params, ref, got, temperature,
                    threefry.split(threefry.key(5))[1])


@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_migrated_stream_matches_the_references(jparams, params,
                                                temperature):
    """A session migrated between two port engines finishes with the
    reference engine's uninterrupted stream for the same seed (or a
    near-tie at the first divergence)."""
    prompt = _prompt(35, 8)
    src = _engine(params, rng_seed=5, temperature=temperature)
    dst = _engine(params, rng_seed=99, temperature=temperature)
    req, sess = _export_session(src, prompt, max_new=10)
    seat = _drain_one(dst, _seat_request(
        decode_segment(_frame(sess, sess["gen"])), prompt))
    got = dst.pop_result(seat.id)
    ref = _ref_stream(jparams, prompt, 10, temperature, 5)
    _check_near_tie(jparams, params, ref, got, temperature,
                    threefry.split(threefry.key(5))[1])
    src.complete_migrated(sess["req"], got)
