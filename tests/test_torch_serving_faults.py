"""Fault supervision and crash recovery of the port's serving engine and
server: the counterparts of ``tests/test_serving_faults.py``'s chaos cases.

The bar is the reference's: under scripted and seeded faults the greedy
(and sampled) streams are byte-identical to an unfaulted engine's. A
transient fault is retried, a persistent one escalates, a permanent one
fails only its request, and a crash is recovered by replay (stepwise,
chunked, or as the "auto" probe decides) from host records alone. The
port's ``FaultInjector`` is a copy of the reference's and must fire the
same sequence for a seed. Across frameworks, the port's greedy streams
replayed after the same scripted crashes (stepwise and chunked) equal the
reference engine's on the same weights, except where a near-tie flips a
token.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving import faults as jfaults
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import faults as pfaults
from deeplearning4j_tpu_torch.serving import (
    EngineCrash,
    FaultInjector,
    PermanentFault,
    Request,
    RequestStatus,
    ServingEngine,
    ServingServer,
    TransientFault,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

CFG = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                           d_ff=64, max_len=32)
# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this (f32 logits agree to ~1e-5 here)
NEAR_TIE = 1e-4
_PARAMS = {}


def _params(cfg=CFG):
    key = cfg.to_json()
    if key not in _PARAMS:
        _PARAMS[key] = pt.init_params(cfg, seed=0, device="cpu")
    return _PARAMS[key]


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tp = int(rng.integers(3, 10))
        out.append(Request(
            prompt=rng.integers(0, CFG.vocab_size, (tp,)).astype(np.int32),
            max_new=int(rng.integers(4, 12)),
        ))
    return out


def _clone(reqs):
    """Same prompts and budgets, fresh ids and state."""
    return [Request(prompt=r.prompt.copy(), max_new=r.max_new) for r in reqs]


def _engine(faults=None, n_slots=2, cfg=CFG, **kw):
    kw.setdefault("temperature", 0.0)
    return ServingEngine(cfg, _params(cfg), n_slots=n_slots, device="cpu",
                         faults=faults, retry_backoff_s=0.001,
                         max_backoff_s=0.004, **kw)


def _run(engine, reqs, **run_kw):
    for r in reqs:
        engine.submit(r)
    return engine.run(**run_kw)


def _assert_parity(clean_reqs, clean, faulted_reqs, faulted):
    for a, b in zip(clean_reqs, faulted_reqs):
        np.testing.assert_array_equal(clean[a.id], faulted[b.id])


# -- the injector ------------------------------------------------------------

def _fire_sequence(mod, seed):
    inj = mod.FaultInjector(seed, transient_rate=0.1, permanent_rate=0.05,
                            crash_rate=0.05, max_faults=40)
    inj.plan("step", at=3, kind="crash").plan("prefill", at=2, times=3,
                                              req_id="r9")
    out = []
    for i in range(400):
        site = ("step", "prefill", "other")[i % 3]
        try:
            inj.check(site, req_id=f"r{i}")
            out.append(None)
        except Exception as e:  # noqa: BLE001 (the fault is the record)
            out.append((type(e).__name__, str(e), getattr(e, "req_id", None)))
    return out, inj.n_raised


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_injector_fires_the_reference_sequence(seed):
    got, want = _fire_sequence(pfaults, seed), _fire_sequence(jfaults, seed)
    assert got == want
    assert sum(x is not None for x in got[0]) > 10


def test_fault_injector_rules():
    with pytest.raises(ValueError):
        FaultInjector(transient_rate=0.6, crash_rate=0.5)
    with pytest.raises(ValueError):
        FaultInjector().plan("step", 0, kind="nope")
    inj = FaultInjector().plan("step", 1, "permanent", req_id="x")
    inj.check("step")
    with pytest.raises(PermanentFault) as e:
        inj.check("step")
    assert e.value.req_id == "x"
    with pytest.raises(TransientFault):
        FaultInjector().plan("prefill", 0).check("prefill")


# -- retries and replay --------------------------------------------------------

def test_transient_faults_byte_identical_parity():
    reqs = _requests(6, seed=7)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    inj = (FaultInjector()
           .plan("step", at=2, kind="transient")
           .plan("step", at=6, kind="transient")
           .plan("prefill", at=1, kind="transient"))
    engine = _engine(inj)
    faulted = _run(engine, reqs2)
    _assert_parity(reqs, clean, reqs2, faulted)
    assert engine.metrics.n_retries == 3
    assert engine.metrics.n_restarts == 0
    assert all(r.status is RequestStatus.FINISHED for r in reqs2)


def test_seeded_transients_byte_identical_parity():
    """Transient faults at rate 0.05 (seed 0) at both sites."""
    reqs = _requests(8, seed=2)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    engine = _engine(FaultInjector(0, transient_rate=0.05))
    _assert_parity(reqs, clean, reqs2, _run(engine, reqs2))
    assert engine.metrics.n_retries > 0


@pytest.mark.parametrize("paged", [False, True])
def test_engine_crash_recovers_via_replay_zero_dropped(paged):
    """Crashes with slots mid-decode at mixed depths and requests still
    queued: every stream finishes byte-identical, none dropped."""
    reqs = _requests(8, seed=3)
    clean = _run(_engine(paged=paged), reqs)
    reqs2 = _clone(reqs)
    inj = (FaultInjector()
           .plan("step", at=5, kind="crash")
           .plan("step", at=11, kind="crash"))
    engine = _engine(inj, paged=paged)
    faulted = _run(engine, reqs2)
    assert len(faulted) == len(clean) == len(reqs)
    _assert_parity(reqs, clean, reqs2, faulted)
    assert engine.metrics.n_restarts == 2
    assert engine.last_recover_mode == "stepwise"
    if paged:
        assert engine.pool.n_blocks_in_use == 0


def test_persistent_transient_escalates_to_replay():
    reqs = _requests(4, seed=5)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    inj = FaultInjector().plan("step", at=1, kind="transient", times=4)
    engine = _engine(inj, max_retries=2)
    _assert_parity(reqs, clean, reqs2, _run(engine, reqs2))
    # the retry budget burned (3 raises), the 4th raise after recovery is
    # retried afresh
    assert engine.metrics.n_retries == 4
    assert engine.metrics.n_restarts == 1


def test_unsupervised_crash_propagates():
    engine = _engine(FaultInjector().plan("step", at=0, kind="crash"))
    engine.submit(_requests(1, seed=9)[0])
    with pytest.raises(EngineCrash):
        engine.run(max_restarts=0)


def test_crash_at_prefill_requeues_and_recovers():
    """A crash at an admission's fault check: the round's unseated
    requests go back to the queue front in order and replay keeps every
    stream."""
    reqs = _requests(6, seed=41)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    engine = _engine(FaultInjector().plan("prefill", at=3, kind="crash"))
    _assert_parity(reqs, clean, reqs2, _run(engine, reqs2))
    assert engine.metrics.n_restarts == 1


# -- quarantine --------------------------------------------------------------

def test_permanent_prefill_fault_fails_only_poisoned_request():
    reqs = _requests(5, seed=11)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    reqs2[2].done = threading.Event()
    engine = _engine(FaultInjector().plan("prefill", at=2, kind="permanent"))
    faulted = _run(engine, reqs2)
    poisoned = reqs2[2]  # admissions are FIFO: 3rd prefill = 3rd submit
    assert poisoned.status is RequestStatus.FAILED
    assert poisoned.done.is_set()
    assert "permanent" in poisoned.error
    assert poisoned.id not in faulted
    for a, b in zip(reqs, reqs2):
        if b is not poisoned:
            np.testing.assert_array_equal(clean[a.id], faulted[b.id])
    assert engine.metrics.n_failed == 1
    assert engine.pool.n_active == 0 and engine.pool.n_free == 2


def test_step_fault_naming_request_quarantines_it():
    reqs = _requests(3, seed=13)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    inj = FaultInjector().plan("step", at=1, kind="transient", times=3,
                               req_id=reqs2[0].id)
    engine = _engine(inj, max_retries=2)
    faulted = _run(engine, reqs2)
    assert reqs2[0].status is RequestStatus.FAILED
    assert engine.metrics.n_failed == 1
    assert engine.metrics.n_restarts == 0
    for a, b in zip(reqs[1:], reqs2[1:]):
        np.testing.assert_array_equal(clean[a.id], faulted[b.id])


def test_permanent_step_fault_naming_no_request_crashes():
    reqs = _requests(3, seed=14)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    engine = _engine(FaultInjector().plan("step", at=2, kind="permanent",
                                          req_id="nobody"))
    _assert_parity(reqs, clean, reqs2, _run(engine, reqs2))
    assert engine.metrics.n_restarts == 1


# -- horizons, sampling, the in-flight horizon --------------------------------

@pytest.mark.parametrize("horizon", [2, 4])
def test_chaos_parity_at_multi_step_horizon(horizon):
    reqs = _requests(6, seed=23)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    inj = (FaultInjector()
           .plan("step", at=1, kind="transient")
           .plan("step", at=3, kind="crash"))
    engine = _engine(inj, decode_horizon=horizon)
    _assert_parity(reqs, clean, reqs2, _run(engine, reqs2))
    assert engine.metrics.n_retries == 1
    assert engine.metrics.n_restarts == 1
    assert all(r.status is RequestStatus.FINISHED for r in reqs2)


def test_sampled_crash_recovery_keeps_the_noise_stream():
    """Each slot's seed is drawn at admission and kept on the host; token
    i's noise is a function of (seed, position): after replay the sampled
    stream resumes exactly."""
    def build(faults=None):
        return _engine(faults, n_slots=3, temperature=0.8, top_k=8,
                       rng_seed=21)

    reqs = _requests(6, seed=17)
    clean = _run(build(), reqs)
    for crash_at in (1, 3):
        reqs2 = _clone(reqs)
        engine = build(FaultInjector().plan("step", at=crash_at,
                                            kind="crash"))
        faulted = _run(engine, reqs2)
        assert engine.metrics.n_restarts == 1
        assert all(r.status is RequestStatus.FINISHED for r in reqs2)
        _assert_parity(reqs, clean, reqs2, faulted)


def test_crash_with_unsynced_horizon_drops_no_tokens(monkeypatch):
    """A crash at dispatch #2 lands with dispatch #1's block in flight:
    its record is dropped unread (never waited on), and replay makes its
    tokens again — no duplicates, no gaps."""
    reqs = _requests(4, seed=29)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    engine = _engine(FaultInjector().plan("step", at=1, kind="crash"),
                     decode_horizon=4)
    for r in reqs2:
        engine.submit(r)
    engine.step()
    inflight = engine._inflight
    assert inflight is not None
    processed = []
    orig = engine._process
    monkeypatch.setattr(engine, "_process",
                        lambda h: (processed.append(h), orig(h)))
    with pytest.raises(EngineCrash):
        engine.step()
    assert engine._inflight is inflight  # never read
    engine.recover()
    assert engine._inflight is None
    faulted = engine.run()
    assert all(h is not inflight for h in processed)
    _assert_parity(reqs, clean, reqs2, faulted)


# -- replay modes --------------------------------------------------------------

def test_chunked_replay_recovery():
    """Forced chunked replay re-prefills prompt + tokens in one bucketed
    pass; here its logits pick the same greedy tokens."""
    reqs = _requests(4, seed=31)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    engine = _engine(FaultInjector().plan("step", at=2, kind="crash"),
                     chunked_replay=True)
    faulted = _run(engine, reqs2)
    assert engine.last_recover_mode == "chunked"
    assert engine.metrics.n_restarts == 1
    assert all(r.status is RequestStatus.FINISHED for r in reqs2)
    _assert_parity(reqs, clean, reqs2, faulted)


@pytest.mark.parametrize("paged", [False, True])
def test_auto_replay_probes_and_preserves_parity(paged):
    reqs = _requests(5, seed=37)
    clean = _run(_engine(paged=paged), reqs)
    reqs2 = _clone(reqs)
    engine = _engine(FaultInjector().plan("step", at=3, kind="crash"),
                     paged=paged)
    faulted = _run(engine, reqs2)
    assert engine._chunked_ok is not None  # the probe ran
    assert engine.last_recover_mode == (
        "chunked" if engine._chunked_ok else "stepwise")
    _assert_parity(reqs, clean, reqs2, faulted)


def test_chunked_probe_gates_the_mode(monkeypatch):
    engine = _engine(FaultInjector().plan("step", at=2, kind="crash"))
    monkeypatch.setattr(engine, "_probe_chunked_parity", lambda: False)
    reqs = _requests(3, seed=43)
    clean = _run(_engine(), reqs)
    reqs2 = _clone(reqs)
    _assert_parity(reqs, clean, reqs2, _run(engine, reqs2))
    assert engine.last_recover_mode == "stepwise"


@pytest.mark.parametrize("chunked_replay", [False, True])
def test_crash_replay_greedy_matches_reference_engine(chunked_replay):
    """The reference engine and the port's under the same scripted crashes
    (one at a step check, one at a prefill check), replaying stepwise or
    chunked, same weights (carried across by ``params_from_jax``) and
    prompts: equal greedy streams except at near-ties of the port's own
    generate logits."""
    jcfg = jt.TransformerConfig.from_json(CFG.to_json())
    jparams = jt.init_transformer(jax.random.key(0), jcfg)
    params = pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                device="cpu")

    def faults(mod):
        return (mod.FaultInjector().plan("step", at=4, kind="crash")
                .plan("prefill", at=3, kind="crash"))

    reqs = _requests(6, seed=11)
    jeng = JEngine(jcfg, jparams, n_slots=2, temperature=0.0,
                   faults=faults(jfaults), chunked_replay=chunked_replay,
                   retry_backoff_s=0.001, max_backoff_s=0.004)
    for r in reqs:
        jeng.submit(JRequest(id=r.id, prompt=r.prompt.copy(),
                             max_new=r.max_new))
    jeng.run()
    eng = ServingEngine(CFG, params, n_slots=2, device="cpu",
                        temperature=0.0, faults=faults(pfaults),
                        chunked_replay=chunked_replay,
                        retry_backoff_s=0.001, max_backoff_s=0.004)
    preqs = _clone(reqs)
    got = _run(eng, preqs)
    assert eng.metrics.n_restarts == jeng.metrics.n_restarts == 2
    assert eng.last_recover_mode == (
        "chunked" if chunked_replay else "stepwise")
    gen = pt.transformer_generate(CFG)
    for r, p in zip(reqs, preqs):
        a, b = np.asarray(jeng.results[r.id]), got[p.id]
        assert a.shape == b.shape
        diff = np.nonzero(a != b)[0]
        if diff.size:
            _, logits = gen(params, torch.from_numpy(r.prompt[None]).long(),
                            r.max_new, temperature=0.0, return_logits=True)
            i = int(diff[0]) - len(r.prompt)
            top2 = np.sort(logits[i, 0].numpy())[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (r.prompt, i, top2)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_recovery_mid_generation_on_cache_hit_request(paged, temperature):
    """A crash while a full-hit request decodes: recovery re-creates the
    region (or the pool's blocks) and drops every segment, replay runs the
    cold path, and the streams equal the unfaulted cache-on run and the
    cache-off engine; afterwards the cache fills and hits again."""
    cfg = dataclasses.replace(CFG, max_len=64)
    p = np.arange(1, 13, dtype=np.int32)

    def drive(**kw):
        eng = _engine(n_slots=1, cfg=cfg, temperature=temperature,
                      prefill_max_bucket=8, paged=paged, **kw)
        reqs = [Request(prompt=p.copy(), max_new=8) for _ in range(2)]
        res = _run(eng, reqs)
        return [res[r.id] for r in reqs], eng

    r_off, _ = drive()
    r_on, e_on = drive(prefix_cache=True)
    assert e_on.metrics.n_prefix_hits_full == 1
    r_cr, e_cr = drive(prefix_cache=True, faults=FaultInjector().plan(
        "step", at=10, kind="crash"))
    assert e_cr.metrics.n_restarts == 1
    assert e_cr.metrics.n_prefix_hits_full == 1
    for a, b, c in zip(r_off, r_on, r_cr):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    assert e_cr.prefix_cache.n_segments == 0  # reinit dropped them
    x1 = Request(prompt=p.copy(), max_new=4)
    _run(e_cr, [x1])
    before = e_cr.prefill_dispatches
    x2 = Request(prompt=p.copy(), max_new=4)
    _run(e_cr, [x2])
    assert e_cr.prefill_dispatches == before
    assert e_cr.metrics.n_prefix_hits_full == 2
    if paged:
        blocks = {b for s in e_cr.prefix_cache._segments
                  for b in s.block_ids}
        assert e_cr.pool.n_blocks_in_use == len(blocks)


# -- the server ----------------------------------------------------------------

def _post(base, payload, timeout=60):
    req = urllib.request.Request(
        f"{base}/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path, timeout=10):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _warm_engine(**kw):
    engine = _engine(**kw)
    warm = Request(prompt=np.asarray([1, 5, 9], np.int32), max_new=2)
    _run(engine, [warm])
    engine.pop_result(warm.id)
    return engine


def test_healthz_stays_200_over_a_recovery():
    """A scripted crash under the server: the loop recovers by replay,
    /healthz stays 200 with one restart counted, and the request returns
    the uninterrupted stream."""
    prompt = [1, 5, 9, 11]
    ref = Request(prompt=prompt, max_new=10)
    clean = _run(_engine(), [ref])[ref.id]
    engine = _warm_engine()
    engine.faults = FaultInjector().plan("step", at=3, kind="crash")
    srv = ServingServer(engine, port=0).start()
    base = "http://%s:%d" % srv.address
    try:
        status, body = _post(base, {"prompt": prompt, "max_new": 10})
        assert status == 200 and body["tokens"] == clean.tolist()
        status, health = _get(base, "/healthz")
        assert status == 200 and health["ok"] and health["restarts"] == 1
        assert "EngineCrash" in health["last_error"]
    finally:
        srv.stop()


def test_healthz_flips_on_unrecovered_engine_death():
    """Crashes at every check with max_restarts 1: the supervisor gives up,
    fails the waiting request fast, /healthz turns 503 and new requests
    get 503."""
    engine = _warm_engine()
    engine.faults = FaultInjector().plan("step", at=0, kind="crash",
                                         times=10**9)
    srv = ServingServer(engine, port=0, max_restarts=1).start()
    base = "http://%s:%d" % srv.address
    try:
        status, body = _get(base, "/healthz")
        assert status == 200 and body["ok"] is True
        out = {}
        t = threading.Thread(target=lambda: out.update(
            resp=_post(base, {"prompt": [1, 5, 9], "max_new": 8})))
        t.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            status, body = _get(base, "/healthz")
            if status == 503:
                break
            time.sleep(0.01)
        assert status == 503 and body["ok"] is False
        assert body["engine_alive"] is False
        assert "crash" in body["last_error"]
        assert body["restarts"] >= 1
        t.join(timeout=30)
        status, body = out["resp"]
        assert status == 500 and body["status"] == "failed"
        status, body = _post(base, {"prompt": [2], "max_new": 2})
        assert status == 503 and body["error"] == "engine dead"
    finally:
        srv.stop()


def test_watchdog_flags_hung_engine():
    """An engine stalled inside a step (a scripted 0.5 s delay per check)
    stops beating while its thread lives: /healthz reports it hung (503)
    and recovers to 200 when the beat resumes."""
    engine = _warm_engine(faults=FaultInjector(delay_s=0.5))
    srv = ServingServer(engine, port=0, hang_threshold_s=0.1).start()
    base = "http://%s:%d" % srv.address
    try:
        status, body = _get(base, "/healthz")
        assert status == 200 and body["hung"] is False
        out = {}
        t = threading.Thread(target=lambda: out.update(
            resp=_post(base, {"prompt": [1, 5, 9], "max_new": 4})))
        t.start()
        saw_hung = False
        deadline = time.time() + 15
        while time.time() < deadline:
            status, body = _get(base, "/healthz")
            if status == 503 and body["hung"]:
                saw_hung = True
                assert body["ok"] is False
                assert body["beat_age_s"] > srv.hang_threshold_s
                break
            time.sleep(0.01)
        assert saw_hung, "the watchdog never flagged the stalled engine"
        t.join(timeout=30)
        assert out["resp"][0] == 200  # the stall was latency, not death
        deadline = time.time() + 10
        while time.time() < deadline:
            status, body = _get(base, "/healthz")
            if status == 200:
                break
            time.sleep(0.05)
        assert status == 200 and body["hung"] is False
    finally:
        srv.stop()
