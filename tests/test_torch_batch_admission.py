"""Batched admission and the adaptive horizon of the port's engine, held
against the reference engine on the same weights and traffic.

- Batched admission (``batch_admission``): same-bucket misses admitted in
  one round are prefilled by one program, partial hits behind one cached
  prefix by one chunk program. Within the port the streams are
  byte-identical to serial admission (the probe, run once for each
  geometry, passes on the CPU: the batched programs take the head product
  a row at a time, at a batch-1 call's M 1), and the dispatch counts
  equal the reference's.
  Across frameworks, greedy streams equal the reference's batched streams
  and sampled ones hold to the near-tie rule of
  ``tests/test_torch_sampled_parity.py``.
- The adaptive horizon: K 1 while requests wait, the configured K once the
  queue drains, the same horizons step by step as the reference, and the
  streams of fixed K.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.serving import Request, ServingEngine
from test_torch_sampled_parity import (
    NOISE_TOL,
    TEMP,
    TOP_K,
    _filtered_scaled,
    _margin,
    _u32,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# the reference's serving-test model (tests/test_serving_prefix.py)
JCFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this (f32 logits agree to ~1e-5 here)
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _engine(params, cfg=CFG, n_slots=4, **kw):
    kw.setdefault("temperature", 0.0)
    return ServingEngine(cfg, params, n_slots=n_slots, device="cpu",
                         retry_backoff_s=0.001, max_backoff_s=0.004, **kw)


def _drive(engine, reqs):
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    return [np.asarray(res[r.id]) for r in reqs]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _prompts():
    """The reference test's four same-bucket prompts (6 to 8 tokens)."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, JCFG.vocab_size, (6 + i % 3,)).astype(np.int32)
            for i in range(4)]


def _greedy_near_tie(jparams, ref, got):
    """Greedy streams equal, or they part at a near-tie of the
    reference's logits (its own forward pass over the shared prefix)."""
    diff = np.nonzero(ref != got)[0]
    if not diff.size:
        return
    i = int(diff[0])
    lg, _ = jt.transformer_apply(JCFG)(jparams, jax.numpy.asarray(
        ref[:i])[None])
    top2 = np.sort(np.asarray(lg[0, -1]))[-2:]
    assert top2[1] - top2[0] < NEAR_TIE, (i, top2)


def test_batched_admission_parity_and_fewer_dispatches(params, jparams):
    """Four same-bucket misses admitted in one horizon: one dispatched
    prefill program, byte-identical to serial admission; the counts are
    the reference's (its ``test_batched_admission_parity_and_fewer_
    dispatches``) and the streams its batched streams."""
    prompts = _prompts()

    def run(batch):
        eng = _engine(params, batch_admission=batch)
        return eng, _drive(eng, [Request(prompt=p.copy(), max_new=5)
                                 for p in prompts])

    e_ser, ser = run(False)
    e_bat, bat = run("auto")
    _same(ser, bat)
    assert e_bat.batch_verdicts == {("miss", 8, 4): True}
    assert e_bat.probes_run == ["batch_admission"]
    j_ser = JEngine(JCFG, jparams, n_slots=4, temperature=0.0,
                    batch_admission=False)
    j_bat = JEngine(JCFG, jparams, n_slots=4, temperature=0.0,
                    batch_admission="auto")
    refs = {}
    for name, je in (("ser", j_ser), ("bat", j_bat)):
        reqs = [JRequest(prompt=p.copy(), max_new=5) for p in prompts]
        for r in reqs:
            je.submit(r)
        res = je.run()
        refs[name] = [np.asarray(res[r.id]) for r in reqs]
    assert e_bat.metrics.n_batched_admissions == (
        j_bat.metrics.n_batched_admissions) == 4
    assert e_ser.metrics.n_batched_admissions == (
        j_ser.metrics.n_batched_admissions) == 0
    assert e_bat.prefill_dispatches == j_bat.prefill_dispatches == 1
    assert e_ser.prefill_dispatches == j_ser.prefill_dispatches == 4
    for r, g in zip(refs["bat"], bat):
        _greedy_near_tie(jparams, r, g)
    assert e_bat.metrics.summary()["batched_admissions"] == 4
    assert "serve_prefill_batched_total 4" in (
        e_bat.metrics.render_prometheus())


def test_batched_sampled_matches_serial_and_reference(params, jparams):
    """T 0.8 top-k 40: batched streams equal serial ones (the keys split
    in admission order either way), and the reference's batched engine's
    streams under the near-tie rule at the first divergence."""
    prompts = _prompts()
    kw = dict(temperature=TEMP, top_k=TOP_K, rng_seed=11)
    got = {b: _drive(_engine(params, batch_admission=b, **kw),
                     [Request(prompt=p.copy(), max_new=8) for p in prompts])
           for b in (False, "auto")}
    _same(got[False], got["auto"])
    je = JEngine(JCFG, jparams, n_slots=4, batch_admission="auto", **kw)
    jreqs = [JRequest(prompt=p.copy(), max_new=8) for p in prompts]
    for r in jreqs:
        je.submit(r)
    res = je.run()
    assert je.metrics.n_batched_admissions == 4
    k, keys = threefry.key(11), []
    for _ in prompts:
        k, sub = threefry.split(k)
        keys.append(sub)
    for r, y, kd in zip(jreqs, got["auto"], keys):
        x = np.asarray(res[r.id])
        diff = np.nonzero(x != y)[0]
        if not diff.size:
            continue
        i = int(diff[0])
        lg_ref = np.asarray(jt.transformer_apply(JCFG)(
            jparams, jax.numpy.asarray(x[:i])[None])[0][0, -1], np.float32)
        lg_port = pt.transformer_apply(CFG)(
            params, torch.from_numpy(x[:i][None]).long())[0][0, -1]
        delta = float(np.abs(lg_port.numpy() - lg_ref).max())
        noise = np.asarray(jax.random.gumbel(jax.random.fold_in(
            jax.random.wrap_key_data(_u32(kd)), i), (JCFG.vocab_size,)))
        m = _margin(noise, _filtered_scaled(lg_ref, TOP_K))
        assert m <= 2 * delta / TEMP + NOISE_TOL, (r.id, i, m)


def test_batch_groups_by_bucket_and_serializes_singletons(params):
    """Misses group by bucket (8: two prompts, 16: two), a lone bucket
    (32) runs serially: three dispatches for five admissions, streams
    byte-identical to serial admission."""
    cfg = pt.TransformerConfig.from_json(
        jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_len=64).to_json())
    p64 = pt.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 64, n).astype(np.int32)
               for n in (3, 12, 20, 7, 13)]

    def run(batch):
        eng = _engine(p64, cfg=cfg, n_slots=5, batch_admission=batch)
        return eng, _drive(eng, [Request(prompt=p.copy(), max_new=4)
                                 for p in prompts])

    e_ser, ser = run(False)
    e_bat, bat = run("auto")
    _same(ser, bat)
    assert e_ser.prefill_dispatches == 5
    assert e_bat.prefill_dispatches == 3
    assert e_bat.metrics.n_batched_admissions == 4
    # one probe for each geometry the groups take
    assert e_bat.batch_verdicts == {("miss", 8, 2): True,
                                    ("miss", 16, 2): True}


def test_batched_admission_with_mixed_adapters(params):
    """A group whose rows take different LoRA adapters (0 among them)
    equals serial admission stream for stream."""
    bank = pt.init_lora_bank(threefry.key(0), CFG, 3, 2, device="cpu")
    prompts = _prompts()

    def run(batch):
        eng = _engine(params, batch_admission=batch, lora_bank=bank)
        return eng, _drive(eng, [Request(prompt=p.copy(), max_new=5,
                                         adapter=i % 3)
                                 for i, p in enumerate(prompts)])

    e_ser, ser = run(False)
    e_bat, bat = run(True)
    _same(ser, bat)
    assert e_bat.prefill_dispatches == 1 and e_ser.prefill_dispatches == 4


def test_batched_partial_hits_share_one_dispatch():
    """Three prompts extending one cached 16-token prefix (two hit grains
    of the 8-token bucket), admitted in one horizon: one batched suffix
    program, streams byte-identical to the cache off and to the port's
    serial hits (the reference's hit path is not a parity target on this
    CPU, its prefix probe declines)."""
    cfg = pt.TransformerConfig.from_json(
        jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_len=64).to_json())
    p64 = pt.init_params(cfg, seed=0, device="cpu")
    a = np.arange(1, 17, dtype=np.int32)
    exts = [np.concatenate([a, [50 + i, 60 - i]]) for i in range(3)]

    def run(cache, batch="auto"):
        eng = _engine(p64, cfg=cfg, n_slots=3, prefill_max_bucket=8,
                      prefix_cache=cache, batch_admission=batch)
        _drive(eng, [Request(prompt=a.copy(), max_new=4)])
        before = eng.prefill_dispatches
        out = _drive(eng, [Request(prompt=p.copy(), max_new=4)
                           for p in exts])
        return eng, out, eng.prefill_dispatches - before

    _, off, d_off = run(False)
    e_on, on, d_on = run(True)
    e_ser, ser, d_ser = run(True, False)
    _same(off, on)
    _same(ser, on)
    assert e_on.metrics.n_prefix_hits_partial == 3
    assert e_on.metrics.prefix_tokens_saved == 48
    assert (d_off, d_on, d_ser) == (9, 1, 3)  # off: windows 8, 8, 2 each
    assert e_on.metrics.n_batched_admissions == 3
    assert e_on.batch_verdicts == {("hit", 8, 4): True}
    assert e_ser.metrics.n_batched_admissions == 0


def test_probe_gates_batching_and_paged_stays_serial(params, monkeypatch):
    """A declining probe keeps every admission serial (same streams);
    paged engines never batch, even when told to; a bad mode raises."""
    prompts = _prompts()
    reqs = lambda: [Request(prompt=p.copy(), max_new=5) for p in prompts]
    base = _drive(_engine(params, batch_admission=False), reqs())
    paged = _engine(params, batch_admission=True, paged=True, block_size=8)
    assert paged._paged
    _same(base, _drive(paged, reqs()))
    assert paged.metrics.n_batched_admissions == 0
    assert paged.prefill_dispatches == 4
    monkeypatch.setattr(ServingEngine, "_probe_batch_parity",
                        lambda self, kind, bucket, nb: False)
    eng = _engine(params)
    _same(base, _drive(eng, reqs()))
    assert eng.batch_verdicts == {("miss", 8, 4): False}
    assert eng.metrics.n_batched_admissions == 0
    assert eng.prefill_dispatches == 4
    with pytest.raises(ValueError, match="batch_admission"):
        _engine(params, batch_admission="sometimes")


def _horizons(engine, reqs):
    """Step ``engine`` over ``reqs`` (submitted together); returns the
    streams and the K of every dispatch."""
    for r in reqs:
        engine.submit(r)
    ks = []
    while not engine.idle:
        n = engine.metrics._step
        engine.step()
        if engine.metrics._step > n:
            ks.append(engine.decode_horizon_current)
    return [np.asarray(engine.results[r.id]) for r in reqs], ks


@pytest.mark.parametrize("n_slots,n_reqs", [(1, 2), (2, 5)])
def test_adaptive_horizon_shrinks_then_restores(params, jparams, n_slots,
                                                n_reqs):
    """The reference's ``test_adaptive_horizon_shrinks_then_restores``
    (tests/test_serving_prefix.py:408), and more: K 1 while requests
    wait, K 4 once the queue drains, the reference's horizons dispatch for
    dispatch, and the streams of fixed K."""
    rng = np.random.default_rng(n_reqs)
    prompts = [rng.integers(1, 64, int(rng.integers(5, 10))).astype(
        np.int32) for _ in range(n_reqs)]
    fixed = _drive(_engine(params, n_slots=n_slots, decode_horizon=4),
                   [Request(prompt=p.copy(), max_new=6) for p in prompts])
    eng = _engine(params, n_slots=n_slots, decode_horizon=4,
                  adaptive_horizon=True)
    got, ks = _horizons(eng, [Request(prompt=p.copy(), max_new=6)
                              for p in prompts])
    je = JEngine(JCFG, jparams, n_slots=n_slots, temperature=0.0,
                 decode_horizon=4, adaptive_horizon=True)
    jks = []
    jreqs = [JRequest(prompt=p.copy(), max_new=6) for p in prompts]
    for r in jreqs:
        je.submit(r)
    while not je.idle:
        n = je.metrics._step
        je.step()
        if je.metrics._step > n:
            jks.append(je.decode_horizon_current)
    _same(fixed, got)
    assert set(ks) == {1, 4} and eng.decode_horizon_current == 4
    assert ks == jks
    for r, g in zip(jreqs, got):
        _greedy_near_tie(jparams, np.asarray(je.results[r.id]), g)
    assert "serve_decode_horizon_current 4" in eng.metrics.render_prometheus()


def test_adaptive_horizon_sampled_streams_unchanged(params):
    """Sampled streams do not depend on the horizon either: a token is
    drawn with fold_in(slot key, position)."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 64, 6).astype(np.int32) for _ in range(5)]
    kw = dict(n_slots=2, decode_horizon=4, temperature=TEMP, top_k=TOP_K,
              rng_seed=5)
    fixed = _drive(_engine(params, **kw),
                   [Request(prompt=p.copy(), max_new=7) for p in prompts])
    got, ks = _horizons(_engine(params, adaptive_horizon=True, **kw),
                        [Request(prompt=p.copy(), max_new=7)
                         for p in prompts])
    _same(fixed, got)
    assert 1 in ks and 4 in ks
