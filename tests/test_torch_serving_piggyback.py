"""Chunked-prefill piggyback in the port's serving engine: the counterparts
of ``tests/test_serving_piggyback.py``'s single-device cases.

The bar is the house one, on one more axis: an engine that defers long
prompts and runs their chunks under a per-horizon budget, behind each
horizon's decode dispatch, streams BYTE-IDENTICAL tokens to the blocking
engine — greedy and sampled, with prefix-cache partial hits (only the
uncached suffix deferred), on the paged pool, and through a crash
mid-prefill (those cases are in ``test_torch_serving_piggyback_crash.py``,
which uses this module's model and helpers); a horizon still costs one
host sync. Across frameworks, the
port's greedy piggyback streams (with and without a crash mid-prefill)
equal the reference engine's piggyback streams on the same weights, except
where a near-tie flips a token.

Configuration: the reference suite's (GQA 4/2 heads, rope, the dense
decode path), with ``prefill_max_bucket=8`` so mid-size prompts take
several chunks.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import FaultInjector as JFaultInjector
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    FaultInjector,
    Request,
    ServingEngine,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

CFG = pt.TransformerConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_len=64, rope=True, decode_kernel=False,
)
JCFG = jt.TransformerConfig.from_json(CFG.to_json())
# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this (f32 logits agree to ~1e-5 here)
NEAR_TIE = 1e-4
_PARAMS = {}


def _params(cfg=CFG):
    key = cfg.to_json()
    if key not in _PARAMS:
        _PARAMS[key] = pt.init_params(cfg, seed=0, device="cpu")
    return _PARAMS[key]


def _engine(piggyback=False, n_slots=4, cfg=CFG, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("max_total", 64)
    kw.setdefault("decode_horizon", 2)
    kw.setdefault("prefill_max_bucket", 8)
    return ServingEngine(cfg, _params(cfg), n_slots=n_slots, device="cpu",
                         piggyback=piggyback, retry_backoff_s=0.001,
                         max_backoff_s=0.004, **kw)


def _piggy(**kw):
    eng = _engine(piggyback=True, **kw)
    assert eng._piggyback, "the piggyback engine fell back"
    return eng


def _requests(n=8, seed=1, shared_frac=0.5):
    """Short prompts (blocking path) and long ones past the 8-token bucket
    (the piggyback path), half sharing a 24-token prefix so partial hits
    leave an uncached suffix."""
    rng = np.random.default_rng(seed)
    shared = ((1 + np.arange(24)) % 127).astype(np.int32)
    reqs = []
    for i in range(n):
        ln = int(rng.integers(3, 40)) if i % 3 else 36
        if i % 2 and i < int(2 * shared_frac * n):
            p = np.concatenate(
                [shared, ((7 + np.arange(ln)) % 127).astype(np.int32)]
            )[:58]
        else:
            p = ((1 + np.arange(ln)) % 127).astype(np.int32)
        reqs.append(Request(id=f"r{i}", prompt=p, max_new=6))
    return reqs


def _clone(reqs):
    return [Request(id=r.id, prompt=np.asarray(r.prompt).copy(),
                    max_new=r.max_new) for r in reqs]


def _run(engine, reqs, **run_kw):
    for r in reqs:
        engine.submit(r)
    engine.run(**run_kw)
    return {r.id: np.asarray(engine.results[r.id]) for r in reqs}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_piggyback_on_off_byte_parity(temperature):
    reqs = _requests()
    ref = _run(_engine(temperature=temperature), _clone(reqs))
    eng = _piggy(temperature=temperature)
    got = _run(eng, _clone(reqs))
    _assert_same(ref, got)
    m = eng.metrics
    assert m.n_prefill_chunks > 0 and m.prefill_chunk_tokens > 0
    assert m.summary()["prefill_chunks"] == m.n_prefill_chunks
    assert "serve_prefill_pending 0" in m.render_prometheus()


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_piggyback_prefix_partial_hit_parity(temperature):
    """Partial hits: only the uncached suffix is deferred, and the streams
    match the blocking engine with the same cache."""
    reqs = _requests()
    ref = _run(_engine(temperature=temperature, prefix_cache=True),
               _clone(reqs))
    eng = _piggy(temperature=temperature, prefix_cache=True)
    got = _run(eng, _clone(reqs))
    _assert_same(ref, got)
    assert eng.metrics.n_prefix_hits_partial > 0, "no partial hit fired"
    assert eng.metrics.n_prefill_chunks > 0


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_piggyback_paged_parity(temperature):
    """Paged pool: a pending slot holds only private blocks until it
    completes (aliasing deferred), and the bytes still match; every block
    comes back but the segments'."""
    kw = dict(temperature=temperature, paged=True, block_size=8,
              prefix_cache=True)
    reqs = _requests()
    ref = _run(_engine(**kw), _clone(reqs))
    eng = _piggy(**kw)
    assert eng._paged
    got = _run(eng, _clone(reqs))
    _assert_same(ref, got)
    assert eng.metrics.n_prefill_chunks > 0
    held = {b for s in eng.prefix_cache._segments for b in s.block_ids}
    assert eng.pool.n_blocks_in_use == len(held)


def _near_tie_ok(params, prompt, a, b, max_new):
    """Greedy streams ``a`` (reference) and ``b`` (port) agree, or first
    differ where the port's own generate logits have a near-tie."""
    assert a.shape == b.shape
    diff = np.nonzero(a != b)[0]
    if diff.size:
        gen = pt.transformer_generate(CFG)
        _, logits = gen(params, torch.from_numpy(prompt[None]).long(),
                        max_new, temperature=0.0, return_logits=True)
        i = int(diff[0]) - len(prompt)
        top2 = np.sort(logits[i, 0].numpy())[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (prompt, i, top2)


@pytest.mark.parametrize("crash_at", [None, 3])
def test_piggyback_greedy_matches_reference_engine(crash_at):
    """The reference engine and the port's, both with piggyback on (and
    the same scripted crash mid-prefill when ``crash_at`` is set), same
    weights (carried across by ``params_from_jax``) and prompts: equal
    streams except at near-ties."""
    jparams = jt.init_transformer(jax.random.key(0), JCFG)
    params = pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                device="cpu")
    reqs = _requests()
    jfaults = (None if crash_at is None
               else JFaultInjector().plan("step", crash_at, "crash"))
    jeng = JEngine(JCFG, jparams, n_slots=4, max_total=64, decode_horizon=2,
                   prefill_max_bucket=8, temperature=0.0, piggyback=True,
                   faults=jfaults, retry_backoff_s=0.001,
                   max_backoff_s=0.004)
    jreqs = [JRequest(id=r.id, prompt=np.asarray(r.prompt).copy(),
                      max_new=r.max_new) for r in reqs]
    for r in jreqs:
        jeng.submit(r)
    jeng.run(max_restarts=5)
    faults = (None if crash_at is None
              else FaultInjector().plan("step", crash_at, "crash"))
    eng = ServingEngine(CFG, params, n_slots=4, max_total=64,
                        decode_horizon=2, prefill_max_bucket=8,
                        temperature=0.0, piggyback=True, faults=faults,
                        device="cpu", retry_backoff_s=0.001,
                        max_backoff_s=0.004)
    got = _run(eng, _clone(reqs), max_restarts=5)
    assert eng.metrics.n_prefill_chunks > 0
    if crash_at is not None:
        assert eng.metrics.n_restarts == 1, "the crash never fired"
        assert jeng.metrics.n_restarts == 1
    for r in reqs:
        _near_tie_ok(params, np.asarray(r.prompt),
                     np.asarray(jeng.results[r.id]), got[r.id], r.max_new)


def test_prefill_budget_bounds_chunks_per_horizon():
    """The budget caps the chunk tokens a horizon spends (the first chunk
    always runs); a smaller budget spreads the same chunks over more
    horizons with the same bytes."""
    reqs = _requests()
    big = _piggy()
    small = _piggy(prefill_budget=8)
    assert big.prefill_budget == 16 and small.prefill_budget == 8
    _assert_same(_run(big, _clone(reqs)), _run(small, _clone(reqs)))
    assert small.metrics.n_prefill_chunks == big.metrics.n_prefill_chunks


_CONVERSIONS = ("numpy", "item", "tolist", "__bool__", "__int__",
                "__float__", "__index__")


def test_piggyback_keeps_one_host_sync_per_horizon(monkeypatch):
    """Every read of a tensor's value on the host during the steps of a
    piggyback run with chunks pending (with the prefix cache and seeded
    transient faults) is the horizon's token block: one per processed
    horizon. Host scalars made on the host (a key split, the attention's
    scale constant) are not reads of device values and are left out. On
    the card ``chip_smoke.py`` phase 8c counts the device syncs."""
    eng = _piggy(faults=FaultInjector(0, transient_rate=0.05),
                 prefix_cache=True)
    counts = {"reads": 0, "horizons": 0, "quiet": 0}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def f(self, *a, **kw):
            if not counts["quiet"]:
                counts["reads"] += 1
            return orig(self, *a, **kw)
        return f

    for name in _CONVERSIONS:
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    process, split = eng._process, eng._split_key

    def on_process(h):
        counts["horizons"] += 1
        return process(h)

    def quiet(fn):  # host scalars (a key split, a scale constant)
        def f(*a, **kw):
            counts["quiet"] += 1
            try:
                return fn(*a, **kw)
            finally:
                counts["quiet"] -= 1
        return f

    monkeypatch.setattr(eng, "_process", on_process)
    monkeypatch.setattr(eng, "_split_key", quiet(split))
    monkeypatch.setattr(pt, "dtype_scalar", quiet(pt.dtype_scalar))
    reqs = _requests()
    for r in reqs:
        eng.submit(r)
    eng._prefix_reuse_ok()  # the construction-time probe reads by design
    counts["reads"] = 0
    while not eng.idle:
        eng.step()
    assert eng.metrics.n_prefill_chunks > 0 and eng.metrics.n_retries > 0
    assert counts["horizons"] > 0
    assert counts["reads"] == counts["horizons"]
