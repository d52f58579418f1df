"""The serving engine's trace replay and the rest of its public surface:
``run_request_trace``, ``ServingEngine.run(max_steps)``, the metrics' JSONL
writer, ``PagedKVPool(n_blocks=...)`` and ``RequestScheduler.depth``, each
held against the reference's (``deeplearning4j_tpu/serving``) at f32 on the
same weights, carried across by ``params_from_jax``.

Greedy streams equal the port's own ``transformer_generate`` on each
request bitwise, and the reference's except where a near-tie in the logits
flips a token (``NEAR_TIE``, as ``tests/test_torch_serving.py`` sets it).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import EngineCrash as JEngineCrash
from deeplearning4j_tpu.serving import FaultInjector as JFaultInjector
from deeplearning4j_tpu.serving import PagedKVPool as JPagedKVPool
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import RequestScheduler as JRequestScheduler
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving import ServingMetrics as JServingMetrics
from deeplearning4j_tpu.serving import run_request_trace as j_run_request_trace
from deeplearning4j_tpu.utils.metrics import MetricsWriter as JMetricsWriter
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    EngineCrash,
    FaultInjector,
    PagedKVPool,
    Request,
    RequestScheduler,
    RequestStatus,
    ServingEngine,
    ServingMetrics,
    run_request_trace,
)
from deeplearning4j_tpu_torch.utils.metrics import MetricsWriter

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this (f32 logits agree to ~1e-5 here)
NEAR_TIE = 1e-4

JCFG = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_len=32)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _specs(n, seed):
    """(prompt, max_new) of ``n`` requests, as the reference tests draw
    them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tp = int(rng.integers(3, 10))
        out.append((rng.integers(0, CFG.vocab_size, (tp,)).astype(np.int32),
                    int(rng.integers(4, min(12, CFG.max_len - tp)))))
    return out


def _port(specs):
    return [Request(prompt=p.copy(), max_new=m) for p, m in specs]


def _ref(specs):
    return [JRequest(prompt=p.copy(), max_new=m) for p, m in specs]


def _engine(params, **kw):
    kw.setdefault("n_slots", 3)
    return ServingEngine(CFG, params, temperature=0.0, device="cpu", **kw)


def _jengine(jparams, **kw):
    kw.setdefault("n_slots", 3)
    return JEngine(JCFG, jparams, temperature=0.0, **kw)


def _staggered(reqs):
    return [(0.002 * i, r) for i, r in enumerate(reqs)]


def _generate(params, specs):
    """Each request decoded alone by the port's generate: tokens and the
    per-step logits."""
    gen = pt.transformer_generate(CFG)
    out = []
    for p, m in specs:
        toks, logits = gen(params, torch.from_numpy(p[None]).long(), m,
                           temperature=0.0, return_logits=True)
        out.append((toks[0].numpy(), logits[:, 0].numpy()))
    return out


def _assert_near(ref_stream, stream, n_prompt, logits):
    """Equal, or the first difference at a near-tie of ``logits``."""
    a, b = np.asarray(ref_stream), np.asarray(stream)
    assert a.shape == b.shape
    diff = np.nonzero(a != b)[0]
    if diff.size:
        i = int(diff[0]) - n_prompt
        top2 = np.sort(logits[i])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (i, top2)


@pytest.mark.parametrize("time_scale", [1.0, 0.0])
@pytest.mark.parametrize("horizon", [1, 2])
def test_trace_matches_reference_trace(jparams, params, horizon, time_scale):
    """9 staggered requests through 3 slots: the port's replay gives each
    request's own generate stream bitwise, and the reference's replay of
    the same trace the same streams but at near-ties."""
    specs = _specs(9, seed=7)
    ref = _generate(params, specs)
    jreqs = _ref(specs)
    jres = j_run_request_trace(
        _jengine(jparams, decode_horizon=horizon), _staggered(jreqs),
        time_scale=time_scale)
    engine = _engine(params, decode_horizon=horizon)
    reqs = _port(specs)
    res = run_request_trace(engine, _staggered(reqs), time_scale=time_scale)
    assert set(res) == {r.id for r in reqs}
    for jr, r, (toks, logits), (p, _) in zip(jreqs, reqs, ref, specs):
        np.testing.assert_array_equal(res[r.id], toks)
        _assert_near(jres[jr.id], res[r.id], len(p), logits)
    s = engine.metrics.summary()
    assert s["n_finished"] == len(reqs)
    assert s["decode_horizon"] == horizon
    assert s["occupancy_mean"] > 1.0, "requests never interleaved"
    # 9 requests through 3 slots: the slots were reused
    assert s["steps"] < sum(m for _, m in specs)


def test_trace_survives_backpressure(params):
    """A flooded trace against a depth-2 queue: a refused submit is tried
    again after a step frees room, and every request finishes (the
    reference's ``test_run_request_trace_survives_backpressure``)."""
    engine = _engine(params, n_slots=1,
                     scheduler=RequestScheduler(max_queue_depth=2))
    specs = _specs(6, seed=17)
    reqs = _port(specs)
    results = run_request_trace(engine, [(0.0, r) for r in reqs],
                                time_scale=0.0)
    assert set(results) == {r.id for r in reqs}
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert engine.metrics.n_backpressure > 0
    for r, (toks, _) in zip(reqs, _generate(params, specs)):
        np.testing.assert_array_equal(results[r.id], toks)


def test_trace_recovers_crashes_like_the_reference(jparams, params):
    """Seeded whole-engine crashes during a flooded replay: the port and
    the reference restart the same number of times, the streams equal the
    clean replay's, and with ``max_restarts=0`` the crash propagates."""
    specs = _specs(8, seed=3)
    creqs = _port(specs)
    res = run_request_trace(_engine(params), _staggered(creqs),
                            time_scale=0.0)
    clean = [res[r.id] for r in creqs]

    def faults(mod):
        return mod(seed=5, crash_rate=0.05)

    jengine = _jengine(jparams, faults=faults(JFaultInjector),
                       retry_backoff_s=0.001, max_backoff_s=0.004)
    j_run_request_trace(jengine, _staggered(_ref(specs)), time_scale=0.0)
    engine = _engine(params, faults=faults(FaultInjector),
                     retry_backoff_s=0.001, max_backoff_s=0.004)
    reqs = _port(specs)
    res = run_request_trace(engine, _staggered(reqs), time_scale=0.0)
    assert engine.metrics.n_restarts >= 1
    assert engine.metrics.n_restarts == jengine.metrics.n_restarts
    for r, want in zip(reqs, clean):
        np.testing.assert_array_equal(res[r.id], want)
    engine = _engine(params, faults=faults(FaultInjector),
                     retry_backoff_s=0.001, max_backoff_s=0.004)
    with pytest.raises(EngineCrash):
        run_request_trace(engine, _staggered(_port(specs)), time_scale=0.0,
                          max_restarts=0)
    jengine = _jengine(jparams, faults=faults(JFaultInjector),
                       retry_backoff_s=0.001, max_backoff_s=0.004)
    with pytest.raises(JEngineCrash):
        j_run_request_trace(jengine, _staggered(_ref(specs)),
                            time_scale=0.0, max_restarts=0)


def test_run_max_steps_stops_and_resumes(jparams, params):
    """``run(max_steps)`` returns with the engine not idle after that many
    steps, as the reference's does; running on gives the streams of an
    uninterrupted run."""
    specs = _specs(5, seed=11)
    whole = _engine(params)
    wreqs = _port(specs)
    for r in wreqs:
        whole.submit(r)
    want = whole.run()
    engine = _engine(params)
    reqs = _port(specs)
    for r in reqs:
        engine.submit(r)
    part = engine.run(max_steps=3)
    assert not engine.idle and len(part) < len(reqs)
    assert engine.metrics.summary()["steps"] == 3
    jengine = _jengine(jparams)
    for r in _ref(specs):
        jengine.submit(r)
    jengine.run(max_steps=3)
    assert not jengine.idle
    assert jengine.metrics.summary()["steps"] == 3
    res = engine.run()
    assert engine.idle
    for r, w in zip(reqs, wreqs):
        np.testing.assert_array_equal(res[r.id], want[w.id])


def test_metrics_emission(jparams, params, tmp_path):
    """TTFT, TPOT, occupancy and queue depth go through the writer as
    JSONL, under the reference's tags: the same requests through both
    engines write the same tag set, and ``serve/occupancy`` has one record
    a step (the reference's ``test_metrics_emission``)."""
    specs = _specs(4, seed=11)
    tags = {}
    for name in ("port", "ref"):
        path = tmp_path / f"{name}.jsonl"
        if name == "port":
            writer = MetricsWriter(path)
            engine = _engine(params, n_slots=2,
                             metrics=ServingMetrics(writer=writer))
            reqs = _port(specs)
        else:
            writer = JMetricsWriter(path)
            engine = _jengine(jparams, n_slots=2,
                              metrics=JServingMetrics(writer=writer))
            reqs = _ref(specs)
        for r in reqs:
            engine.submit(r)
        engine.run()
        writer.close()
        records = MetricsWriter.read(path)
        tags[name] = {r["tag"] for r in records}
        s = engine.metrics.summary()
        occ = [r for r in records if r["tag"] == "serve/occupancy"]
        assert len(occ) == s["steps"]
        assert [r["step"] for r in occ] == list(range(s["steps"]))
        assert max(r["value"] for r in occ) <= 2
        frac = [r["value"] for r in records
                if r["tag"] == "serve/occupancy_frac"]
        assert frac == [r["value"] / 2 for r in occ]
    assert {"serve/ttft_seconds", "serve/tpot_seconds", "serve/occupancy",
            "serve/queue_depth"} <= tags["port"]
    assert tags["port"] == tags["ref"]
    s = engine.metrics.summary()
    for k in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
              "occupancy_mean"):
        assert k in s and np.isfinite(s[k])


def test_metrics_prefix_and_writerless_summary(params, tmp_path):
    """A prefix other than ``serve`` names the tags; with no writer the
    metrics hold no writer and the summary is unchanged."""
    path = tmp_path / "eng.jsonl"
    writer = MetricsWriter(path)
    specs = _specs(3, seed=2)
    engine = _engine(params, n_slots=2,
                     metrics=ServingMetrics(writer=writer, prefix="eng0"))
    run_request_trace(engine, [(0.0, r) for r in _port(specs)],
                      time_scale=0.0)
    writer.close()
    tags = {r["tag"] for r in MetricsWriter.read(path)}
    assert tags and all(t.startswith("eng0/") for t in tags)
    plain = _engine(params, n_slots=2)
    assert plain.metrics.writer is None
    run_request_trace(plain, [(0.0, r) for r in _port(specs)],
                      time_scale=0.0)
    a, b = engine.metrics.summary(), plain.metrics.summary()
    for k in ("n_finished", "n_generated", "steps"):
        assert a[k] == b[k]


def _pool_script(pool, runtime_error):
    """One script of allocations, extensions, sharing and frees on a pool
    of 9 blocks (8 allocatable); returns its states and errors."""
    states = []

    def snap():
        states.append((pool.tables().tolist(),
                       [pool.refcount(b) for b in range(pool.n_blocks)],
                       pool.n_free_blocks, pool.n_blocks_in_use,
                       pool.can_admit(8 * pool.n_free_blocks),
                       pool.can_admit(8 * pool.n_free_blocks + 1)))

    s0, s1 = pool.acquire(), pool.acquire()
    pool.alloc_slot_blocks(s0, 10)
    pool.alloc_slot_blocks(s1, 24)
    snap()
    pool.alloc_slot_blocks(s0, 20, start=2)  # extend past 2 entries
    seg = pool.alloc_blocks(1)
    s2 = pool.acquire()
    pool.alias_into_slot(s2, [pool.table(s1)[0]] + seg)
    snap()
    errors = []
    with pytest.raises(runtime_error) as e:
        pool.alloc_blocks(2)  # 1 free
    errors.append(str(e.value))
    with pytest.raises(runtime_error) as e:
        pool.alloc_slot_blocks(s2, 32, start=2)  # 2 more, 1 free
    errors.append(str(e.value))
    pool.alloc_slot_blocks(s2, 24, start=2)  # the last one
    snap()
    pool.release(s1)
    pool.decref(seg)
    snap()
    pool.release(s2)
    pool.release(s0)
    snap()
    return states, errors


def test_paged_pool_of_a_chosen_size_matches_the_reference():
    """``PagedKVPool(n_blocks=9)`` below the default 13 (3 slots x 4 + the
    sentinel): the same script gives the reference's tables, refcounts,
    free counts, admission gate and errors; the device pool is sized to
    the count."""
    from deeplearning4j_tpu.serving.cache_pool import PagedKVPool as JPool

    assert JPool is JPagedKVPool
    cpu = torch.device("cpu")
    pool = PagedKVPool(CFG, 3, 32, cpu, block_size=8, n_blocks=9)
    full = PagedKVPool(CFG, 3, 32, cpu, block_size=8)
    jpool = JPagedKVPool(JCFG, 3, 32, block_size=8, n_blocks=9)
    assert (pool.n_blocks, full.n_blocks, jpool.n_blocks) == (9, 13, 9)
    assert pool.caches.shape == (2, 2, 9, 8, 32)
    assert pool.nbytes() * 13 == full.nbytes() * 9
    assert pool.block_nbytes() == full.block_nbytes()
    assert pool.n_free_blocks == jpool.n_free_blocks == 8
    got = _pool_script(pool, RuntimeError)
    want = _pool_script(jpool, RuntimeError)
    assert got == want
    assert got[0][2][2] == 0 and got[0][-1][2] == 8  # all out, all back
    for n in (1, 0):
        with pytest.raises(ValueError) as e:
            PagedKVPool(CFG, 3, 32, cpu, block_size=8, n_blocks=n)
        with pytest.raises(ValueError) as je:
            JPagedKVPool(JCFG, 3, 32, block_size=8, n_blocks=n)
        assert str(e.value) == str(je.value)


def test_engine_admits_within_an_oversubscribed_pool(params):
    """An engine whose paged pool holds blocks for one slot's rows of the
    three slots' still serves every request, each stream its own
    generate's: admission waits on ``can_admit``."""
    specs = _specs(6, seed=5)
    engine = _engine(params, paged=True, block_size=8)
    assert engine._paged
    # swap the pool for one of 5 blocks (4 allocatable: 32 rows)
    engine.pool = PagedKVPool(CFG, 3, engine.max_total, engine.device,
                              block_size=8, n_blocks=5)
    reqs = _port(specs)
    res = run_request_trace(engine, [(0.0, r) for r in reqs],
                            time_scale=0.0)
    for r, (toks, _) in zip(reqs, _generate(params, specs)):
        np.testing.assert_array_equal(res[r.id], toks)
    assert engine.pool.n_blocks_in_use == 0


def test_scheduler_depth():
    """``depth`` is the queue's length, as the reference's property."""
    sched, jsched = RequestScheduler(), JRequestScheduler()
    assert sched.depth == jsched.depth == 0
    for p, m in _specs(3, seed=1):
        sched.submit(Request(prompt=p, max_new=m))
        jsched.submit(JRequest(prompt=p, max_new=m))
    assert sched.depth == len(sched) == jsched.depth == 3
    sched.pop()
    jsched.pop()
    assert sched.depth == jsched.depth == 2
