"""Chunked-prefill piggyback through faults on the port's serving engine:
a crash while prefills are pending, the pending records requeued by
recovery, and a failed admission round that had deferred a prompt (split
from ``test_torch_serving_piggyback.py``, whose model and helpers it uses,
so that the test run spreads the two files over its workers). The bar is
the blocking engine's bytes."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.serving import (
    EngineCrash,
    FaultInjector,
    Request,
)
from test_torch_serving_piggyback import (
    _assert_same,
    _clone,
    _engine,
    _piggy,
    _requests,
    _run,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("crash_at", [1, 3, 5])
def test_piggyback_crash_mid_prefill_parity(temperature, crash_at):
    """A crash while prefills are pending: recovery requeues the pending
    records (slots and pinned segments released, seeds kept) and the
    replay still streams the blocking engine's bytes."""
    reqs = _requests()
    ref = _run(_engine(temperature=temperature), _clone(reqs))
    faults = FaultInjector().plan("step", crash_at, "crash")
    eng = _piggy(temperature=temperature, faults=faults)
    got = _run(eng, _clone(reqs), max_restarts=5)
    _assert_same(ref, got)
    assert eng.metrics.n_restarts >= 1, "the crash never fired"
    assert eng.metrics.n_prefill_chunks > 0


def test_piggyback_crash_with_pending_records_requeues_them():
    """At the crash deferred admissions are pending: recovery hands them
    back to the queue front with their seeds and frees their slots;
    nothing is dropped."""
    eng = _piggy(faults=FaultInjector().plan("step", 0, "crash"),
                 temperature=0.9)
    reqs = _requests()
    for r in reqs:
        eng.submit(r)
    with pytest.raises(EngineCrash):
        for _ in range(50):
            eng.step()
    pending = [rec.plan.req.id for rec in eng._pending]
    assert pending, "no admission was pending at the crash"
    queued = len(eng.scheduler)
    eng.recover()
    assert not eng._pending
    assert len(eng.scheduler) == queued + len(pending)
    assert all(rid in eng._presplit_keys for rid in pending)
    res = eng.run()
    got = {r.id: np.asarray(res[r.id]) for r in reqs}
    assert all(r.status.value == "finished" for r in reqs)
    _assert_same(_run(_engine(temperature=0.9), _clone(reqs)), got)


def test_failed_round_keeps_a_deferred_admission_once(monkeypatch):
    """A round defers a long prompt, then a later plan of the same round
    fails in its prefill: the deferred record stays pending (recover()
    owns it) and only the failed plan is requeued with its slot freed.
    Whether the caller recovers or simply steps on, no slot is released
    twice, no request is queued twice, and the streams are the blocking
    engine's."""
    long_p = ((1 + np.arange(36)) % 127).astype(np.int32)
    short_p = ((5 + np.arange(5)) % 127).astype(np.int32)
    reqs = [Request(id="long", prompt=long_p, max_new=6),
            Request(id="short", prompt=short_p, max_new=6)]
    ref = _run(_engine(), _clone(reqs))
    for recover in (True, False):
        eng = _piggy()
        real = eng._prefill_seq_into_slot
        boom = {"left": 1}

        def failing(*a, **kw):
            if boom["left"]:
                boom["left"] -= 1
                raise RuntimeError("injected prefill failure")
            return real(*a, **kw)

        monkeypatch.setattr(eng, "_prefill_seq_into_slot", failing)
        for r in _clone(reqs):
            eng.submit(r)
        with pytest.raises(RuntimeError, match="injected"):
            eng.step()
        assert [rec.plan.req.id for rec in eng._pending] == ["long"]
        assert len(eng.scheduler) == 1 and eng.pool.n_active == 1
        if recover:
            eng.recover()
            assert not eng._pending and len(eng.scheduler) == 2
            assert eng.pool.n_active == 0
        eng.run()
        got = {k: np.asarray(eng.results[k]) for k in ref}
        _assert_same(ref, got)
