"""The prefix cache's on/off byte parity on the port's engine (slab,
paged, int8; greedy and sampled) and its evictions under pressure (split
from ``test_torch_prefix_cache.py``, whose model, fixtures and helpers it
uses, so that the test run spreads the two files over its workers)."""

import pytest
import torch

from test_torch_prefix_cache import (  # noqa: F401 (fixtures)
    _assert_streams_equal,
    _drive,
    _engine,
    _requests,
    _segment_blocks,
    jparams,
    params,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["slab", "paged", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_on_off_byte_parity(params, mode, temperature):
    """Cache on vs off under slot contention (2 slots, 10 requests): the
    same bytes, and the cache was really used — the probe passed, full
    and partial hits happened, tokens were saved and fewer prompt rows
    were computed."""
    off_eng = _engine(params, mode, temperature=temperature)
    off = _drive(off_eng, _requests())
    eng = _engine(params, mode, temperature=temperature, prefix_cache=True,
                  prefix_cache_tokens=8 * 64)
    on = _drive(eng, _requests())
    _assert_streams_equal(off, on)
    assert eng._prefix_ok_memo is True and eng.prefix_probe_detail is None
    m = eng.metrics
    assert m.n_prefix_hits_full > 0 and m.n_prefix_hits_partial > 0
    assert m.prefix_tokens_saved > 0
    assert m.summary()["prefix_tokens_saved"] == m.prefix_tokens_saved
    assert eng.prefill_dispatches < off_eng.prefill_dispatches
    if mode == "paged":
        assert eng._paged
        assert eng.pool.n_blocks_in_use == _segment_blocks(eng)


def test_evictions_under_pressure_keep_parity(params):
    """Two region slots under ten requests: segments churn by LRU and the
    streams stay the cache-off ones."""
    off = _drive(_engine(params), _requests())
    eng = _engine(params, prefix_cache=True, prefix_cache_tokens=2 * 64)
    _assert_streams_equal(off, _drive(eng, _requests()))
    assert eng.metrics.n_prefix_evictions > 0


def test_paged_evictions_hand_blocks_back(params):
    """Paged, with the cache's block budget at a third of the pool: evicted
    segments return their blocks, and after the run the blocks in use are
    exactly the live segments'."""
    off = _drive(_engine(params, "paged"), _requests())
    eng = _engine(params, "paged", prefix_cache=True,
                  prefix_cache_tokens=48)
    _assert_streams_equal(off, _drive(eng, _requests()))
    assert eng.metrics.n_prefix_evictions > 0
    assert eng.pool.n_blocks_in_use == _segment_blocks(eng)
