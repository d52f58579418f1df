"""The port's prefix cache (``serving/prefix_cache.py`` and the engine's hit
path), held against the reference.

Three bars:

- the host-side tree is the reference's: one seeded script of insert,
  lookup, pin, unpin, evict and reinit calls gives the same matches,
  lengths, eviction order and statistics on the port's ``PrefixCache`` and
  on the reference's;
- within the port, streams with the cache on are byte-identical to the
  cache off (slab, paged, int8; greedy and sampled; those cases and the
  evictions under pressure are in ``test_torch_prefix_cache_parity.py``,
  which uses this module's fixtures and helpers), and the hits really
  happen: the construction probe passes at this configuration, a full hit
  runs no prefill program and a partial hit saves its matched tokens;
- across frameworks, the port's greedy streams with the cache on equal the
  reference engine's (built with ``prefix_cache=False``: its probe's
  verdict depends on the machine) except where a near-tie flips a token.

The engine runs with ``prefill_max_bucket=8`` (as the reference's
piggyback suite does): partial hits reuse rows below a multiple of the
largest bucket, so prompts past 8 tokens exercise them at ``max_len`` 64.
"""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    PrefixCache,
    Request,
    RequestScheduler,
    ServingEngine,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this (f32 logits agree to ~1e-5 here)
NEAR_TIE = 1e-4

JCFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64,
)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
CFG8 = dataclasses.replace(CFG, decode_int8=True)
BUCKET = 8


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _engine(params, mode="slab", n_slots=2, **kw):
    kw.setdefault("temperature", 0.0)
    cfg = CFG
    if mode == "int8":
        cfg = CFG8
        params = pt.quantize_decode_params(params, CFG8)
    return ServingEngine(cfg, params, n_slots=n_slots, device="cpu",
                         prefill_max_bucket=BUCKET, paged=mode == "paged",
                         **kw)


def _shared_prefix_prompts():
    """System-prompt traffic: two shared prefixes (8 and 16 tokens) with
    extensions and divergent endings (edge splits, branch segments),
    exact repeats (full hits), a short miss and long prompts past the
    largest bucket."""
    a = np.arange(1, 9, dtype=np.int32)
    b = np.arange(40, 56, dtype=np.int32)
    return [
        np.concatenate([a, [60, 61]]),
        b,
        np.concatenate([b, [3, 4, 5]]),           # extends b
        np.concatenate([a, [60, 61]]),            # repeat: full hit
        np.arange(20, 27, dtype=np.int32),        # miss (7 tokens)
        np.concatenate([a, [62, 63, 1, 2]]),      # branches off a+[60..]
        np.concatenate([b, np.arange(10)]),
        np.concatenate([a, [30, 31, 32]]),        # hits the branch at 8
        b.copy(),                                 # repeat: full hit
        np.concatenate([b, np.arange(5, 30)]),
    ]


def _requests(max_new=(5, 8)):
    return [Request(prompt=p.copy(), max_new=max_new[i % 2])
            for i, p in enumerate(_shared_prefix_prompts())]


def _drive(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [engine.results[r.id] for r in reqs]


def _assert_streams_equal(sa, sb):
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)


def _segment_blocks(engine) -> int:
    """Distinct pool blocks the live segments hold."""
    return len({b for s in engine.prefix_cache._segments
                for b in s.block_ids})


# -- the tree against the reference's ----------------------------------------

class _SlabPool:
    """What ``PrefixCache`` reads of a slab pool."""

    is_paged = False
    tpad = 16

    def alloc_region(self, n):
        return None

    def region_nbytes(self, n):
        return 0


class _PagedPool:
    """What ``PrefixCache`` reads of a paged pool; records decrefs."""

    is_paged = True
    tpad = 16
    block_size = 4

    def __init__(self):
        self.decrefs = []

    def blocks_needed(self, n):
        return -(-n // self.block_size)

    def block_nbytes(self):
        return 1

    def decref(self, ids):
        self.decrefs.append(list(ids))


def _script(cache_cls, pool, seed: int):
    """A seeded script of tree operations; returns everything observable."""
    rng = np.random.default_rng(seed)
    evicted, log = [], []
    cache = cache_cls(pool, 3 * 16, on_evict=lambda s: evicted.append(
        (s.slot, s.length)), min_seg_len=2)
    pinned = []
    stems = [rng.integers(0, 5, 6) for _ in range(3)]
    for step in range(300):
        op = rng.integers(0, 6)
        stem = stems[rng.integers(0, 3)]
        q = np.concatenate([stem[:rng.integers(2, 7)],
                            rng.integers(0, 5, rng.integers(0, 6))])
        if op <= 1:
            segs = cache.insert(q)
            for s in segs:
                s.block_ids = list(range(step, step + pool_blocks(pool, s)))
                s.logits = step
            log.append(("insert", [(s.slot, s.length) for s in segs]))
            for s in segs:
                cache.unpin(s) if rng.random() < 0.7 else pinned.append(s)
        elif op == 2:
            seg, m = cache.lookup(q)
            log.append(("lookup", None if seg is None else seg.slot, m))
            if seg is not None and rng.random() < 0.5:
                cache.pin(seg)
                pinned.append(seg)
        elif op == 3 and pinned:
            cache.unpin(pinned.pop(int(rng.integers(0, len(pinned)))))
        elif op == 4:
            log.append(("reclaim", cache.reclaim()))
        elif step % 97 == 0:
            cache.reinit()
            pinned.clear()
            log.append(("reinit",))
        log.append(("stats", tuple(sorted(cache.stats().items())),
                    cache.n_pinned, cache.nbytes()))
    return log, evicted


def pool_blocks(pool, seg) -> int:
    return pool.blocks_needed(seg.length) if pool.is_paged else 0


@pytest.mark.parametrize("paged", [False, True])
def test_tree_matches_reference_script(paged):
    mk = _PagedPool if paged else _SlabPool
    for seed in range(3):
        jp, pp = mk(), mk()
        want = _script(JPrefixCache, jp, seed)
        got = _script(PrefixCache, pp, seed)
        assert got == want
        assert len(want[1]) > 0, "the script never evicted"
        if paged:
            assert pp.decrefs == jp.decrefs and pp.decrefs


def test_pinned_segment_is_never_evicted():
    """A full region of pinned segments declines the insert instead of
    evicting; unpinned, the oldest goes first."""
    cache = PrefixCache(_SlabPool(), 2 * 16)
    a = cache.insert([1, 2, 3])[0]
    b = cache.insert([4, 5, 6])[0]
    assert cache.insert([7, 8, 9]) == [] and cache.n_insert_declined == 1
    assert a.alive and b.alive and cache.n_evictions == 0
    cache.unpin(a)
    c = cache.insert([7, 8, 9])[0]
    assert not a.alive and b.alive and c.alive and cache.n_evictions == 1
    seg, m = cache.lookup([4, 5, 6, 7])
    assert seg is b and m == 3


# -- the engine: byte parity, hits -------------------------------------------


def test_probe_passes_and_gates_reuse(params, monkeypatch):
    """The probe holds at the test configuration; a segment store that
    corrupts one row makes it fail with the first differing row named,
    and then every lookup is a miss (the streams stay the cache-off
    ones)."""
    eng = _engine(params, prefix_cache=True)
    assert eng._probe_prefix_parity() and eng.prefix_probe_detail is None

    broken = _engine(params, prefix_cache=True)
    store = broken._seg_store_fn

    def bad_store(region, caches, seg, slot):
        store(region, caches, seg, slot)
        region[1, 0, seg, 3] += 1.0
        return region

    monkeypatch.setattr(broken, "_seg_store_fn", bad_store)
    off = _drive(_engine(params), _requests())
    _assert_streams_equal(off, _drive(broken, _requests()))
    assert broken._prefix_ok_memo is False
    assert "layer 1, k, row 3" in broken.prefix_probe_detail
    m = broken.metrics
    assert m.n_prefix_hits_full == m.n_prefix_hits_partial == 0


def test_full_hit_dispatches_zero_prefill_programs(params):
    eng = _engine(params, n_slots=1, prefix_cache=True)
    p = np.arange(1, 20, dtype=np.int32)
    r1 = Request(prompt=p.copy(), max_new=6)
    _drive(eng, [r1])
    before = eng.prefill_dispatches
    assert before > 0
    r2 = Request(prompt=p.copy(), max_new=6)
    _drive(eng, [r2])
    assert eng.prefill_dispatches == before
    assert eng.metrics.n_prefix_hits_full == 1
    np.testing.assert_array_equal(eng.results[r1.id], eng.results[r2.id])


@pytest.mark.parametrize("mode", ["slab", "paged"])
def test_partial_hit_saves_tokens(params, mode):
    """A prompt extending a cached 20-token one reuses its first 16 rows
    (the match rounded down to the 8-row grain) and computes only the
    rest: one window instead of three."""
    a = np.arange(1, 21, dtype=np.int32)
    b = np.concatenate([a, [60, 61, 62, 63]])

    def run(cache):
        eng = _engine(params, mode, n_slots=1, prefix_cache=cache)
        out = _drive(eng, [Request(prompt=a.copy(), max_new=4),
                           Request(prompt=b.copy(), max_new=4)])
        return eng, out

    e_off, off = run(False)
    e_on, on = run(True)
    _assert_streams_equal(off, on)
    assert e_on.metrics.n_prefix_hits_partial == 1
    assert e_on.metrics.prefix_tokens_saved == 16
    assert e_off.prefill_dispatches - e_on.prefill_dispatches == 2


def test_paged_partial_hit_aliases_the_segment_blocks(params):
    """Paged, a partial hit on a cached 20-token prompt: the slot's table
    starts with the segment's two full blocks, aliased (each referenced by
    that segment, the slot, and the new prompt's own segment, which the
    admission inserts off the slot); the segment's copied tail block is
    never aliased, and every row the slot writes lies in its own
    blocks."""
    a = np.arange(1, 21, dtype=np.int32)
    b = np.concatenate([a, [60, 61, 62, 63]])
    eng = _engine(params, "paged", n_slots=1, prefix_cache=True)
    _drive(eng, [Request(prompt=a.copy(), max_new=4)])
    seg = eng.prefix_cache.lookup(b)[0]
    assert seg.length == 20 and len(seg.block_ids) == 3
    req = Request(prompt=b.copy(), max_new=4)
    eng.submit(req)
    eng.step()
    assert eng.metrics.n_prefix_hits_partial == 1
    blocks = eng.pool.slot_blocks(0)
    assert blocks[:2] == seg.block_ids[:2]
    new = eng.prefix_cache.lookup(b)[0]
    assert new.length == len(b) and new.block_ids[:3] == blocks[:3]
    assert [eng.pool.refcount(x) for x in blocks[:2]] == [3, 3]
    assert not set(blocks[2:]) & set(seg.block_ids)
    assert len(blocks) == eng.pool.blocks_needed(len(b) + req.max_new)
    eng.run()
    assert eng.pool.n_blocks_in_use == _segment_blocks(eng)


@pytest.mark.parametrize("kind", ["full", "partial"])
def test_paged_hit_writes_only_private_blocks(params, kind, monkeypatch):
    """Paged hit admission on a cached 20-token prompt (block size 8): the
    segment's two full blocks are aliased into the slot — their reference
    counts rise by the slot's alias (and, for a partial hit, by the new
    prompt's own segment) and by nothing else — and no write of the
    admission names them, so their bytes are untouched. A full hit copies
    the segment's tail block into the slot's first private block and zeroes
    the rest; a partial hit lands its slab from the matched rows on. The
    stream equals the cache-off engine's."""
    a = np.arange(1, 21, dtype=np.int32)
    b = a.copy() if kind == "full" else np.concatenate([a, [60, 61, 62, 63]])
    eng = _engine(params, "paged", n_slots=1, prefix_cache=True)
    _drive(eng, [Request(prompt=a.copy(), max_new=4)])
    pool = eng.pool
    seg = eng.prefix_cache.lookup(b)[0]
    shared = seg.block_ids[:2]
    refs = [pool.refcount(x) for x in shared]

    def planes():
        return [x.clone() for x in pt._kv_planes(pool.caches)
                if x is not None]

    before = planes()
    written = []

    def spy(name, blocks_of):
        real = getattr(pool, name)

        def f(*args, **kw):
            written.extend(int(x) for x in blocks_of(*args, **kw) if x)
            return real(*args, **kw)
        monkeypatch.setattr(pool, name, f)

    spy("land", lambda slot, slab, start=0:
        pool.table(slot)[start // pool.block_size:])
    spy("copy_block", lambda src, dst: [dst])
    spy("zero_blocks", lambda ids: ids)
    req = Request(prompt=b.copy(), max_new=4)
    eng.submit(req)
    eng._admit(time.perf_counter())
    hits = eng.metrics
    assert (hits.n_prefix_hits_full, hits.n_prefix_hits_partial) == (
        (1, 0) if kind == "full" else (0, 1))
    row = pool.slot_blocks(0)
    assert row[:2] == shared
    assert written and not set(written) & set(shared)
    grow = 1 if kind == "full" else 2
    assert [pool.refcount(x) for x in shared] == [r + grow for r in refs]
    after = planes()
    for x, y in zip(before, after):
        torch.testing.assert_close(x[:, :, shared], y[:, :, shared],
                                   rtol=0, atol=0)
    if kind == "full":
        for y in after:
            torch.testing.assert_close(y[:, :, row[2]],
                                       y[:, :, seg.block_ids[2]],
                                       rtol=0, atol=0)
            assert not y[:, :, row[3:]].any()
    eng.run()
    off = _engine(params, "paged", n_slots=1)
    _assert_streams_equal(
        _drive(off, [Request(prompt=a.copy(), max_new=4),
                     Request(prompt=b.copy(), max_new=4)])[1:],
        [eng.results[req.id]])


def test_short_prompt_segments_serve_full_hits_only(params):
    """A prompt of at most one bucket is prefilled in one program, so its
    rows are not those of the windows a longer prompt computes: its
    segment serves full hits only, and an extension of it misses."""
    a = np.arange(1, 9, dtype=np.int32)
    eng = _engine(params, n_slots=1, prefix_cache=True,
                  prefix_cache_tokens=4 * 64)
    _drive(eng, [Request(prompt=a.copy(), max_new=3),
                 Request(prompt=np.concatenate([a, [9, 10]]), max_new=3),
                 Request(prompt=a.copy(), max_new=3)])
    m = eng.metrics
    assert (m.n_prefix_hits_full, m.n_prefix_hits_partial) == (1, 0)


def test_eviction_never_drops_a_pinned_segment(params):
    """A region of one slab: while the first request decodes, its segment
    is pinned and the second's insert is declined; the segment survives
    and the bytes are the cache-off ones."""
    p1 = np.arange(1, 13, dtype=np.int32)
    p2 = np.arange(30, 42, dtype=np.int32)
    reqs = lambda: [Request(prompt=p1.copy(), max_new=12),  # noqa: E731
                    Request(prompt=p2.copy(), max_new=3)]
    off = _drive(_engine(params), reqs())
    eng = _engine(params, prefix_cache=True, prefix_cache_tokens=1)
    assert eng.prefix_cache.n_region_slots == 1
    on = _drive(eng, reqs())
    _assert_streams_equal(off, on)
    pc = eng.prefix_cache
    assert pc.n_insert_declined == 1 and pc.n_evictions == 0
    assert pc.lookup(p1)[1] == len(p1)


def test_metrics_and_gauges_render(params):
    eng = _engine(params, n_slots=1, prefix_cache=True)
    p = np.arange(1, 9, dtype=np.int32)
    _drive(eng, [Request(prompt=p.copy(), max_new=4),
                 Request(prompt=p.copy(), max_new=4)])
    text = eng.metrics.render_prometheus()
    assert 'serve_prefix_lookups_total{result="hit_full"} 1' in text
    assert 'serve_prefix_lookups_total{result="miss"} 1' in text
    assert "serve_prefix_tokens_saved_total 8" in text
    assert "serve_prefix_inserts_total 1" in text
    assert "serve_prefix_segments 1" in text
    assert "serve_prefix_capacity_tokens" in text
    assert "serve_prefix_region_bytes" in text


def test_scheduler_prefix_affinity_promotes_matches():
    """With affinity, a queued request sharing the hint's first k tokens
    jumps the FIFO of its class (the oldest such); strict priority
    stays."""
    s = RequestScheduler(prefix_affinity_tokens=4)
    x = Request(prompt=[9, 9, 9, 9, 1], max_new=2)
    y = Request(prompt=[1, 2, 3, 4, 5], max_new=2)
    z = Request(prompt=[1, 2, 3, 4, 6], max_new=2)
    hi = Request(prompt=[7, 7], max_new=2, priority=0)
    for r in (x, y, z):
        s.submit(r)
    hint = np.asarray([1, 2, 3, 4, 0])
    assert s.pop(affinity_hint=hint) is y
    s.submit(hi)
    assert s.pop(affinity_hint=hint) is hi
    assert s.pop(affinity_hint=hint) is z
    assert s.pop(affinity_hint=hint) is x
    assert RequestScheduler().pop(affinity_hint=hint) is None


def test_engine_affinity_admits_shared_prefixes_together(params):
    """With prefix_affinity_tokens the default scheduler pops the queued
    same-prefix request right after its sibling: the streams are the
    FIFO engine's."""
    reqs = _requests()
    fifo = _drive(_engine(params, prefix_cache=True), reqs)
    aff = _engine(params, prefix_cache=True, prefix_affinity_tokens=8)
    assert aff.scheduler.prefix_affinity_tokens == 8
    _assert_streams_equal(fifo, _drive(aff, _requests()))


# -- across frameworks -------------------------------------------------------

def test_greedy_matches_reference_engine(jparams, params):
    """The reference engine (cache off) and the port's with the cache on,
    greedy, same prompts and weights: equal except at near-ties of the
    port's own generate logits."""
    jengine = JEngine(JCFG, jparams, n_slots=2, temperature=0.0)
    jreqs = [JRequest(prompt=p.copy(), max_new=6)
             for p in _shared_prefix_prompts()]
    jres = [np.asarray(x) for x in _drive(jengine, jreqs)]
    eng = _engine(params, prefix_cache=True, prefix_cache_tokens=8 * 64)
    res = _drive(eng, [Request(prompt=p.copy(), max_new=6)
                       for p in _shared_prefix_prompts()])
    assert eng.metrics.n_prefix_hits_partial > 0
    gen = pt.transformer_generate(CFG)
    for p, a, b in zip(_shared_prefix_prompts(), jres, res):
        assert a.shape == b.shape
        diff = np.nonzero(a != b)[0]
        if diff.size:
            _, logits = gen(params, torch.from_numpy(p[None]).long(), 6,
                            temperature=0.0, return_logits=True)
            i = int(diff[0]) - len(p)
            top2 = np.sort(logits[i, 0].numpy())[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (p, i, top2)


# -- the CLI -----------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_cli_serve_prefix_piggyback_chaos_on_cpu():
    """``serve --demo --prefix-cache --piggyback --chaos-rate 0.05`` on the
    CPU answers requests past the largest bucket (deferred by piggyback;
    the repeat hits the cache) and reports the new series in /metrics."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--demo",
         "--device", "cpu", "--port", "0", "--d-model", "32",
         "--n-layers", "1", "--n-heads", "2", "--seq-len", "160",
         "--slots", "2", "--temperature", "0", "--prefix-cache",
         "--piggyback", "--prefill-budget", "16", "--chaos-rate", "0.05",
         "--chaos-seed", "3", "--prefix-affinity-tokens", "4"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    try:
        addr = None
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                addr = m.group(1)
                break
        assert addr, "no address announced: " + "".join(lines)
        text = "".join(lines)
        assert "chaos mode: transient faults at rate 0.05 (seed 3)" in text
        assert "piggyback prefill: chunked admission behind decode" in text
        assert "prefix cache:" in text
        # past the 128-token bucket: the piggyback path
        prompt = list(range(1, 141))
        outs = []
        threads = [threading.Thread(target=lambda: outs.append(_post(
            addr + "/v1/generate", {"prompt": prompt, "max_new": 5})))
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        code, body = _post(addr + "/v1/generate",
                           {"prompt": prompt, "max_new": 5})
        assert code == 200 and len(body["tokens"]) == 145
        assert all(c == 200 and b["tokens"] == body["tokens"]
                   for c, b in outs)
        with urllib.request.urlopen(addr + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        assert 'serve_prefix_lookups_total{result="hit_full"}' in metrics
        assert "serve_retries_total" in metrics
        with urllib.request.urlopen(addr + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["restarts"] == 0
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    assert proc.returncode == 0
