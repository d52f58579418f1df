"""Block-paged KV serving in the port (``ServingEngine(paged=True)``).

The bar is the reference's (tests/test_serving_paged.py): a paged engine
streams BYTE-IDENTICAL tokens to the slab engine, greedy and sampled, in
f32, bf16 and full int8, and its greedy streams equal the reference's paged
engine's. Around it: the pool's block accounting (heap order, refcounts,
aliasing, release, admission gate, reinit), no stale KV after block reuse,
a dead slot at pos == Tpad, paging disabled at a block size that does not
divide Tpad, the probe's gating, the block gauges, admission waiting for
blocks, and the CLI flags.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    KVSlotPool,
    PagedKVPool,
    Request,
    ServingEngine,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

CFG = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                           d_ff=64, max_len=32)
INT8_CFG = dataclasses.replace(CFG, decode_int8=True, n_kv_heads=2,
                               rope=True)
BF16_CFG = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
_PARAMS = {}


def _params(cfg=CFG):
    if cfg not in _PARAMS:
        p = pt.init_params(dataclasses.replace(cfg, decode_int8=False),
                           seed=0, device="cpu")
        _PARAMS[cfg] = (pt.quantize_decode_params(p, cfg)
                        if cfg.decode_int8 else p)
    return _PARAMS[cfg]


def _engine(n_slots=3, cfg=CFG, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("decode_horizon", 4)
    return ServingEngine(cfg, _params(cfg), n_slots=n_slots, device="cpu",
                         **kw)


def _paged(n_slots=3, cfg=CFG, **kw):
    kw.setdefault("block_size", 8)
    eng = _engine(n_slots=n_slots, cfg=cfg, paged=True, **kw)
    assert eng._paged, "paged engine silently fell back to slab"
    return eng


def _requests(n, seed=0, max_new=(4, 10)):
    rng = np.random.default_rng(seed)
    return [
        Request(prompt=rng.integers(0, 64, (int(rng.integers(3, 14)),))
                .astype(np.int32),
                max_new=int(rng.integers(*max_new)), id=f"r{seed}-{i}")
        for i in range(n)
    ]


def _clone(reqs):
    return [Request(prompt=np.array(r.prompt), max_new=r.max_new, id=r.id)
            for r in reqs]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.id: np.asarray(engine.results[r.id]) for r in reqs}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# -- the pool ----------------------------------------------------------------------

def test_paged_pool_accounting():
    pool = PagedKVPool(CFG, n_slots=3, max_total=32,
                       device=torch.device("cpu"), block_size=8)
    assert (pool.tpad, pool.blocks_per_slot, pool.n_blocks) == (32, 4, 13)
    assert pool.caches.shape == (2, 2, 13, 8, 32)
    assert pool.block_nbytes() == 2 * 2 * 8 * 32 * 4
    assert pool.n_free_blocks == 12 and pool.n_blocks_in_use == 0
    assert pool.blocks_needed(0) == 0 and pool.blocks_needed(9) == 2
    s0, s1 = pool.acquire(), pool.acquire()
    v = pool.version
    # lowest id first, 1-based (0 is the sentinel)
    assert pool.alloc_slot_blocks(s0, 10) == [1, 2]
    assert pool.alloc_slot_blocks(s1, 32) == [3, 4, 5, 6]
    assert pool.version > v
    np.testing.assert_array_equal(pool.table(s0), [1, 2, 0, 0])
    # grow coverage past aliased entries
    assert pool.alloc_slot_blocks(s0, 24, start=2) == [7]
    # aliasing: a shared block survives its first holder's release
    seg = pool.alloc_blocks(1)
    assert seg == [8] and pool.refcount(8) == 1
    s2 = pool.acquire()
    pool.alias_into_slot(s2, [3, 8])
    assert pool.refcount(3) == 2 and pool.refcount(8) == 2
    pool.release(s1)
    assert pool.refcount(3) == 1 and 3 not in pool._free_blocks
    assert pool.refcount(4) == 0
    np.testing.assert_array_equal(pool.table(s1), [0, 0, 0, 0])
    pool.incref([8])
    pool.decref([8, 8])
    assert pool.refcount(8) == 1
    pool.release(s2)
    assert pool.refcount(3) == 0 and pool.refcount(8) == 0
    # the freed blocks come back lowest first
    s1 = pool.acquire()
    assert pool.alloc_slot_blocks(s1, 16) == [3, 4]
    assert pool.n_free_blocks == 7 and pool.n_blocks_in_use == 5
    assert pool.can_admit(8 * 7) and not pool.can_admit(8 * 7 + 1)
    with pytest.raises(RuntimeError, match="no free KV blocks"):
        pool.alloc_blocks(9)
    with pytest.raises(RuntimeError, match="slot tables hold"):
        pool.alloc_slot_blocks(s1, 40)
    pool.caches[:, :, 1] = 5.0
    pool.reinit()
    assert float(pool.caches.abs().sum()) == 0.0
    assert pool.n_free_blocks == 12 and pool.refcount(0) == 1
    assert not pool.tables().any()
    assert pool.n_active == 2  # slot bookkeeping survives reinit


def test_paged_pool_geometry_rules():
    with pytest.raises(ValueError, match="power of two"):
        PagedKVPool(CFG, 2, 32, torch.device("cpu"), block_size=12)
    with pytest.raises(ValueError, match="does not divide"):
        PagedKVPool(CFG, 2, 24, torch.device("cpu"), block_size=16)
    pool = PagedKVPool(INT8_CFG, 2, 24, torch.device("cpu"), block_size=8)
    assert pool.caches["kv"].shape == (2, 2, 7, 8, 16)
    assert pool.caches["kv"].dtype == torch.int8
    assert pool.caches["scale"].shape == (2, 2, 7, 8, 1)
    slab = KVSlotPool(INT8_CFG, 2, 24, torch.device("cpu"))
    assert slab.slab(1)["scale"].shape == (2, 2, 1, 24, 1)


def test_paged_views_match_reference():
    """``paged_gather``/``paged_scatter``/``paged_slot_gather``/
    ``paged_slot_scatter``/``paged_block_copy`` against the reference's
    (transformer.py:1390-1454), leafwise over an int8 dict, with a
    shuffled table, an aliased block and a dirty sentinel."""
    jnp = pytest.importorskip("jax.numpy")
    jt = pytest.importorskip("deeplearning4j_tpu.models.transformer")
    rng = np.random.default_rng(7)
    nb, bs, w = 7, 8, 16
    blocks = {
        "kv": rng.integers(-127, 128, (2, 2, nb, bs, w)).astype(np.int8),
        "scale": rng.random((2, 2, nb, bs, 1)).astype(np.float32),
    }
    tables = np.array([[3, 1, 0], [3, 5, 6]], np.int32)
    view = {
        "kv": rng.integers(-127, 128, (2, 2, 2, 3 * bs, w)).astype(np.int8),
        "scale": rng.random((2, 2, 2, 3 * bs, 1)).astype(np.float32),
    }
    view["kv"][:, :, 1, :bs] = view["kv"][:, :, 0, :bs]  # the aliased block
    view["scale"][:, :, 1, :bs] = view["scale"][:, :, 0, :bs]

    def port(x):
        return {k: torch.from_numpy(v.copy()) for k, v in x.items()}

    def same(got, ref):
        for k in ("kv", "scale"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))

    jb = {k: jnp.asarray(v) for k, v in blocks.items()}
    jv = {k: jnp.asarray(v) for k, v in view.items()}
    jtab = jnp.asarray(tables)
    same(pt.paged_gather(port(blocks), torch.from_numpy(tables)),
         jt.paged_gather(jb, jtab))
    same(pt.paged_scatter(port(blocks), torch.from_numpy(tables),
                          port(view)),
         jt.paged_scatter(jb, jtab, jv))
    row = torch.from_numpy(tables[1])
    same(pt.paged_slot_gather(port(blocks), row),
         jt.paged_slot_gather(jb, jtab[1]))
    slab = {k: v[:, :, :1] for k, v in view.items()}
    same(pt.paged_slot_scatter(port(blocks), row, port(slab)),
         jt.paged_slot_scatter(jb, jtab[1], {k: jnp.asarray(v)
                                             for k, v in slab.items()}))
    same(pt.paged_block_copy(port(blocks), 4, 2),
         jt.paged_block_copy(jb, 4, 2))
    same(pt.paged_block_copy(port(blocks), 0, 2),
         jt.paged_block_copy(jb, 0, 2))


# -- paged vs slab parity ------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("cfg", [CFG, INT8_CFG, BF16_CFG],
                         ids=["f32", "int8", "bf16"])
def test_paged_on_off_byte_parity(cfg, temperature):
    """Slab vs paged engines over staggered requests at slot contention:
    byte-identical streams, greedy and sampled; every block comes back."""
    reqs = _requests(8, seed=1)
    slab = _run(_engine(cfg=cfg, temperature=temperature), _clone(reqs))
    eng = _paged(cfg=cfg, temperature=temperature)
    paged = _run(eng, _clone(reqs))
    _assert_same(slab, paged)
    assert isinstance(eng.pool, PagedKVPool)
    assert eng.pool.n_blocks_in_use == 0


def test_paged_long_prompt_and_dead_slot_at_tpad():
    """A chunked prompt (past the 16-row largest bucket here) and a slot
    whose prompt + max_new == Tpad: its dead decode writes at pos == Tpad
    go to the sentinel, and every stream equals the port's generate."""
    cfg = dataclasses.replace(CFG, max_len=64)
    params = pt.init_params(cfg, seed=2, device="cpu")
    fill = Request(prompt=np.arange(18) % 64, max_new=6, id="fill")
    short = Request(prompt=np.arange(5), max_new=15, id="short")
    eng = ServingEngine(cfg, params, n_slots=2, max_total=24,
                        decode_horizon=1, device="cpu", paged=True)
    assert eng._paged and eng.pool.tpad == 24
    res = _run(eng, [fill, short])
    gen = pt.transformer_generate(cfg)
    for r in (fill, short):
        ref = gen(params, torch.from_numpy(r.prompt[None]).long(),
                  r.max_new, temperature=0.0)
        np.testing.assert_array_equal(res[r.id], ref[0].numpy())
    assert float(eng.pool.caches[:, :, 0].abs().sum()) == 0.0
    long = Request(prompt=np.arange(3, 43) % 64, max_new=20, id="long")
    short = Request(prompt=np.arange(5), max_new=30, id="short")
    eng = ServingEngine(cfg, params, n_slots=2, max_total=64,
                        decode_horizon=2, device="cpu", paged=True)
    eng._max_bucket = 16  # the chunked path on a 40-token prompt
    res = _run(eng, [long, short])
    for r in (long, short):
        ref = gen(params, torch.from_numpy(r.prompt[None]).long(),
                  r.max_new, temperature=0.0)
        np.testing.assert_array_equal(res[r.id], ref[0].numpy())


def test_paged_dense_decode_path():
    """decode_kernel=False: the paged step gathers, runs the dense chunk
    block and scatters back; streams equal the slab engine's."""
    cfg = dataclasses.replace(CFG, decode_kernel=False)
    reqs = _requests(5, seed=4)
    _assert_same(_run(_engine(cfg=cfg), _clone(reqs)),
                 _run(_paged(cfg=cfg), _clone(reqs)))


def test_paged_no_stale_kv_after_block_reuse():
    """A slot's freed blocks are reused by the next admission; its stream
    equals a fresh engine's (the prefill scatter overwrites every
    allocated block)."""
    eng = _paged(n_slots=1)
    r1 = Request(prompt=np.arange(1, 20, dtype=np.int32), max_new=8)
    r2 = Request(prompt=np.arange(30, 37, dtype=np.int32), max_new=8)
    _run(eng, [r1])
    assert eng.pool.n_blocks_in_use == 0
    got = _run(eng, [r2])[r2.id]
    fresh = _paged(n_slots=1)
    r2b = Request(prompt=np.array(r2.prompt), max_new=r2.max_new)
    np.testing.assert_array_equal(got, _run(fresh, [r2b])[r2b.id])


def test_paged_greedy_matches_reference_paged_engine():
    """Greedy streams of the reference's paged engine (its test config,
    tests/test_serving_paged.py:47-49, block size 8) and the port's, on the
    same weights; f32, so only a near-tie may flip a token."""
    jax = pytest.importorskip("jax")
    jt = pytest.importorskip("deeplearning4j_tpu.models.transformer")
    js = pytest.importorskip("deeplearning4j_tpu.serving")
    jcfg = jt.TransformerConfig.from_json(CFG.to_json())
    jparams = jt.init_transformer(jax.random.key(0), jcfg)
    tparams = pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                 device="cpu")
    reqs = _requests(6, seed=3)
    jeng = js.ServingEngine(jcfg, jparams, n_slots=3, temperature=0.0,
                            paged=True, block_size=8)
    assert jeng._paged
    jreqs = [js.Request(prompt=np.array(r.prompt), max_new=r.max_new,
                        id=r.id) for r in reqs]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = ServingEngine(CFG, tparams, n_slots=3, decode_horizon=4,
                        device="cpu", paged=True, block_size=8)
    got = _run(eng, _clone(reqs))
    gen = pt.transformer_generate(CFG)
    for r in reqs:
        a, b = np.asarray(jeng.results[r.id]), got[r.id]
        assert a.shape == b.shape
        diff = np.nonzero(a != b)[0]
        if diff.size:
            _, logits = gen(tparams, torch.from_numpy(r.prompt[None]).long(),
                            r.max_new, temperature=0.0, return_logits=True)
            i = int(diff[0]) - len(r.prompt)
            top2 = np.sort(logits[i, 0].numpy())[-2:]
            assert top2[1] - top2[0] < 1e-4, (r.id, i, top2)


# -- gating, gauges, admission ---------------------------------------------------------

def test_paged_disabled_on_indivisible_block_size(caplog):
    """A block size that does not divide Tpad disables paging (logged)
    instead of crashing, and the slab engine still serves."""
    assert _engine(paged=True, block_size=32)._paged  # Tpad = 32
    with caplog.at_level(logging.WARNING):
        eng = _engine(paged=True, block_size=64)
    assert not eng._paged and not isinstance(eng.pool, PagedKVPool)
    assert "paged_disabled_bad_block_size" in caplog.text
    assert not _engine(paged=True, block_size=16, max_total=24)._paged
    reqs = _requests(3, seed=11)
    _assert_same(_run(_engine(), _clone(reqs)), _run(eng, _clone(reqs)))


def test_paged_parity_probe_gates_the_layout(monkeypatch, caplog):
    """A probe mismatch falls back to slabs with a logged
    ``paged_parity_probe_failed``; a probe that raises propagates (a kernel
    that fails to build or launch is never swallowed); ``paged_parity``
    True skips the probe; paging is turned off by ``paged=False`` only."""
    assert _engine(paged=True, paged_parity=True)._paged
    with pytest.raises(ValueError, match="paged_parity"):
        _engine(paged=True, paged_parity=False)
    monkeypatch.setattr(ServingEngine, "_probe_paged_parity",
                        lambda self, bs: False)
    with caplog.at_level(logging.WARNING):
        eng = _engine(paged=True)
    assert not eng._paged and "paged_parity_probe_failed" in caplog.text

    def boom(self, bs):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(ServingEngine, "_probe_paged_parity", boom)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _engine(paged=True)


def test_paged_block_gauges():
    eng = _paged(n_slots=2)
    eng.submit(Request(prompt=np.arange(5), max_new=20))
    eng.step()
    text = eng.metrics.registry.render()
    assert "serve_kv_blocks 8" in text
    assert "serve_kv_block_size 8" in text
    assert "serve_kv_blocks_in_use 4" in text  # ceil(25 / 8)
    assert "serve_kv_blocks_free 4" in text
    eng.run()
    assert "serve_kv_blocks_in_use 0" in eng.metrics.registry.render()
    assert "serve_kv_blocks" not in _engine().metrics.registry.render()


def test_admission_waits_for_blocks():
    """With blocks held elsewhere (as a prefix cache would hold them), a
    request whose blocks do not fit waits in the queue, a free slot
    notwithstanding; it is admitted once blocks come back, and its stream
    is unchanged."""
    reqs = _requests(2, seed=6, max_new=(18, 19))
    ref = _run(_engine(), _clone(reqs))
    eng = _paged(n_slots=2)
    need = [eng.pool.blocks_needed(len(r.prompt) + r.max_new) for r in reqs]
    held = eng.pool.alloc_blocks(eng.pool.n_free_blocks - need[0])
    for r in _clone(reqs):
        eng.submit(r)
    eng.step()
    assert eng.pool.n_active == 1 and len(eng.scheduler) == 1
    eng.step()
    assert eng.pool.n_active == 1 and len(eng.scheduler) == 1
    eng.pool.decref(held)
    eng.run()
    _assert_same(ref, {r.id: np.asarray(eng.results[r.id]) for r in reqs})
    assert eng.pool.n_blocks_in_use == 0


def test_scheduler_pop_admissible_falls_through_classes():
    from deeplearning4j_tpu_torch.serving import RequestScheduler

    sched = RequestScheduler()
    big = Request(prompt=np.arange(20), max_new=4, priority=0)
    small = Request(prompt=np.arange(2), max_new=4, priority=1)
    later = Request(prompt=np.arange(3), max_new=4, priority=1)
    for r in (big, small, later):
        sched.submit(r)
    fits = lambda r: len(r.prompt) < 10  # noqa: E731
    assert sched.pop(admissible=fits) is small
    assert sched.pop(admissible=lambda r: r is not later) is big
    assert sched.pop(admissible=lambda r: False) is None
    assert sched.pop() is later


# -- the CLI ---------------------------------------------------------------------------

def test_cli_serve_int8_paged_on_cpu():
    """``serve --demo --int8 full --paged`` comes up paged and answers."""
    import json
    import os
    import re
    import signal
    import subprocess
    import sys
    import urllib.request

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--demo",
         "--device", "cpu", "--port", "0", "--d-model", "32",
         "--n-layers", "1", "--n-heads", "2", "--seq-len", "31",
         "--slots", "2", "--temperature", "0", "--int8", "full", "--paged",
         "--block-size", "8"],
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
        body = json.dumps({"prompt": "abc", "max_new": 4}).encode()
        req = urllib.request.Request(
            addr + "/v1/generate", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            assert len(json.loads(resp.read())["tokens"]) == 7
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    out = "".join(lines)
    assert "int8 serving mode: full" in out
    assert "paged KV: 9 blocks x 8 tokens" in out
    assert proc.returncode == 0


def test_cli_reports_paging_disabled(monkeypatch, capsys):
    """A block size that does not divide tokens-per-slot prints ``paged KV
    DISABLED``, as the reference's CLI does."""
    from deeplearning4j_tpu_torch import cli, serving

    class NoServer:
        def __init__(self, engine, **kw):
            self.address = ("127.0.0.1", 0)
            self.metrics_address = None  # no sidecar

        def serve_forever(self, drain_s):
            pass

    monkeypatch.setattr(serving, "ServingServer", NoServer)
    rc = cli.main(["serve", "--demo", "--device", "cpu", "--d-model", "32",
                   "--n-layers", "1", "--n-heads", "2", "--seq-len", "31",
                   "--slots", "1", "--paged", "--block-size", "64"])
    assert rc == 0
    assert "paged KV DISABLED" in capsys.readouterr().err
