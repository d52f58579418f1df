"""Exact tensor-parallel serving in the port (``parallel/mesh.py``, the
layout in ``models/transformer.py``, the engine's ``tp``), held against
the reference's ``tests/test_serving_tp.py`` (:112-:211, :516).

The mesh is a list of devices, here ``["cpu"] * tp``, the counterpart of
the reference tests' virtual host devices. Bars:

- within the port, the reference's: TP=2 and TP=4 engines come up with
  ``eng.tp == tp`` (the parity probe passing) and their streams are
  byte-identical to the TP=1 engine's, greedy and T 0.8, across prefill
  buckets and through crash replay (stepwise and "auto"); tp=3 over 4
  heads falls back to 1 with ``tp_parity_probe_failed``; the probe cache
  skips the re-probe and keys verdicts by tp; every rank holds its shard's
  shape; one decode substep makes ``tp_collective_contract``'s gathers; the
  layout functions raise as the reference's do; the router over two TP=2
  servers answers the TP=1 tokens;
- across the packages: the reference's params and LoRA bank, carried
  across with ``params_from_jax``/``lora_bank_from_jax`` and placed at tp
  2, serve the reference's single-device dense engine's streams, except
  where a near-tie flips a token (the rule of ``test_torch_disagg.py``).

The reference's own TP tests fail on this CPU, so they are no target.
"""

import dataclasses
import http.client
import json
import logging
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    model_parallel_mesh,
)
from deeplearning4j_tpu_torch.serving import (
    FaultInjector,
    Request,
    ServingEngine,
    ServingServer,
)
from deeplearning4j_tpu_torch.serving.router import ReplicaRouter
from tests.test_torch_disagg import _check_near_tie

pytestmark = pytest.mark.tp_serve

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

#: the reference tests' config; TP forces the dense decode, so every
#: comparison is dense against dense
JCFG = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_len=32, decode_kernel=False)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
TEMP = 0.8


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _cpu_mesh(tp):
    return model_parallel_mesh(tp, ["cpu"] * tp)


def _engine(params, tp=1, cfg=CFG, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("decode_horizon", 2)
    kw.setdefault("n_slots", 4)
    return ServingEngine(cfg, params, device="cpu", tp=tp,
                         tp_devices=["cpu"] * tp if tp > 1 else None,
                         retry_backoff_s=0.001, max_backoff_s=0.004, **kw)


def _requests(n, seed=0, max_new=(4, 10), cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 64, (int(rng.integers(3, 12)),))
                .astype(np.int32),
                max_new=int(rng.integers(*max_new)), id=f"r{seed}-{i}")
            for i in range(n)]


def _clone(reqs, cls=Request):
    return [cls(prompt=np.array(r.prompt), max_new=r.max_new, id=r.id)
            for r in reqs]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.id: engine.pop_result(r.id) for r in reqs}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the mesh and the layout ----------------------------------------------------


def test_mesh_devices_and_its_message(monkeypatch):
    m = _cpu_mesh(2)
    assert m.size == 2
    assert all(d.type == "cpu" for d in m.devices)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 3 devices for a 'model' "
                                         "mesh, have 0"):
        model_parallel_mesh(3)
    with pytest.raises(ValueError, match="need 2 devices"):
        model_parallel_mesh(2, ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="takes 2 devices"):
        model_parallel_mesh(2, ["cpu"])
    with pytest.raises(ValueError, match="tp must be"):
        model_parallel_mesh(0)
    # the gather is an exact concatenation, counted
    parts = [torch.arange(3.0), torch.arange(3.0, 5.0)]
    assert torch.equal(m.gather(parts), torch.arange(5.0))
    assert m.gathers == 1


def test_layout_raises_as_the_reference():
    with pytest.raises(ValueError, match="dividing n_heads"):
        pt.serving_tp_shardings(_cpu_mesh(3), CFG)
    gqa = dataclasses.replace(CFG, n_kv_heads=2)
    with pytest.raises(ValueError, match="kv_heads"):
        pt.serving_tp_shardings(_cpu_mesh(4), gqa)
    assert pt.serving_tp_shardings(_cpu_mesh(2), gqa)["blocks"]["wq"] == 2
    with pytest.raises(ValueError, match="MoE"):
        pt.serving_tp_shardings(
            _cpu_mesh(2), dataclasses.replace(CFG, n_experts=2))
    with pytest.raises(ValueError, match="decode_kernel=False"):
        pt._decode_builder(dataclasses.replace(CFG, decode_kernel=True),
                           _cpu_mesh(2))
    with pytest.raises(ValueError, match="dividing n_heads"):
        pt._chunk_builder(CFG, _cpu_mesh(3))
    spec = pt.serving_tp_shardings(_cpu_mesh(2), CFG, lora=True)
    assert spec["blocks"]["wo"] is None and spec["blocks"]["w2"] is None
    assert spec["lora"] == {"a_q": None, "b_q": 3, "a_mlp": None,
                            "b_mlp": 3}
    assert pt.serving_tp_cache_sharding(_cpu_mesh(2), CFG) == 4
    assert pt.serving_tp_cache_sharding(
        _cpu_mesh(2), dataclasses.replace(CFG, decode_int8=True)) == {
        "kv": 4, "scale": None}


@pytest.mark.parametrize("tp", [2, 4])
def test_per_rank_shard_shapes(params, tp):
    """Each rank holds its heads, d_ff columns and vocab columns (int8
    scales follow their weights; the LoRA B factors their output dim);
    row projections and norms are whole on the first device; the pool's
    buffers are per rank (nl, 2, slots, Tpad, Hkv/tp*K)."""
    mesh = _cpu_mesh(tp)
    cfg8 = dataclasses.replace(CFG, decode_int8=True)
    q = pt.quantize_decode_params(params, cfg8)
    q["lora"] = pt.init_lora_bank(0, cfg8, 4, 2, device="cpu")
    placed = pt.place_serving_tp_params(mesh, q, cfg8)
    b = placed["blocks"]
    nl, d, h, k, f, v = 2, 32, 4, 8, 64, 64
    want = {"wqkv": (nl, d, 3, h // tp, k), "wqkv_scale": (nl, 1, 3, h // tp,
                                                           k),
            "w1": (nl, d, f // tp), "w1_scale": (nl, 1, f // tp),
            "b1": (nl, f // tp)}
    for name, shape in want.items():
        assert isinstance(b[name], Shards) and len(b[name]) == tp
        assert all(tuple(p.shape) == shape for p in b[name]), name
    for name in ("wo", "w2", "wo_scale", "w2_scale", "ln1_scale", "b2"):
        assert isinstance(b[name], torch.Tensor), name
    assert [tuple(p.shape) for p in placed["head"]] == [(d, v // tp)] * tp
    assert [tuple(p.shape) for p in placed["head_scale"]] == [(1, v // tp)] * tp
    assert [tuple(p.shape) for p in placed["lora"]["b_q"]] == [
        (nl, 4, 2, h * k // tp)] * tp
    assert isinstance(placed["lora"]["a_q"], torch.Tensor)
    # the parts are the whole weight's slices, bitwise
    assert torch.equal(torch.cat(list(b["wqkv"]), dim=3),
                       q["blocks"]["wqkv"])
    eng = _engine(params, tp=tp, cfg=cfg8,
                  n_slots=3)
    assert eng.tp == tp
    kv, sc = eng.pool.caches["kv"], eng.pool.caches["scale"]
    tpad = eng.pool.tpad
    assert [tuple(p.shape) for p in kv] == [(nl, 2, 3, tpad, h * k // tp)] * tp
    assert [tuple(p.shape) for p in sc] == [(nl, 2, 3, tpad, 1)] * tp
    assert eng.pool.nbytes() == sum(p.numel() * p.element_size()
                                    for p in [*kv, *sc])


def test_gathers_per_substep_equal_the_contract(params):
    """One decode substep of the TP program makes 2 * n_layers + 1 gathers
    (the attention output and the gelu hidden of each layer, the logits);
    a pass over the LoRA bank two more (its B rows)."""
    mesh = _cpu_mesh(2)
    fwd1, init, prefill, cast = pt._decode_builder(CFG, mesh)
    p = cast(pt.place_serving_tp_params(mesh, params, CFG))
    caches, lg = prefill(p, init(2, 16, "cpu"),
                         torch.arange(1, 7).reshape(2, 3))
    assert mesh.gathers == pt.tp_collective_contract(CFG)["gather"] == 5
    mesh.gathers = 0
    for _ in range(3):
        lg, caches = fwd1(p, caches, lg.argmax(-1).to(torch.int32),
                          torch.full((2,), 3, dtype=torch.int32))
    assert mesh.gathers == pt.tp_collective_contract(CFG, 3)["gather"]
    bank = pt.init_lora_bank(0, CFG, 4, 2, device="cpu")
    pl = cast(pt.place_serving_tp_params(mesh, {**params, "lora": bank},
                                         CFG))
    mesh.gathers = 0
    fwd1(pl, caches, lg.argmax(-1).to(torch.int32),
         torch.full((2,), 4, dtype=torch.int32),
         torch.tensor([1, 0], dtype=torch.int32))
    assert mesh.gathers == pt.tp_collective_contract(CFG, lora=True)[
        "gather"] == 7


# -- streams: TP=N against TP=1 ---------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_tp_streams_byte_identical_to_tp1(params, tp, temperature):
    """The headline bar: sharded params, sharded pool, fused horizons and
    batched admission give the single-device engine's streams."""
    reqs = _requests(6, seed=1)
    base = _run(_engine(params, temperature=temperature), reqs)
    eng = _engine(params, tp=tp, temperature=temperature)
    assert eng.tp == tp and eng.tp_mesh is not None, eng.probes_run
    assert eng.probes_run[0] == "tp_parity"
    assert eng.device.type == "cpu"
    _same(base, _run(eng, _clone(reqs)))
    assert eng.metrics.registry.get("serve_tp_degree").value() == tp


@pytest.mark.parametrize("batch", [False, "auto"], ids=["serial", "batched"])
def test_tp_prefill_bucketing_parity_across_prompt_lengths(params, batch):
    """Prompt lengths 1-20 straddle the buckets 8 and 16 and the chunked
    path past the largest bucket (16 here): one bucketed prefill a
    request, or the batched admission programs."""
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(0, 64, (n,)).astype(np.int32),
                    max_new=4, id=f"p{n}")
            for n in (1, 2, 3, 7, 8, 9, 15, 16, 17, 20)]
    kw = dict(n_slots=8, prefill_max_bucket=16, batch_admission=batch)
    base = _run(_engine(params, **kw), reqs)
    eng = _engine(params, tp=2, **kw)
    assert eng.tp == 2
    _same(base, _run(eng, _clone(reqs)))
    if batch is False:
        assert eng.prefill_dispatches == len(reqs) + 2  # 17, 20: 2 chunks
    else:
        assert eng.metrics.n_batched_admissions > 0


@pytest.mark.parametrize("replay", [False, "auto", True],
                         ids=["stepwise", "auto", "chunked"])
def test_tp_crash_recovery_replay_parity(params, replay):
    """A crash mid-run under TP=2: replay rebuilds the sharded pool, and
    the recovered streams equal the TP=1 engine's under the same crash
    and replay mode. "auto" probes the chunked replay on the sharded
    programs and decides as the TP=1 engine does (on this CPU it declines
    for both); stepwise replay also gives the unfaulted run's streams."""
    reqs = _requests(4, seed=3)
    clean = _run(_engine(params, temperature=TEMP), reqs)
    runs = {}
    for tp in (1, 2):
        eng = _engine(params, tp=tp, temperature=TEMP,
                      faults=FaultInjector().plan("step", at=2, kind="crash"),
                      chunked_replay=replay)
        assert eng.tp == tp
        runs[tp] = (eng, _run(eng, _clone(reqs)))
        assert eng.metrics.n_restarts == 1
    (e1, s1), (e2, s2) = runs[1], runs[2]
    assert e2.last_recover_mode == e1.last_recover_mode == (
        "chunked" if replay is True
        else "stepwise" if replay is False else e1.last_recover_mode)
    _same(s1, s2)
    if e2.last_recover_mode == "stepwise":
        _same(clean, s2)


def test_tp3_over_four_heads_falls_back(params, caplog):
    """tp 3 over 4 heads falls back to tp 1 with the caller's config: a
    config with the kernels keeps them (on the CPU their plain versions),
    and the fallback serves the tp-1 engine's streams of that config."""
    kcfg = dataclasses.replace(CFG, decode_kernel=True, use_flash=True)
    with caplog.at_level(logging.WARNING):
        eng = _engine(params, tp=3, cfg=kcfg)
    assert eng.tp == 1 and eng.tp_mesh is None
    assert "tp_parity_probe_failed" in caplog.text
    assert "tp_parity_probe_error" in caplog.text
    assert eng.cfg == kcfg and eng.cfg.decode_kernel and eng.cfg.use_flash
    reqs = _requests(3, seed=4)
    _same(_run(_engine(params, cfg=kcfg), reqs), _run(eng, _clone(reqs)))


@pytest.mark.parametrize("rows,where", [
    (16, "the prefill of 16 rows"), (32, "the prefill of 32 rows"),
    ((4, 1), "decode step 1 at 4 rows")])
def test_tp_probe_runs_every_bucket_and_the_decode(params, monkeypatch,
                                                   rows, where):
    """The probe runs the engine's shapes: each prompt bucket's prefill
    (8 to 32 rows here) and chunk window, and the decode at the engine's
    batch. A sharded program that differs only at one of them (a gather
    of that shape nudged) declines, naming where."""
    real = Mesh.gather

    def gather(self, parts, dim=-1):
        out = real(self, parts, dim)
        shape = (rows,) if isinstance(rows, int) else rows
        if out.dim() == 3 and tuple(out.shape[-1 - len(shape):-1]) == shape:
            out = out + 1
        return out

    monkeypatch.setattr(Mesh, "gather", gather)
    eng = _engine(params, tp=2)
    assert eng.tp == 1 and eng.tp_mesh is None
    assert eng.tp_probe_detail.startswith(f"logits differ first at {where};")


def test_tp1_is_the_unsharded_engine(params):
    eng = _engine(params, tp=1)
    assert eng.tp == 1 and eng.tp_mesh is None
    assert isinstance(eng.pool.caches, torch.Tensor)
    assert _engine(params, tp=2, tp_parity=False).tp_mesh is None
    trusted = _engine(params, tp=2, tp_parity=True)
    assert trusted.tp == 2 and "tp_parity" not in trusted.probes_run
    with pytest.raises(ValueError, match="tp_parity"):
        _engine(params, tp=2, tp_parity="trust")


def test_probe_cache_skips_reprobe_and_keys_by_tp(params, tmp_path):
    """The first engine pays the probes and persists the verdicts; a
    second of the same width reads every one; a width of its own (tp 4)
    probes again."""
    path = str(tmp_path / "probes.json")
    e1 = _engine(params, tp=2, probe_cache=path)
    assert "tp_parity" in e1.probes_run
    reqs = _requests(4, seed=5)
    base = _run(e1, reqs)
    assert "batch_admission" in e1.probes_run
    e2 = _engine(params, tp=2, probe_cache=path)
    assert e2.tp == 2 and e2.probes_run == []
    assert "tp_parity" in e2.probes_from_cache
    _same(base, _run(e2, _clone(reqs)))
    assert e2.probes_run == []
    e4 = _engine(params, tp=4, probe_cache=path)
    assert e4.tp == 4 and "tp_parity" in e4.probes_run
    e1b = _engine(params, tp=1, probe_cache=path)
    _run(e1b, _clone(reqs))
    assert "batch_admission" in e1b.probes_run  # tp 1's own key


# -- the router over TP replicas ------------------------------------------------


def _post(addr, body):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_router_over_tp_replicas(params):
    """Two replicas each serving at TP=2 behind the affinity router: the
    streams are the TP=1 engine's byte for byte through the fleet path
    (the reference's ``test_router_over_tp_replicas``)."""
    reqs = _requests(4, seed=19, max_new=(3, 6))
    base = _run(_engine(params), _clone(reqs))
    servers = []
    for _ in range(2):
        eng = _engine(params, tp=2)
        assert eng.tp == 2
        servers.append(ServingServer(eng, port=0).start())
    router = ReplicaRouter([s.address for s in servers],
                           affinity_min_match=6).start()
    try:
        for r in reqs:
            st, out = _post(router.address, {
                "prompt": [int(t) for t in r.prompt], "max_new": r.max_new})
            assert st == 200, out
            assert out["tokens"] == [int(t) for t in base[r.id]], r.id
    finally:
        router.stop()
        for s in servers:
            s.stop()


# -- across the packages -----------------------------------------------------------


def _ref_streams(jparams, reqs, temperature, seed, bank=None):
    je = JEngine(JCFG, jparams, n_slots=4, temperature=temperature,
                 decode_horizon=2, rng_seed=seed, lora_bank=bank,
                 lora_parity=True if bank is not None else "auto")
    jr = [JRequest(prompt=np.array(r.prompt), max_new=r.max_new, id=r.id,
                   adapter=r.adapter, done=threading.Event()) for r in reqs]
    for r in jr:
        je.submit(r)
    res = je.run()
    return {r.id: np.asarray(res[r.id]) for r in jr}


def _slot_keys(seed, n):
    k, subs = threefry.key(seed), []
    for _ in range(n):
        k, sub = threefry.split(k)
        subs.append(sub)
    return subs


@pytest.mark.parametrize("temperature", [0.0, TEMP], ids=["greedy", "T0.8"])
def test_reference_params_at_tp2_serve_the_reference_streams(
        jparams, params, temperature):
    """The reference's params, carried across and placed at tp 2, serve
    the reference single-device dense engine's streams (one admission
    wave, so slot keys go out in submission order), or part at a near-tie
    of the reference's logits."""
    reqs = _requests(4, seed=21, max_new=(4, 8))
    ref = _ref_streams(jparams, reqs, temperature, seed=5)
    eng = _engine(params, tp=2, temperature=temperature, rng_seed=5)
    assert eng.tp == 2
    got = _run(eng, _clone(reqs))
    keys = _slot_keys(5, len(reqs))
    for r, key in zip(reqs, keys):
        _check_near_tie(jparams, params, ref[r.id], got[r.id], temperature,
                        key)


def test_reference_lora_bank_at_tp2_serves_the_reference_streams(jparams,
                                                                 params):
    """The reference's LoRA bank through ``lora_bank_from_jax``, placed
    with the params at tp 2: a mixed batch (adapters 1, 2, 3, 0) greedy
    gives the reference engine's streams; a divergence may only be an
    adapter-0 near-tie."""
    jbank = jt.init_lora_bank(jax.random.key(1), JCFG, n_adapters=4, rank=2)
    bank = pt.lora_bank_from_jax(jax.tree.map(np.asarray, jbank), CFG,
                                 device="cpu")
    prompt = np.random.default_rng(6).integers(0, 64, (7,)).astype(np.int32)
    reqs = [Request(prompt=prompt.copy(), max_new=6, adapter=a, id=f"a{a}")
            for a in (1, 2, 3, 0)]
    ref = _ref_streams(jparams, reqs, 0.0, seed=0, bank=jbank)
    eng = _engine(params, tp=2, lora_bank=bank)
    assert eng.tp == 2 and eng.n_adapters == 4
    got = _run(eng, [Request(prompt=r.prompt.copy(), max_new=r.max_new,
                             adapter=r.adapter, id=r.id) for r in reqs])
    for r in reqs:
        if not np.array_equal(ref[r.id], got[r.id]):
            assert r.adapter == 0, (r.adapter, ref[r.id], got[r.id])
            _check_near_tie(jparams, params, ref[r.id], got[r.id], 0.0,
                            None)


# -- the command line ------------------------------------------------------------


def test_cli_tp_exits_2_without_the_cards(monkeypatch, capsys):
    """``serve --tp 2`` on a machine with fewer than 2 cards exits 2 with
    the mesh's message before it builds anything; so does ``train --tp 2``
    without ``--device`` (its (cards // 2, 2) mesh has no card)."""
    from deeplearning4j_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = ["--d-model", "32", "--n-layers", "1", "--n-heads", "4",
             "--seq-len", "32"]
    assert cli.main(["serve", "--demo", "--tp", "2", "--port", "0",
                     *model]) == 2
    assert "need 2 devices for a 'model' mesh, have 0" in (
        capsys.readouterr().err)
    assert cli.main(["train", "--model", "transformer", "--tp", "2",
                     "--steps", "1", *model]) == 2
    assert "need 2 devices for a (1, 2) mesh, have 0" in (
        capsys.readouterr().err)


def test_cli_serve_tp2_on_the_cpu_answers_tp1_tokens(tmp_path):
    """``serve --demo --device cpu --tp 2`` (both ranks on the CPU) comes
    up sharded, exports ``serve_tp_degree 2`` and answers the tokens of a
    ``--tp 1`` server on the same demo weights."""
    import os
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    base = ["serve", "--demo", "--device", "cpu", "--port", "0",
            "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
            "--seq-len", "32", "--slots", "2", "--temperature", "0",
            "--probe-cache", "off"]
    procs, addrs = [], []
    try:
        for tp in (1, 2):
            pf = tmp_path / f"tp{tp}.json"
            procs.append((pf, subprocess.Popen(
                [sys.executable, "-u", "-m", "deeplearning4j_tpu_torch",
                 *base, "--tp", str(tp), "--port-file", str(pf)],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for pf, proc in procs:
            t0 = time.monotonic()
            while not pf.exists():
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() - t0 < 120, "never listened"
                time.sleep(0.1)
            info = json.loads(pf.read_text())
            addrs.append((info["host"], int(info["port"])))
        outs = [_post(a, {"prompt": [5, 9, 2, 7, 1], "max_new": 6})
                for a in addrs]
        assert all(st == 200 for st, _ in outs), outs
        assert outs[0][1]["tokens"] == outs[1][1]["tokens"]
        conn = http.client.HTTPConnection(*addrs[1], timeout=10)
        conn.request("GET", "/metrics")
        assert "serve_tp_degree 2" in conn.getresponse().read().decode()
        conn.close()
    finally:
        for _, proc in procs:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
    assert "tensor parallel: serving sharded over 2 devices" in (
        procs[1][1].stdout.read())
