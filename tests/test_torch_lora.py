"""Batched LoRA in the port (``init_lora_bank``, the adapter rows through
prefill, the decode step and the serving engine) held against the
reference's (``tests/test_serving_tenancy.py`` :355-:405).

Bars:

- the bank: ``init_lora_bank`` draws the reference's bank for the same key
  (bits and uniforms bitwise, erfinv to within ``BANK_RTOL``);
- the math: with the reference's bank loaded by ``lora_bank_from_jax``,
  prefill and decode logits over mixed adapters match the reference's
  ``_decode_builder`` (its dense chunk decode: it routes LoRA around its
  decode kernel) within ``LOGIT_ATOL``, on slab and paged caches, f32, bf16
  and int8; the port's decode runs the decode kernel's plain version;
- within the port: adapter 0 is bitwise the bank-free model (the probe
  passes), a mixed batch's streams equal single-adapter engines' (greedy
  and sampled), crash replay keeps them, an adapter outside the bank is
  rejected and adapter != 0 bypasses the prefix cache.
"""

import dataclasses
import os
import re
import subprocess
import sys
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    AdmissionError,
    FaultInjector,
    Request,
    RequestStatus,
    ServingEngine,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

#: erfinv is the library's on each side: the factors agree to a few ulps
BANK_RTOL = 1e-5
#: logits vs the reference, by compute mode (f32 and the int8 cache: the
#: matmuls' summation order; bf16: bf16 activations rounded apart)
LOGIT_ATOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 5e-2}
#: the int8 cache through the decode kernel vs the reference's dense int8
#: decode: the kernel's int8 mode quantizes inside attention, and the
#: reference's own int8 kernel and dense decode differ by 0.018-0.020 here
#: without any bank
INT8_KERNEL_ATOL = 5e-2
#: greedy tokens across frameworks may differ only below this top-2 gap
NEAR_TIE = 1e-4

JCFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32,
)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
ADAPTERS = (1, 2, 3, 0)


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def jbank():
    return jt.init_lora_bank(jax.random.key(1), JCFG, n_adapters=4, rank=2)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


@pytest.fixture(scope="module")
def bank(jbank):
    return pt.lora_bank_from_jax(jax.tree.map(np.asarray, jbank), CFG,
                                 device="cpu")


def _engine(params, bank=None, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("n_slots", 4)
    return ServingEngine(CFG, params, device="cpu",
                         lora_bank=bank, retry_backoff_s=0.001,
                         max_backoff_s=0.004, **kw)


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.id: engine.pop_result(r.id) for r in reqs}


def _mixed_reqs(adapters=ADAPTERS, seed=6, max_new=6, cls=Request):
    """One request per adapter on ONE prompt: streams can only differ by
    their adapter rows."""
    prompt = np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (7,)).astype(np.int32)
    return [cls(prompt=prompt.copy(), max_new=max_new, adapter=a)
            for a in adapters]


# -- the bank ----------------------------------------------------------------

@pytest.mark.parametrize("seed,n,rank", [(0, 4, 4), (7, 3, 2)])
def test_init_lora_bank_matches_reference(seed, n, rank):
    want = jt.init_lora_bank(jax.random.key(seed), JCFG, n_adapters=n,
                             rank=rank)
    got = pt.init_lora_bank(seed, CFG, n, rank, device="cpu")
    for name in ("a_q", "b_q", "a_mlp", "b_mlp"):
        w = np.asarray(want[name])
        assert got[name].dtype == torch.float32
        assert tuple(got[name].shape) == w.shape
        np.testing.assert_allclose(got[name].numpy(), w, rtol=BANK_RTOL,
                                   atol=0)
        assert not got[name][:, 0].any()  # adapter 0: the zero adapter


def test_init_lora_bank_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="n_adapters"):
        pt.init_lora_bank(0, CFG, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        pt.init_lora_bank(0, CFG, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        pt.init_lora_bank(0, dataclasses.replace(CFG, n_experts=2), 2, 2,
                          device="cpu")
    with pytest.raises(ValueError, match="shape"):
        pt.lora_bank_from_jax(
            {k: np.zeros((2, 4, 8, 2), np.float32)
             for k in ("a_q", "b_q", "a_mlp", "b_mlp")}, CFG, device="cpu")


# -- the math against the reference ------------------------------------------

def _modes(mode):
    jc, tc = JCFG, CFG
    if mode == "bf16":
        jc = dataclasses.replace(jc, compute_dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, compute_dtype=torch.bfloat16)
    if mode == "int8":
        jc = dataclasses.replace(jc, decode_int8=True)
        tc = dataclasses.replace(tc, decode_int8=True)
    # the reference decodes LoRA through its dense chunk block only
    return dataclasses.replace(jc, decode_kernel=False), tc


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_lora_logits_match_reference(jparams, jbank, params, bank, mode,
                                     layout, kernel):
    """``kernel``: the port's decode through the decode kernel's plain
    version (the engine's path) or through its dense chunk block (the
    reference's LoRA path)."""
    jc, tc = _modes(mode)
    tc = dataclasses.replace(tc, decode_kernel=kernel)
    jfwd, jinit, jprefill, jcast = jt._decode_builder(jc)
    tfwd, tinit, tprefill, tcast = pt._decode_builder(tc)
    jp = dict(jcast(jparams), lora=jbank)
    tp_ = tcast(dict(params, lora=bank))
    assert tp_["lora"]["a_q"].dtype == tc.compute_dtype
    b, total = 4, 24
    prompt = np.random.default_rng(3).integers(0, 64, (b, 8)).astype(
        np.int32)
    ad = np.asarray(ADAPTERS, np.int32)
    jcache, jl = jax.jit(jprefill)(jp, jinit(b, total), jnp.asarray(prompt),
                                   adapter=jnp.asarray(ad))
    tcache, tl = tprefill(tp_, tinit(b, total, "cpu"),
                          torch.from_numpy(prompt).long(),
                          adapter=torch.from_numpy(ad))
    atol = LOGIT_ATOL[mode]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
    if layout == "paged":
        bs = 8
        tpad = pt._kv_planes(tcache)[0].shape[3]
        bps = tpad // bs
        tables = (np.random.default_rng(0).permutation(b * bps) + 1).reshape(
            b, bps).astype(np.int32)
        blocks = pt.kv_map(lambda t: torch.zeros(
            (t.shape[0], 2, b * bps + 1, bs, t.shape[4]), dtype=t.dtype),
            tcache)
        pt.paged_scatter(blocks, torch.from_numpy(tables), tcache)
        tcache = {"blocks": blocks, "tables": torch.from_numpy(tables)}
    if mode == "int8" and kernel:
        atol = INT8_KERNEL_ATOL
    jstep = jax.jit(jfwd)
    pos = np.array([8, 8, 8, 8], np.int32)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                           adapter=jnp.asarray(ad))
        tl, tcache = tfwd(tp_, tcache, torch.from_numpy(tok),
                          torch.from_numpy(pos), torch.from_numpy(ad))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    # the adapters really act: each adapter row's logits differ from row 3's
    # (adapter 0) on the same prompt shape
    assert not np.allclose(np.asarray(jl)[0], np.asarray(jl)[3])


def test_lora_engine_greedy_matches_reference_engine(jparams, jbank, params,
                                                     bank):
    """The reference engine (dense LoRA decode) and the port's (decode
    kernel) on the same weights and bank: greedy streams identical, or at
    the first divergence the reference's top-2 gap is a near-tie."""
    ja = _mixed_reqs(cls=JRequest)
    ta = _mixed_reqs()
    je = JEngine(JCFG, jparams, n_slots=4, temperature=0.0,
                 lora_bank=jbank, lora_parity=True)
    ref = _run(je, ja)
    got = _run(_engine(params, bank), ta)
    fwd = jax.jit(jt.transformer_apply(dataclasses.replace(
        JCFG, decode_kernel=False)))
    for a, b in zip(ja, ta):
        x, y = np.asarray(ref[a.id]), got[b.id]
        diff = np.nonzero(x != y)[0]
        if diff.size:
            # the reference's own logits there (through the adapter-free
            # forward: a divergence is checked only for adapter 0)
            assert a.adapter == 0, (a.adapter, x, y)
            lg = np.sort(np.asarray(fwd(jparams, jnp.asarray(
                x[:diff[0]])[None])[0][0, -1]))
            assert lg[-1] - lg[-2] < NEAR_TIE


# -- within the port ---------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_lora_adapter0_is_bitwise_base_model(params, bank, paged):
    eng = _engine(params, bank, paged=paged)
    assert eng.n_adapters == 4  # the probe passed; the bank is live
    assert eng._probe_lora_zero()
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(0, 64, int(rng.integers(3, 10))),
                    max_new=6) for _ in range(5)]
    with_bank = _run(eng, reqs)
    clones = [Request(prompt=r.prompt.copy(), max_new=r.max_new)
              for r in reqs]
    base = _run(_engine(params, paged=paged), clones)
    for r, c in zip(reqs, clones):
        np.testing.assert_array_equal(with_bank[r.id], base[c.id])


def test_lora_probe_failure_serves_without_the_bank(params, bank,
                                                    monkeypatch):
    monkeypatch.setattr(ServingEngine, "_probe_lora_zero", lambda self: False)
    eng = _engine(params, bank)
    assert eng.n_adapters == 0 and "lora" not in eng.params
    assert "serve_lora_adapters 0" in eng.metrics.render_prometheus()
    with pytest.raises(AdmissionError, match="outside the loaded bank"):
        eng.submit(Request(prompt=[1, 2], max_new=2, adapter=1))
    # lora_parity=True trusts the bank without the probe
    assert _engine(params, bank, lora_parity=True).n_adapters == 4
    assert _engine(params, bank, lora_parity=False).n_adapters == 0


@pytest.mark.parametrize("paged", [False, True])
def test_lora_mixed_batch_matches_single_adapter_engines_greedy(params,
                                                                bank, paged):
    reqs = _mixed_reqs()
    mixed = _run(_engine(params, bank, paged=paged, decode_horizon=2), reqs)
    streams = [tuple(mixed[r.id]) for r in reqs]
    assert len(set(streams)) == len(streams), "adapters failed to diverge"
    for r in reqs:
        solo_req = Request(prompt=r.prompt.copy(), max_new=r.max_new,
                           adapter=r.adapter)
        solo = _run(_engine(params, bank, paged=paged), [solo_req])
        np.testing.assert_array_equal(mixed[r.id], solo[solo_req.id])


def test_lora_mixed_batch_matches_single_adapter_engines_sampled(params,
                                                                 bank):
    """Slot keys are split in admission order and token i is drawn with
    fold_in(slot key, position): an engine fed the same submissions, each
    pinned to adapter i, reproduces the mixed batch's adapter-i stream."""
    reqs = _mixed_reqs(max_new=8)
    mixed = _run(_engine(params, bank, temperature=1.0, top_k=8), reqs)
    for idx, r in enumerate(reqs):
        pinned = [Request(prompt=q.prompt.copy(), max_new=q.max_new,
                          adapter=r.adapter) for q in reqs]
        solo = _run(_engine(params, bank, temperature=1.0, top_k=8), pinned)
        np.testing.assert_array_equal(mixed[r.id], solo[pinned[idx].id])


@pytest.mark.parametrize("chunked", [False, True])
def test_lora_crash_recovery_parity_sampled(params, bank, chunked):
    reqs = _mixed_reqs(max_new=8)
    clean = _run(_engine(params, bank, temperature=1.0, top_k=8), reqs)
    reqs2 = [Request(prompt=r.prompt.copy(), max_new=r.max_new,
                     adapter=r.adapter) for r in reqs]
    inj = FaultInjector().plan("step", at=2, kind="crash")
    eng = _engine(params, bank, temperature=1.0, top_k=8, faults=inj,
                  chunked_replay=chunked)
    faulted = _run(eng, reqs2)
    assert eng.metrics.n_restarts == 1
    assert eng.last_recover_mode == ("chunked" if chunked else "stepwise")
    for a, b in zip(reqs, reqs2):
        np.testing.assert_array_equal(clean[a.id], faulted[b.id])
        assert b.status is RequestStatus.FINISHED


def test_adapter_outside_bank_is_rejected(params, bank):
    eng = _engine(params, bank)
    with pytest.raises(AdmissionError, match="outside the loaded bank"):
        eng.submit(Request(prompt=[1, 2, 3], max_new=2, adapter=4))
    with pytest.raises(AdmissionError, match="adapter must be >= 0"):
        Request(prompt=[1], max_new=1, adapter=-1)
    with pytest.raises(AdmissionError, match="0 adapters"):
        _engine(params).submit(Request(prompt=[1], max_new=1, adapter=1))


def test_nonzero_adapter_bypasses_the_prefix_cache(params, bank):
    """Adapter-0 prompts read and feed the cache; adapter != 0 prompts do
    neither (their rows depend on the adapter), and their streams equal a
    cache-free engine's."""
    eng = _engine(params, bank, prefix_cache=True, n_slots=2)
    prompt = np.arange(12, dtype=np.int32) % 64
    base = [Request(prompt=prompt.copy(), max_new=4) for _ in range(2)]
    _run(eng, base[:1])
    _run(eng, base[1:])
    m = eng.metrics
    assert m.n_prefix_hits_full == 1 and m.n_prefix_inserts >= 1
    inserts, lookups = m.n_prefix_inserts, (
        m.n_prefix_hits_full + m.n_prefix_hits_partial + m.n_prefix_misses)
    lora = [Request(prompt=prompt.copy(), max_new=4, adapter=2)
            for _ in range(2)]
    got = _run(eng, lora)
    assert m.n_prefix_inserts == inserts
    assert (m.n_prefix_hits_full + m.n_prefix_hits_partial
            + m.n_prefix_misses) == lookups
    solo = Request(prompt=prompt.copy(), max_new=4, adapter=2)
    want = _run(_engine(params, bank), [solo])[solo.id]
    for r in lora:
        np.testing.assert_array_equal(got[r.id], want)


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_cli_serve_lora_and_tenants_on_cpu(tmp_path):
    """``serve --demo --tenants PATH --lora-adapters 3`` parses, builds,
    prints its banner lines and serves a tenant's default adapter."""
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps({"tenants": [
        {"id": "a", "api_key": "ka"},
        {"id": "b", "api_key": "kb", "default_adapter": 2}]}))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--demo",
         "--device", "cpu", "--port", "0", "--d-model", "32",
         "--n-layers", "1", "--n-heads", "2", "--seq-len", "32",
         "--slots", "2", "--temperature", "0", "--tenants", str(path),
         "--lora-adapters", "3", "--lora-rank", "2", "--lora-seed", "5"],
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
        text = "".join(lines)
        assert addr, "no address announced: " + text
        assert "tenancy: 2 tenants from" in text
        assert "batched LoRA: 3 adapters (rank 2" in text
        assert "DISABLED" not in text
        url = addr + "/v1/generate"
        body = {"prompt": [1, 2, 3], "max_new": 4}
        code_b, out_b = _post(url, body, {"X-API-Key": "kb"})
        code_2, out_2 = _post(url, dict(body, adapter=2),
                              {"X-API-Key": "ka"})
        code_0, out_0 = _post(url, body, {"X-API-Key": "ka"})
        assert code_b == code_2 == code_0 == 200
        assert out_b["tokens"] == out_2["tokens"]  # b's default adapter
        assert _post(url, dict(body, adapter=3),
                     {"X-API-Key": "ka"})[0] == 400
        assert _post(url, body, {"X-API-Key": "nope"})[0] == 401
        assert _post(url, body)[0] == 401  # no anonymous tenant
        with urllib.request.urlopen(addr + "/metrics", timeout=30) as r:
            prom = r.read().decode()
        assert "serve_lora_adapters 3" in prom
        assert "serve_tenants 2" in prom
    finally:
        proc.terminate()
        proc.wait(timeout=30)
