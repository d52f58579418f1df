"""The port's serving engine and HTTP server.

Two bars, as ``tests/test_serving.py`` sets them for the reference:

- within the port, greedy engine streams are byte-identical to the port's
  own ``transformer_generate`` on each request alone, for decode horizons
  K in {1, 4}, prompts below and above the 128-token prefill bucket (the
  chunked path) and EOS retirement;
- across frameworks, the same prompts and weights give greedy streams equal
  to the reference ``ServingEngine``'s at f32, except where a near-tie in
  the logits flips a token.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    AdmissionError,
    Backpressure,
    Request,
    RequestScheduler,
    ServingEngine,
    ServingServer,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this (f32 logits agree to ~1e-5 here)
NEAR_TIE = 1e-4

JCFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=192,
    use_flash=True,
)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
# prompt lengths: below the 8 bucket, mid buckets, and past the largest
# (128) bucket so admission takes the chunked path
LENGTHS = [(3, 6), (9, 8), (17, 5), (40, 7), (130, 6), (150, 9)]


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32), m)
            for n, m in LENGTHS]


@pytest.fixture(scope="module")
def generated(params):
    """Each prompt decoded alone by the port's generate: tokens and the
    per-step sampling logits."""
    gen = pt.transformer_generate(CFG)
    out = []
    for prompt, max_new in _prompts():
        toks, logits = gen(params, torch.from_numpy(prompt[None]).long(),
                           max_new, temperature=0.0, return_logits=True)
        out.append((toks[0].numpy(), logits[:, 0].numpy()))
    return out


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return engine.run()


@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_matches_port_generate(params, generated, horizon):
    engine = ServingEngine(CFG, params, n_slots=3, decode_horizon=horizon,
                           device="cpu")
    reqs = [Request(prompt=p, max_new=m) for p, m in _prompts()]
    results = _run(engine, reqs)
    for r, (ref, _) in zip(reqs, generated):
        np.testing.assert_array_equal(results[r.id], ref)
    s = engine.metrics.summary()
    assert s["n_finished"] == len(reqs)
    assert s["occupancy_mean"] > 1.0, "requests never interleaved"
    assert s["decode_horizon"] == horizon
    # two prompts took the chunked path: ceil(130/128) + ceil(150/128)
    # chunk dispatches, plus one bucketed prefill per short prompt
    assert engine.prefill_dispatches == 4 + 4


def test_eos_retires_slot_early(params, generated):
    prompt, _ = _prompts()[1]
    first = int(generated[1][0][len(prompt)])
    engine = ServingEngine(CFG, params, n_slots=2, decode_horizon=4,
                           device="cpu")
    req = Request(prompt=prompt, max_new=8, eos_token=first)
    out = _run(engine, [req])[req.id]
    assert len(out) == len(prompt) + 1 and out[-1] == first
    assert engine.pool.n_active == 0 and engine.idle


def test_engine_matches_reference_engine(jparams, params, generated):
    """Greedy streams of one reference ServingEngine and the port's engine
    on the same prompts and weights (f32)."""
    jengine = JEngine(JCFG, jparams, n_slots=3, temperature=0.0,
                      decode_horizon=4)
    jreqs = [JRequest(prompt=p, max_new=m) for p, m in _prompts()]
    jres = _run(jengine, jreqs)
    engine = ServingEngine(CFG, params, n_slots=3, decode_horizon=4,
                           device="cpu")
    reqs = [Request(prompt=p, max_new=m) for p, m in _prompts()]
    res = _run(engine, reqs)
    for jr, r, (_, logits) in zip(jreqs, reqs, generated):
        a, b = np.asarray(jres[jr.id]), res[r.id]
        assert a.shape == b.shape
        diff = np.nonzero(a != b)[0]
        if diff.size:
            i = int(diff[0]) - len(r.prompt)
            top2 = np.sort(logits[i])[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (r.id, i, top2)


def test_sampled_stream_is_independent_of_horizon(params):
    """Sampled draws are a pure function of (slot seed, position): the
    same admission order gives the same streams for any K."""
    outs = []
    for horizon in (1, 4):
        engine = ServingEngine(CFG, params, n_slots=2, temperature=1.0,
                               top_k=8, decode_horizon=horizon, rng_seed=3,
                               device="cpu")
        reqs = [Request(prompt=p, max_new=m) for p, m in _prompts()[:4]]
        res = _run(engine, reqs)
        outs.append([res[r.id] for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_scheduler_admission_control():
    sched = RequestScheduler(max_queue_depth=2, max_total_tokens=32)
    mk = lambda: Request(prompt=np.arange(4), max_new=4)  # noqa: E731
    sched.submit(mk())
    r2 = mk()
    sched.submit(r2)
    with pytest.raises(Backpressure):
        sched.submit(mk())
    with pytest.raises(AdmissionError):
        sched.submit(Request(prompt=np.zeros(30), max_new=8))
    with pytest.raises(AdmissionError):
        Request(prompt=[1], max_new=0)
    assert sched.cancel(r2.id) and r2.cancelled
    assert len(sched) == 2


def test_cancel_retires_running_request(params):
    engine = ServingEngine(CFG, params, n_slots=1, decode_horizon=1,
                           device="cpu")
    req = Request(prompt=np.arange(5), max_new=20)
    engine.submit(req)
    engine.step()
    engine.step()
    assert engine.cancel(req.id)
    engine.run()
    assert req.status.value == "cancelled"
    assert 0 < len(engine.results[req.id]) - 5 < 20


def _post(url, body):
    data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_round_trip(params, generated):
    engine = ServingEngine(CFG, params, n_slots=2, decode_horizon=4,
                           device="cpu")
    server = ServingServer(engine, port=0).start()
    try:
        host, port = server.address
        base = f"http://{host}:{port}"
        prompts = _prompts()[:3]
        results = [None] * len(prompts)

        def call(i):
            p, m = prompts[i]
            results[i] = _post(base + "/v1/generate",
                               {"prompt": p.tolist(), "max_new": m})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for (code, body), (ref, _) in zip(results, generated):
            assert code == 200
            assert body["tokens"] == ref.tolist()
            assert set(body["timing"]) == {"ttft_s", "decode_s"}
        code, body = _post(base + "/v1/generate",
                           {"prompt": "!#", "max_new": 3})
        assert code == 200 and len(body["tokens"]) == 5 and "text" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/generate", {"prompt": [1] * 190, "max_new": 9})
        assert e.value.code == 400
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["ok"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert 'serve_requests_total{outcome="finished"} 4' in text
        assert "serve_ttft_seconds_bucket" in text
    finally:
        server.stop(drain_s=5.0)
    assert engine.idle


def test_cli_serve_demo_on_cpu():
    """``python -m deeplearning4j_tpu_torch serve --demo --device cpu``
    answers a request and drains on SIGINT."""
    import os
    import re
    import signal
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--demo",
         "--device", "cpu", "--port", "0", "--d-model", "32",
         "--n-layers", "1", "--n-heads", "2", "--seq-len", "32",
         "--slots", "2", "--temperature", "0", "--flash"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        addr = None
        for line in proc.stdout:
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                addr = m.group(1)
                break
        assert addr, "no address announced"
        code, body = _post(addr + "/v1/generate",
                           {"prompt": "abc", "max_new": 4})
        assert code == 200 and len(body["tokens"]) == 7
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    assert proc.returncode == 0


def test_cli_serve_timed_run_on_cpu(tmp_path, monkeypatch):
    """``serve --run-seconds N`` publishes its port file, answers a request,
    hands ``--max-restarts`` and ``--hang-threshold`` to the server
    (``/healthz`` reports the threshold), then drains and returns 0 after N
    seconds with no signal."""
    import time

    from deeplearning4j_tpu_torch import cli, serving

    run_s = 6.0
    servers = []

    class Recorded(ServingServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(serving, "ServingServer", Recorded)
    port_file = tmp_path / "port.json"
    out = {}

    def run():
        out["rc"] = cli.main([
            "serve", "--demo", "--device", "cpu", "--port", "0",
            "--port-file", str(port_file), "--run-seconds", str(run_s),
            "--drain-s", "2", "--max-restarts", "3", "--hang-threshold",
            "7", "--d-model", "32", "--n-layers", "1", "--n-heads", "2",
            "--seq-len", "32", "--slots", "2", "--temperature", "0",
            "--probe-cache", "off"])
        out["end"] = time.monotonic()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while not port_file.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert port_file.exists(), "serve never wrote its port file"
    started = time.monotonic()
    addr = json.loads(port_file.read_text())
    base = f"http://{addr['host']}:{addr['port']}"
    code, body = _post(base + "/v1/generate", {"prompt": "abc", "max_new": 4})
    assert code == 200 and len(body["tokens"]) == 7
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert r.status == 200 and health["hang_threshold_s"] == 7.0
    t.join(timeout=120)
    assert not t.is_alive(), "serve did not stop on its own"
    assert out["rc"] == 0
    assert out["end"] - started >= run_s - 1.0
    assert len(servers) == 1 and servers[0].max_restarts == 3
    assert servers[0].hang_threshold_s == 7.0


@pytest.mark.parametrize("decode_kernel", [True, False])
def test_slot_filling_the_whole_cache(params, decode_kernel):
    """A request with prompt + max_new == Tpad finishes while another
    slot keeps decoding: its dead decode writes stay inside the cache."""
    import dataclasses

    cfg = dataclasses.replace(CFG, decode_kernel=decode_kernel)
    gen = pt.transformer_generate(cfg)
    reqs = [Request(prompt=np.arange(16) % 64, max_new=8),
            Request(prompt=np.arange(3), max_new=20)]
    engine = ServingEngine(cfg, params, n_slots=2, max_total=24,
                           decode_horizon=1, device="cpu")
    assert engine.pool.tpad == 24
    res = _run(engine, reqs)
    for r in reqs:
        ref = gen(params, torch.from_numpy(r.prompt[None]).long(), r.max_new,
                  temperature=0.0)
        np.testing.assert_array_equal(res[r.id], ref[0].numpy())


def test_empty_prompt_decodes_from_uniform_logits(params):
    gen = pt.transformer_generate(CFG)
    ref = gen(params, torch.zeros((1, 0), dtype=torch.long), 5,
              temperature=0.0)[0].numpy()
    engine = ServingEngine(CFG, params, n_slots=1, device="cpu")
    req = Request(prompt=[], max_new=5)
    np.testing.assert_array_equal(_run(engine, [req])[req.id], ref)
