"""Streaming responses and the rest of the single-engine front end in the
port: ``Request.stream`` and the engine's puts, the server's SSE relay,
``/readyz``, ``/drain`` / ``/undrain`` and ``/metrics.json``, held against
the reference's own bars (``tests/test_serving_tenancy.py`` :450, :472 and
``tests/test_serving_faults.py`` :491).

Bars:

- the streamed tokens, concatenated, are the non-streamed result's tail
  byte for byte: greedy, sampled, with a stop string (the matcher's
  hold-back released before the end) and under a grammar; over SSE and on
  the engine's queue; across a crash recovery, with no token repeated;
- the end-of-stream sentinel arrives on every terminal path (finished,
  expired, cancelled, failed, ``fail_all``, unadmitted, a dropped deferred
  admission), after the terminal status is set;
- a client that disconnects mid-stream cancels its request and frees its
  slot;
- ``/metrics.json`` has the reference server's keys on the same config.
"""

import json
import queue
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import RequestScheduler as JScheduler
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving import ServingServer as JServer
from deeplearning4j_tpu.serving import TenantConfig as JTenantConfig
from deeplearning4j_tpu.serving import TenantRegistry as JTenantRegistry
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    FaultInjector,
    Request,
    RequestScheduler,
    RequestStatus,
    ServingEngine,
    ServingServer,
    TenantConfig,
    TenantRegistry,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

JCFG = jt.TransformerConfig(
    vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64,
)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
EOS = 127


@pytest.fixture(scope="module")
def params():
    return pt.init_params(CFG, seed=0, device="cpu")


def _engine(params, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("n_slots", 2)
    kw.setdefault("decode_horizon", 2)
    return ServingEngine(CFG, params, device="cpu", retry_backoff_s=0.001,
                         max_backoff_s=0.004, **kw)


def _drain(q, timeout=30.0):
    toks, deadline = [], time.monotonic() + timeout
    while True:
        tok = q.get(timeout=max(deadline - time.monotonic(), 0.01))
        if tok is None:
            return toks
        toks.append(tok)


def _tail(engine, req):
    return engine.pop_result(req.id)[len(req.prompt):].tolist()


def _prompt(n=6, seed=0):
    return np.random.default_rng(seed).integers(0, 120, n).astype(np.int32)


def _greedy_tail(params, prompt, max_new):
    eng = _engine(params)
    r = Request(prompt=prompt.copy(), max_new=max_new)
    eng.submit(r)
    eng.run()
    return _tail(eng, r)


def _case(params, name):
    """(engine kwargs, request kwargs) of one streaming case."""
    if name == "greedy":
        return {}, {}
    if name == "sampled":
        return dict(temperature=0.9, top_k=20), {}
    if name == "stop":
        ref = _greedy_tail(params, _prompt(), 10)
        return dict(sampling_surface=True), dict(stop=[ref[4:6]])
    return dict(sampling_surface=True), dict(
        eos_token=EOS, response_format={"type": "regex",
                                        "regex": "(yes|no|maybe)!?"})


# -- the engine's puts -------------------------------------------------------

@pytest.mark.parametrize("name", ["greedy", "sampled", "stop", "grammar"])
def test_stream_queue_concatenates_to_the_result(params, name):
    ekw, rkw = _case(params, name)
    eng = _engine(params, **ekw)
    reqs = [Request(prompt=_prompt(seed=i), max_new=10,
                    stream=queue.Queue(), **rkw) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.status is RequestStatus.FINISHED
        assert _drain(r.stream, 1.0) == _tail(eng, r)
    if name == "stop":
        # the stop match really fired: the stream ends before it
        assert eng.metrics._c_stop_hits.value() >= 1


def test_streaming_sets_status_before_the_sentinel(params):
    """The reference's ``test_streaming_tokens_concatenate_to_result``: a
    streamed request on an engine running in a thread; the status is
    visible when the sentinel arrives."""
    out = _greedy_tail(params, _prompt(), 6)
    eng = _engine(params)
    streamed = Request(prompt=_prompt(), max_new=6, stream=queue.Queue())
    eng.submit(streamed)
    t = threading.Thread(target=eng.run)
    t.start()
    toks = _drain(streamed.stream)
    assert streamed.status is RequestStatus.FINISHED  # set pre-sentinel
    t.join(timeout=30)
    assert toks == out


def test_streaming_mid_cancel_drains_cleanly(params):
    eng = _engine(params, decode_horizon=1,
                  faults=FaultInjector(delay_s=0.01))
    victim = Request(prompt=np.arange(5, dtype=np.int32), max_new=40,
                     stream=queue.Queue())
    bystander = Request(prompt=_prompt(), max_new=5)
    eng.submit(victim)
    eng.submit(bystander)
    t = threading.Thread(target=eng.run)
    t.start()
    got = [victim.stream.get(timeout=30) for _ in range(2)]
    assert all(g is not None for g in got)
    assert eng.cancel(victim.id)
    rest = _drain(victim.stream)
    assert victim.status is RequestStatus.CANCELLED
    assert len(got) + len(rest) < 40
    t.join(timeout=30)
    assert bystander.status is RequestStatus.FINISHED


def _sentinel_after(req, status):
    """The queue holds tokens, then the sentinel, and the status is
    terminal."""
    toks = _drain(req.stream, 5.0)
    assert req.status is status, (req.status, status)
    assert req.stream.empty()
    return toks


def test_sentinel_on_expired_and_cancelled_requests(params):
    eng = _engine(params, n_slots=1)
    running = Request(prompt=_prompt(), max_new=30, stream=queue.Queue())
    queued = Request(prompt=_prompt(seed=1), max_new=4, stream=queue.Queue())
    expired = Request(prompt=_prompt(seed=2), max_new=4, deadline_s=0.0,
                      stream=queue.Queue())
    for r in (running, queued, expired):
        eng.submit(r)
    eng.step()
    eng.step()
    eng.cancel(queued.id)  # cancelled while queued: never admitted
    eng.cancel(running.id)  # cancelled while decoding
    eng.run()
    assert len(_sentinel_after(running, RequestStatus.CANCELLED)) < 30
    assert _sentinel_after(queued, RequestStatus.CANCELLED) == []
    assert _sentinel_after(expired, RequestStatus.EXPIRED) == []


def test_sentinel_on_failed_requests(params):
    """A permanent prefill fault fails a request before admission; a step
    fault naming a request fails it mid-decode."""
    inj = FaultInjector()
    eng = _engine(params, faults=inj)
    pre = Request(prompt=_prompt(), max_new=4, stream=queue.Queue())
    mid = Request(prompt=_prompt(seed=1), max_new=20, stream=queue.Queue())
    ok = Request(prompt=_prompt(seed=2), max_new=4, stream=queue.Queue())
    inj.plan("prefill", at=0, kind="permanent", req_id=pre.id)
    inj.plan("step", at=2, kind="permanent", req_id=mid.id)
    for r in (pre, mid, ok):
        eng.submit(r)
    eng.run()
    assert _sentinel_after(pre, RequestStatus.FAILED) == []
    assert len(_sentinel_after(mid, RequestStatus.FAILED)) < 20
    assert _sentinel_after(ok, RequestStatus.FINISHED) == _tail(eng, ok)


def test_sentinel_on_fail_all_and_dropped_deferred_admissions(params):
    """``fail_all`` ends every live, deferred and queued stream; a deferred
    (piggyback) admission cancelled before its seating ends unadmitted."""
    eng = _engine(params, n_slots=3, piggyback=True, prefill_max_bucket=8,
                  prefill_budget=8)
    live = Request(prompt=_prompt(), max_new=30, stream=queue.Queue())
    deferred = Request(prompt=_prompt(40, seed=3), max_new=4,
                       stream=queue.Queue())
    dropped = Request(prompt=_prompt(40, seed=4), max_new=4,
                      stream=queue.Queue())
    queued = Request(prompt=_prompt(seed=5), max_new=4, stream=queue.Queue())
    eng.submit(live)
    eng.step()
    eng.step()
    eng.submit(deferred)
    eng.submit(dropped)
    eng.step()
    assert len(eng._pending) == 2
    eng.cancel(dropped.id)
    eng.step()  # the sweep drops the cancelled deferred admission
    assert _sentinel_after(dropped, RequestStatus.CANCELLED) == []
    eng.submit(queued)
    eng.fail_all("test")
    for r in (live, deferred, queued):
        _sentinel_after(r, RequestStatus.FAILED)


@pytest.mark.parametrize("name", ["sampled", "stop"])
def test_recover_streams_no_token_twice(params, name):
    """A crash mid-generation: replay rebuilds the slots from their host
    records and the stream goes on where it stopped (the tokens of the
    dropped, unread horizon stream once, when the replayed run makes
    them)."""
    ekw, rkw = _case(params, name)
    clean = _engine(params, **ekw)
    reqs = [Request(prompt=_prompt(seed=i), max_new=12, **rkw)
            for i in range(2)]
    for r in reqs:
        clean.submit(r)
    clean.run()
    want = [_tail(clean, r) for r in reqs]
    inj = FaultInjector().plan("step", at=3, kind="crash")
    eng = _engine(params, faults=inj, **ekw)
    sreqs = [Request(prompt=_prompt(seed=i), max_new=12,
                     stream=queue.Queue(), **rkw) for i in range(2)]
    for r in sreqs:
        eng.submit(r)
    eng.run()
    assert eng.metrics.n_restarts == 1
    for r, w in zip(sreqs, want):
        assert _drain(r.stream, 1.0) == w == _tail(eng, r)


# -- the server --------------------------------------------------------------

def _post(base, body, path="/v1/generate", timeout=60):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse(base, body):
    """The SSE frames of a streamed request."""
    req = urllib.request.Request(
        base + "/v1/generate",
        data=json.dumps(dict(body, stream=True)).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        text = r.read().decode()
    return [json.loads(chunk[len("data: "):])
            for chunk in text.split("\n\n") if chunk.startswith("data: ")]


@pytest.mark.parametrize("name", ["greedy", "sampled", "stop", "grammar"])
def test_sse_concatenation_equals_the_non_stream_tail(params, name):
    """The same requests, in the same order, to two engines: one answered
    streamed, one not. The SSE tokens are the tail, and the final frame
    carries the status and the count."""
    ekw, rkw = _case(params, name)
    body = dict(max_new=10, **rkw)
    if "response_format" in rkw:
        body["eos_token"] = EOS
    srvs = [ServingServer(_engine(params, **ekw), port=0).start()
            for _ in range(2)]
    try:
        bases = ["http://%s:%d" % s.address for s in srvs]
        for i in range(3):
            b = dict(body, prompt=_prompt(seed=i).tolist())
            frames = _sse(bases[0], b)
            code, out = _post(bases[1], b)
            assert code == 200
            toks = [f["token"] for f in frames if "token" in f]
            assert toks == out["tokens"][len(b["prompt"]):]
            final = frames[-1]
            assert final["done"] and final["status"] == "finished"
            assert final["n_tokens"] == len(toks)
        # a streamed request's result is not kept after the stream
        assert not srvs[0].engine.results
    finally:
        for s in srvs:
            s.stop()


def test_client_disconnect_cancels_and_frees_the_slot(params):
    eng = _engine(params, n_slots=1, decode_horizon=1,
                  faults=FaultInjector(delay_s=0.02))
    srv = ServingServer(eng, port=0).start()
    host, port = srv.address
    try:
        body = json.dumps({"prompt": [1, 2, 3], "max_new": 55,
                           "stream": True}).encode()
        sock = socket.create_connection((host, port), timeout=30)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: " + str(len(body)).encode()
                     + b"\r\n\r\n" + body)
        buf = b""
        while buf.count(b"data: ") < 3:
            buf += sock.recv(4096)
        sock.close()
        deadline = time.monotonic() + 20
        while ((eng.pool.n_active or eng.metrics.n_cancelled == 0)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert eng.metrics.n_cancelled == 1 and eng.pool.n_active == 0
        assert eng.metrics.n_finished == 0
        # the slot serves the next caller
        code, out = _post("http://%s:%d" % (host, port),
                          {"prompt": [1, 2], "max_new": 3})
        assert code == 200 and len(out["tokens"]) == 5
    finally:
        srv.stop()


def test_stream_timeout_cancels_the_request(params):
    eng = _engine(params, n_slots=1, decode_horizon=1,
                  faults=FaultInjector(delay_s=0.05))
    srv = ServingServer(eng, port=0, request_timeout_s=0.3).start()
    base = "http://%s:%d" % srv.address
    try:
        frames = _sse(base, {"prompt": [1, 2, 3], "max_new": 55})
        assert frames[-1] == {"error": "generation timed out", "done": True}
        deadline = time.monotonic() + 20
        while eng.pool.n_active and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.pool.n_active == 0 and eng.metrics.n_cancelled == 1
    finally:
        srv.stop()


def test_readyz_drain_and_undrain(params):
    """``/drain`` turns ``/readyz`` and new submits to 503 while the
    in-flight request finishes; ``/undrain`` restores both."""
    eng = _engine(params, decode_horizon=1, faults=FaultInjector(
        delay_s=0.01))
    srv = ServingServer(eng, port=0).start()
    base = "http://%s:%d" % srv.address
    try:
        code, body = _get(base, "/readyz")
        assert code == 200 and body["ready"] is True
        out = {}
        t = threading.Thread(target=lambda: out.update(
            r=_post(base, {"prompt": [1, 5, 9], "max_new": 30})))
        t.start()
        deadline = time.monotonic() + 10
        while eng.pool.n_active == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        code, body = _post(base, {}, path="/drain")
        assert code == 200 and body["draining"] is True
        assert body["in_flight"] == 1
        code, body = _get(base, "/readyz")
        assert code == 503 and body["ready"] is False and body["draining"]
        assert _get(base, "/healthz")[0] == 200  # alive, only not ready
        code, body = _post(base, {"prompt": [2, 3], "max_new": 2})
        assert code == 503 and body["error"] == "draining"
        t.join(timeout=60)
        code, body = out["r"]
        assert code == 200 and len(body["tokens"]) == 33  # drained, whole
        assert _post(base, {}, path="/drain")[0] == 200  # idempotent
        code, body = _post(base, {}, path="/undrain")
        assert code == 200 and body["draining"] is False
        assert _get(base, "/readyz")[0] == 200
        assert _post(base, {"prompt": [2, 3], "max_new": 2})[0] == 200
    finally:
        srv.stop()


def test_server_stop_drains_inflight_and_503s_new(params):
    """The reference's ``test_server_drain_finishes_inflight_and_503s_new``
    (``tests/test_serving_faults.py`` :491): ``stop(drain_s)`` lets the
    in-flight request finish and answers new ones 503."""
    eng = _engine(params, decode_horizon=1, faults=FaultInjector(
        delay_s=0.01))
    srv = ServingServer(eng, port=0).start()
    base = "http://%s:%d" % srv.address
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(
            r=_post(base, {"prompt": [1, 5, 9], "max_new": 12})))
        t.start()
        deadline = time.monotonic() + 10
        while eng.pool.n_active == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.pool.n_active == 1
        assert _get(base, "/readyz")[0] == 200
        stopper = threading.Thread(target=lambda: srv.stop(drain_s=30))
        stopper.start()
        deadline = time.monotonic() + 10
        while not srv._draining.is_set() and time.monotonic() < deadline:
            time.sleep(0.002)
        status, body = _post(base, {"prompt": [2, 3], "max_new": 2})
        assert status == 503 and body["error"] == "draining"
        assert _get(base, "/readyz")[0] == 503
        t.join(timeout=30)
        stopper.join(timeout=30)
        status, body = out["r"]
        assert status == 200 and len(body["tokens"]) == 15
    finally:
        srv.stop()


def _keyset(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("tenants", "bucket_levels"):
            out |= _keyset(v, prefix + k + ".")
    return out


def test_metrics_json_keys_equal_the_reference_servers():
    """The same configuration (prefix cache, two tenants, one with a
    quota) and the same traffic on the reference's server and the port's:
    ``/metrics.json`` has the same keys, top level, nested blocks and
    per-tenant entries (the program-family attribution's families among
    them: both engines attribute, as they do by default), and the same
    prefix-cache stats and rejections."""
    jparams = jt.init_transformer(jax.random.key(0), JCFG)
    tparams = pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                 device="cpu")

    def tenants(cfg_cls, reg_cls):
        return reg_cls([cfg_cls("a", api_key="ka", slo_p99_tpot_s=0.5),
                        cfg_cls("q", api_key="kq", rate=1.0, burst=20.0)])

    jt_reg = tenants(JTenantConfig, JTenantRegistry)
    tt_reg = tenants(TenantConfig, TenantRegistry)
    je = JEngine(JCFG, jparams, n_slots=2, temperature=0.0,
                 prefix_cache=True, tenancy=jt_reg,
                 scheduler=JScheduler(tenancy=jt_reg))
    te = ServingEngine(CFG, tparams, n_slots=2, temperature=0.0,
                       prefix_cache=True, device="cpu", tenancy=tt_reg,
                       scheduler=RequestScheduler(tenancy=tt_reg))
    # the reference's prefix probe declines on some CPUs (two XLA programs
    # that round apart): give it the port's verdict, so both look prompts
    # up and both summaries carry the lookup keys
    assert te._prefix_reuse_ok()
    je._prefix_ok_memo = True
    payloads = []
    for srv in (JServer(je, port=0), ServingServer(te, port=0)):
        srv.start()
        base = "http://%s:%d" % srv.address
        try:
            for key in ("ka", "ka", "kq", "kq"):
                req = urllib.request.Request(
                    base + "/v1/generate", method="POST",
                    headers={"X-API-Key": key},
                    data=json.dumps({"prompt": list(range(1, 12)),
                                     "max_new": 6}).encode())
                try:
                    urllib.request.urlopen(req, timeout=60).read()
                except urllib.error.HTTPError as e:
                    assert e.code == 429
            payloads.append(_get(base, "/metrics.json")[1])
        finally:
            srv.stop()
    want, got = payloads
    assert _keyset(got) == _keyset(want)
    assert got["tenants"].keys() == want["tenants"].keys()
    for tid in want["tenants"]:
        assert got["tenants"][tid].keys() == want["tenants"][tid].keys()
    assert got["rejections"] == want["rejections"] == {"quota": 1}
    assert got["prefix_cache"] == want["prefix_cache"]
