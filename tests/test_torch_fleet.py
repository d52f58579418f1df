"""The port's fleet over HTTP: the disaggregated controller (transfer leg,
stickiness, the merged trace, drains, the role balancer, the journal and
standby, the hedged transfer), the prefix-affinity router (affinity,
spread, retry, breakers, incompatibility, draining), live migration
through ``POST /migrate``, and the wire under a chaos proxy.

Every server listens on port 0 and every wait has a deadline. The engines
are the reference tests' size (vocab 64, d 32, 2 layers, 4 heads, max_len
32) with the reference's weights, at ``prefill_max_bucket=8``: the port's
hit grain is the largest bucket, so a wire segment needs at least 8
tokens and the controller's ``disagg_threshold`` is 12. Streams are held
byte for byte against the port's own monolithic engine or server, and a
migrated stream also against the reference's monolithic engine at the
near-tie rule (``test_torch_disagg.py``). The last case runs ``router``
as a subprocess over two ``serve --device cpu --demo`` subprocesses.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.obs import Tracer, merge_traces
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.serving import (
    ChaosProxy,
    FaultInjector,
    FleetController,
    ReplicaRouter,
    Request,
    RoleBalancer,
    ServingEngine,
    ServingServer,
)
from deeplearning4j_tpu_torch.serving.rpc import CLOSED, OPEN
from deeplearning4j_tpu_torch.utils.httpjson import QuietHandler, send_json
from tests.test_torch_disagg import _check_near_tie, _ref_stream

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JCFG = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_len=32)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
KW = dict(n_slots=2, temperature=0.0, decode_horizon=2, device="cpu",
          prefill_max_bucket=8, retry_backoff_s=0.001, max_backoff_s=0.004)


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _engine(params, **kw):
    return ServingEngine(CFG, params, **{**KW, **kw})


def _server(params, migrate_targets=(), **kw):
    return ServingServer(_engine(params, **kw), port=0,
                         migrate_targets=migrate_targets).start()


def _name(srv) -> str:
    return "%s:%d" % srv.address


def _post(addr, path, body, timeout=60):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read()), r.getheader("X-Served-By")
    finally:
        conn.close()


def _post_frame(addr, frame, idem="", timeout=60):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        h = {"Content-Type": "application/octet-stream"}
        if idem:
            h["X-Idempotency-Key"] = idem
        conn.request("POST", "/v1/kv_session", body=frame, headers=h)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _get(addr, path, timeout=10):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _prom(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    raise AssertionError(f"{series} not in the exposition")


def _prompt(seed, n=16):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 60, n)]


def _mono_tokens(params, prompt, max_new, **kw):
    eng = _engine(params, **kw)
    req = Request(prompt=np.asarray(prompt, np.int32), max_new=max_new,
                  done=threading.Event())
    eng.submit(req)
    for _ in range(1000):
        eng.step()
        if req.done.is_set():
            return [int(t) for t in eng.pop_result(req.id)]
    raise AssertionError("the monolithic run never finished")


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stop_all(*things):
    for t in things:
        try:
            t.stop()
        except Exception:
            pass


# -- the controller: transfer, stickiness, trace --------------------------------


def test_fleet_disagg_transfer_parity_stickiness_and_trace(params):
    """Controller over one prefill and one decode replica: a long prompt
    takes the transfer (prefill exports, pushes the frame replica to
    replica, decode full-hits with 0 prefill dispatches) and its tokens
    are a monolithic server's; a session follow-up sticks to the decode
    replica; the merged trace chains controller dispatch -> export prefill
    -> transfer -> kv_ingest under one trace id; ``/healthz`` carries the
    config hash."""
    tr_pf, tr_dc = Tracer(process_name="pf"), Tracer(process_name="dc")
    tr_ctl = Tracer(process_name="controller")
    pf = ServingServer(_engine(params, tracer=tr_pf), port=0).start()
    dc_eng = _engine(params, prefix_cache=True, tracer=tr_dc)
    dc = ServingServer(dc_eng, port=0).start()
    mono = _server(params)
    ctl = FleetController(
        [pf.address + ("prefill",), dc.address + ("decode",)],
        disagg_threshold=12, affinity_min_match=4, health_interval_s=0.1,
        tracer=tr_ctl).start()
    try:
        prompt = _prompt(13)
        status, body, served = _post(ctl.address, "/v1/generate",
                                     {"prompt": prompt, "max_new": 4,
                                      "session": "conv-1"})
        assert status == 200, body
        assert served == dc.name and dc_eng.prefill_dispatches == 0
        assert body["timing"]["ttft_s"] >= 0.0
        status, ref, _ = _post(mono.address, "/v1/generate",
                               {"prompt": prompt, "max_new": 4})
        assert status == 200 and body["tokens"] == ref["tokens"]
        # the follow-up: sticky, and short (below the threshold)
        status, _, served2 = _post(ctl.address, "/v1/generate",
                                   {"prompt": prompt[:8], "max_new": 2,
                                    "session": "conv-1"})
        assert status == 200 and served2 == dc.name
        prom = ctl.registry.render()
        assert _prom(prom, "fleet_disagg_total") == 1
        assert _prom(prom, "fleet_sticky_total") == 1
        assert _prom(prom, "fleet_transfer_fallback_total") == 0
        ptext = _get(pf.address, "/metrics")[1].decode()
        assert _prom(ptext, "serve_kv_exports_total") == 1
        assert _prom(ptext, 'serve_transfers_total{result="ok"}') == 1
        assert _prom(ptext, "serve_transfer_bytes_total") > 0
        dtext = _get(dc.address, "/metrics")[1].decode()
        assert _prom(dtext, 'serve_kv_ingests_total{result="stored"}') == 1
        health = json.loads(_get(dc.address, "/healthz")[1])
        assert health["config_hash"] == dc_eng.config_hash
    finally:
        _stop_all(ctl, pf, dc, mono)
    merged = merge_traces([tr_ctl.chrome_trace(), tr_pf.chrome_trace(),
                           tr_dc.chrome_trace()])
    evs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    by_span = {e["args"]["span_id"]: e for e in evs
               if "span_id" in e.get("args", {})}
    transfer = next(e for e in evs if e["name"] == "transfer")
    export = by_span[transfer["args"]["parent_span_id"]]
    assert export["name"] == "prefill" and export["args"]["prefix"] == "export"
    ingest = next(e for e in evs if e["name"] == "kv_ingest")
    assert ingest["args"]["parent_span_id"] == transfer["args"]["span_id"]
    tid = transfer["args"]["trace_id"]
    assert ingest["args"]["trace_id"] == tid == export["args"]["trace_id"]
    dispatch = by_span[export["args"]["parent_span_id"]]
    assert dispatch["name"] == "dispatch" and dispatch["args"]["leg"] == \
        "prefill"


def test_adapter_prompts_never_cross_the_kv_wire(params):
    """KV computed under a LoRA adapter never reaches a prefix cache over
    the wire (a frame names no adapter, and the decode replica seats it
    where adapter-0 prompts hit): ``/v1/prefill`` refuses an adapter other
    than 0 with 400, the controller sends such a request to the decode
    replica with no transfer leg, and a later adapter-0 generate of the
    same prompt takes the transfer, full-hits, and gets the monolithic
    engine's adapter-0 tokens."""
    bank = pt.init_lora_bank(threefry.key(0), CFG, 3, 2, device="cpu")
    pf_eng = _engine(params, lora_bank=bank)
    pf = ServingServer(pf_eng, port=0).start()
    dc_eng = _engine(params, prefix_cache=True, lora_bank=bank)
    dc = ServingServer(dc_eng, port=0).start()
    ctl = FleetController(
        [pf.address + ("prefill",), dc.address + ("decode",)],
        disagg_threshold=12, health_interval_s=0.1).start()
    try:
        prompt = _prompt(19)
        status, body, _ = _post(pf.address, "/v1/prefill",
                                {"prompt": prompt, "adapter": 1,
                                 "push_to": _name(dc)})
        assert status == 400 and "adapter 0 only" in body["error"], body
        status, a1, served = _post(ctl.address, "/v1/generate",
                                   {"prompt": prompt, "max_new": 6,
                                    "adapter": 1})
        assert status == 200 and served == _name(dc), a1
        assert pf_eng.prefill_dispatches == 0
        local = dc_eng.prefill_dispatches
        assert local >= 1
        status, a0, served = _post(ctl.address, "/v1/generate",
                                   {"prompt": prompt, "max_new": 6})
        assert status == 200 and served == _name(dc), a0
        assert dc_eng.prefill_dispatches == local  # the transfer's full hit
        mono = _mono_tokens(params, prompt, 6, lora_bank=bank)
        assert a0["tokens"] == mono
        # the adapter moves this stream: a leaked segment would show
        assert a1["tokens"] != mono
        assert _prom(ctl.registry.render(), "fleet_disagg_total") == 1
    finally:
        _stop_all(ctl, pf, dc)


def test_controller_floors_the_threshold_at_the_decode_hit_grain(params):
    """A prompt shorter than the decode replica's hit grain (``/healthz``
    ``hit_grain``: the largest prefill bucket, 8 here) takes no transfer
    whatever ``disagg_threshold`` says, since the decode replica would
    decline the segment and prefill again; a prompt of the grain or more
    does."""
    pf_eng = _engine(params)
    pf = ServingServer(pf_eng, port=0).start()
    dc_eng = _engine(params, prefix_cache=True)
    dc = ServingServer(dc_eng, port=0).start()
    ctl = FleetController(
        [pf.address + ("prefill",), dc.address + ("decode",)],
        disagg_threshold=2, health_interval_s=0.1).start()
    try:
        assert json.loads(_get(dc.address, "/healthz")[1])["hit_grain"] == 8
        t0 = time.monotonic()
        while ctl.members[1].hit_grain != 8:
            assert time.monotonic() - t0 < 10.0, "the grain was never polled"
            time.sleep(0.01)
        short = _prompt(23, 6)
        status, body, _ = _post(ctl.address, "/v1/generate",
                                {"prompt": short, "max_new": 3})
        assert status == 200 and body["tokens"] == _mono_tokens(
            params, short, 3)
        assert pf_eng.prefill_dispatches == 0
        long_ = _prompt(24, 12)
        status, body, _ = _post(ctl.address, "/v1/generate",
                                {"prompt": long_, "max_new": 3})
        assert status == 200 and body["tokens"] == _mono_tokens(
            params, long_, 3)
        ptext = _get(pf.address, "/metrics")[1].decode()
        assert _prom(ptext, "serve_kv_exports_total") == 1
        assert _prom(ctl.registry.render(), "fleet_disagg_total") == 1
    finally:
        _stop_all(ctl, pf, dc)


@pytest.mark.parametrize("fault", ["truncate", "corrupt"])
def test_chaotic_push_declines_and_falls_back(params, fault):
    """A KV push through a chaos proxy fails clean within its deadline.
    The proxy's ``corrupt`` flips bytes across the first chunk, the HTTP
    head included, so the receiver's HTTP layer refuses it (an HTTP error
    such as 501 for a mangled method, or a closed connection) and nothing
    is seated; its ``truncate`` cuts the
    answer mid-frame, leaving the sender with ``pushed: false`` (the
    receiver may have seated the frame). A frame cut in half, or with its
    header bytes flipped, reaches the wire checks and is a 400. The
    controller's generate then falls back to local prefill, or full-hits
    what was seated, with the monolithic tokens either way."""
    pf = _server(params)
    dc_eng = _engine(params, prefix_cache=True)
    dc = ServingServer(dc_eng, port=0).start()
    proxy = ChaosProxy(dc.address, seed=3)
    try:
        prompt = _prompt(17)
        proxy.plan(fault, at=proxy.n_connections)
        t0 = time.monotonic()
        status, body, _ = _post(pf.address, "/v1/prefill",
                                {"prompt": prompt, "push_to":
                                 proxy.address}, timeout=30)
        assert time.monotonic() - t0 < 25.0
        assert status == 200 and body["pushed"] is False, body
        assert proxy.counts[fault] == 1
        if fault == "corrupt":
            # an HTTP error or a closed connection, never a seat
            assert body["ingest"]["error"], body
            assert dc_eng.metrics.n_kv_ingests_stored == 0
        frame = _get_frame(pf, prompt)
        mangled = bytearray(frame)
        for i in range(10, 26):
            mangled[i] ^= 0xFF
        for bad in (frame[:len(frame) // 2], bytes(mangled)):
            conn = http.client.HTTPConnection(*dc.address, timeout=30)
            try:
                conn.request("POST", "/v1/kv_segment", body=bad)
                assert conn.getresponse().status == 400
            finally:
                conn.close()
        ctl = FleetController(
            [pf.address + ("prefill",), ("127.0.0.1", proxy.port, "decode")],
            disagg_threshold=12, health_interval_s=0.1).start()
        try:
            proxy.plan(fault, at=proxy.n_connections + 1)
            status, out, _ = _post(ctl.address, "/v1/generate",
                                   {"prompt": prompt, "max_new": 4},
                                   timeout=60)
        finally:
            ctl.stop()
        if status == 200:
            assert out["tokens"] == _mono_tokens(params, prompt, 4)
        else:  # the chaos landed on the generate leg itself: bounded
            assert status >= 500
    finally:
        _stop_all(proxy, pf, dc)


def _get_frame(srv, prompt) -> bytes:
    """The frame a replica's engine exports for ``prompt``."""
    from deeplearning4j_tpu_torch.serving import KVExportRequest
    from tests.test_torch_disagg import _frame

    req = KVExportRequest(prompt=np.asarray(prompt, np.int32),
                          done=threading.Event())
    srv.engine.submit(req)
    assert req.done.wait(30) and req.result is not None
    return _frame(req.result)


def test_drain_undrain_rolls_through_a_two_replica_fleet(params):
    """``POST /fleet/drain`` flips the replica's /readyz and the
    controller routes around it; ``/fleet/undrain`` restores it."""
    servers = [_server(params) for _ in range(2)]
    ctl = FleetController([s.address for s in servers],
                          health_interval_s=10.0,
                          rebalance_enabled=False).start()
    try:
        victim, survivor = servers
        status, body, _ = _post(ctl.address, "/fleet/drain",
                                {"replica": victim.name})
        assert status == 200 and body["draining"] is True
        assert body["replica_response"]["in_flight"] == 0
        assert _get(victim.address, "/readyz")[0] == 503
        assert _get(survivor.address, "/readyz")[0] == 200
        for i in range(3):
            status, _, served = _post(ctl.address, "/v1/generate",
                                      {"prompt": [3, 5, 7, 11 + i],
                                       "max_new": 2})
            assert status == 200 and served == survivor.name
        status, body, _ = _post(ctl.address, "/fleet/undrain",
                                {"replica": victim.name})
        assert status == 200 and body["draining"] is False
        assert _get(victim.address, "/readyz")[0] == 200
        ctl.poll_health()
        st = ctl.fleet_state()["replicas"][victim.name]
        assert st["draining"] is False and st["healthy"] is True
        status, _, _ = _post(victim.address, "/v1/generate",
                             {"prompt": [2, 4, 6, 8], "max_new": 2})
        assert status == 200
    finally:
        _stop_all(ctl, *servers)


# -- the role balancer and the controller's specs ----------------------------------


def _samples(pf_q, dc_q, dc_burn=0.0):
    return {
        "p0": {"role": "prefill", "queue_depth": pf_q, "slo_burn": 0.0},
        "p1": {"role": "prefill", "queue_depth": pf_q, "slo_burn": 0.0},
        "d0": {"role": "decode", "queue_depth": dc_q, "slo_burn": dc_burn},
    }


def test_balancer_needs_consecutive_windows_and_dwell():
    b = RoleBalancer(threshold=2.0, windows=3, dwell_s=10.0)
    assert b.observe(0.0, _samples(0, 8)) == []
    assert b.observe(1.0, _samples(0, 8)) == []
    assert b.observe(2.0, _samples(4, 4)) == []  # a calm sample resets
    assert b.observe(3.0, _samples(0, 8)) == []
    assert b.observe(4.0, _samples(0, 8)) == []
    moves = b.observe(5.0, _samples(0, 8))
    assert moves in ([("p0", "decode")], [("p1", "decode")])
    for t in (6.0, 7.0, 8.0):  # the dwell holds further moves back
        assert b.observe(t, _samples(0, 8)) == []
    assert b.observe(16.0, _samples(0, 8)) != []


def test_balancer_never_empties_a_role():
    b = RoleBalancer(threshold=2.0, windows=1, dwell_s=0.0)
    one_each = {
        "p0": {"role": "prefill", "queue_depth": 9, "slo_burn": 0.0},
        "d0": {"role": "decode", "queue_depth": 0, "slo_burn": 0.0},
    }
    for t in range(5):
        assert b.observe(float(t), one_each) == []


def test_balancer_slo_burn_counts_as_decode_pressure():
    b = RoleBalancer(threshold=2.0, windows=1, dwell_s=0.0, slo_weight=4.0)
    moves = b.observe(0.0, _samples(1, 1, dc_burn=3.0))
    assert moves and moves[0][1] == "decode"
    b2 = RoleBalancer(threshold=2.0, windows=1, dwell_s=0.0)
    assert b2.observe(0.0, _samples(1, 1, dc_burn=0.9)) == []


def test_balancer_ignores_monolithic_and_missing_pools():
    b = RoleBalancer(windows=1, dwell_s=0.0)
    mono = {
        "m0": {"role": "monolithic", "queue_depth": 50, "slo_burn": 9.0},
        "m1": {"role": "monolithic", "queue_depth": 0, "slo_burn": 0.0},
    }
    assert b.observe(0.0, mono) == []
    no_decode = {
        "p0": {"role": "prefill", "queue_depth": 50, "slo_burn": 0.0},
        "p1": {"role": "prefill", "queue_depth": 50, "slo_burn": 0.0},
    }
    assert b.observe(1.0, no_decode) == []


def test_controller_rejects_bad_specs_and_unknown_fleet_posts():
    for bad in ([], ["localhost:notaport"], ["localhost:8000=chef"]):
        with pytest.raises(ValueError):
            FleetController(bad)
    ctl = FleetController(["127.0.0.1:1=prefill",
                           "127.0.0.1:2=decode"]).start()
    try:
        assert _post(ctl.address, "/fleet/drain",
                     {"replica": "nobody:9"})[0] == 404
        assert _post(ctl.address, "/fleet/role",
                     {"replica": "127.0.0.1:1", "role": "chef"})[0] == 400
        assert _post(ctl.address, "/fleet/role",
                     {"replica": "127.0.0.1:1", "role": "decode"})[0] == 200
        assert ctl.fleet_state()["replicas"]["127.0.0.1:1"]["role"] == \
            "decode"
    finally:
        ctl.stop()


def test_session_lru_evicts_idle_before_active():
    ctl = FleetController(["127.0.0.1:1=decode", "127.0.0.1:2=decode"],
                          session_cap=2, health_interval_s=600.0)
    try:
        ctl._note_session("s1", "127.0.0.1:1")
        ctl._note_session("s2", "127.0.0.1:2")
        member, how = ctl._pick_decode([1, 2, 3], "s1", set())
        assert how == "sticky" and member.name == "127.0.0.1:1"
        ctl._note_session("s3", "127.0.0.1:2")
        assert "s1" in ctl._sessions and "s2" not in ctl._sessions
        assert _prom(ctl.registry.render(),
                     "fleet_sessions_evicted_total") == 1
    finally:
        ctl._httpd.server_close()  # never started


# -- the router -----------------------------------------------------------------


class _FakeReplica:
    """A bare /healthz whose payload the test scripts."""

    def __init__(self):
        fake = self

        class Handler(QuietHandler):
            def do_GET(self):
                if fake.down:
                    self.close_connection = True
                    return
                send_json(self, 200, {
                    "ok": True, "draining": fake.draining,
                    "config_hash": fake.config_hash, "queue_depth": 0})

        self.down = False
        self.draining = False
        self.config_hash = "a" * 64
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    @property
    def address(self):
        return self._httpd.server_address[:2]

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def test_router_marks_restarted_replica_incompatible():
    fake = _FakeReplica()
    router = ReplicaRouter([fake.address], health_interval_s=10.0)
    name = "%s:%d" % fake.address
    try:
        router.poll_health()  # first contact pins the hash
        st = router.replica_states()[name]
        assert st["healthy"] and not st["incompatible"]
        fake.down = True
        router.poll_health()
        assert not router.replica_states()[name]["healthy"]
        fake.down, fake.config_hash = False, "b" * 64
        router.poll_health()
        st = router.replica_states()[name]
        assert st["incompatible"] and st["config_hash"] == "a" * 64
        status, _, served = router.route({"prompt": [1, 2, 3],
                                          "max_new": 1})
        assert status == 503 and served is None
    finally:
        router._httpd.server_close()
        fake.stop()


def test_router_respects_replica_draining_flag():
    fake = _FakeReplica()
    router = ReplicaRouter([fake.address], health_interval_s=10.0)
    name = "%s:%d" % fake.address
    try:
        fake.draining = True
        router.poll_health()
        st = router.replica_states()[name]
        assert st["healthy"] and st["draining"]
        fake.draining = False
        router.poll_health()
        assert not router.replica_states()[name]["draining"]
    finally:
        router._httpd.server_close()
        fake.stop()


def test_router_affinity_spread_retry_and_breaker(params):
    """Over two port servers: distinct prompts spread, shared-prefix
    prompts pin to one replica (whose cache hits), every attempt leaves a
    ``dispatch`` span; a stopped replica's requests retry on the survivor
    and its breaker opens; restarted, a health poll does not close the
    breaker, and once the survivor drains, a forwarded request (the
    half-open probe) does."""
    rng = np.random.default_rng(11)
    servers = [_server(params, n_slots=4, prefix_cache=True)
               for _ in range(2)]
    tracer = Tracer(process_name="router")
    router = ReplicaRouter([s.address for s in servers],
                           affinity_min_match=6, health_interval_s=600.0,
                           tracer=tracer).start()
    revived = None
    try:
        seen = set()
        for _ in range(4):
            st, out, served = _post(router.address, "/v1/generate",
                                    {"prompt": rng.integers(0, 64, 8).tolist(),
                                     "max_new": 3})
            assert st == 200, out
            seen.add(served)
        assert len(seen) == 2, "least-loaded dispatch never spread"
        shared = rng.integers(0, 64, 10).tolist()
        pinned = set()
        for _ in range(5):
            p = shared + rng.integers(0, 64, 3).tolist()
            st, out, served = _post(router.address, "/v1/generate",
                                    {"prompt": p, "max_new": 3})
            assert st == 200, out
            pinned.add(served)
        assert len(pinned) == 1, pinned
        name = pinned.pop()
        eng = next(s.engine for s in servers if s.name == name)
        assert eng.metrics.n_prefix_hits_full + \
            eng.metrics.n_prefix_hits_partial > 0
        assert b"router_affinity_total" in _get(router.address,
                                                "/metrics")[1]
        # a replica dies: its requests retry on the survivor
        victim = next(s for s in servers if s.name == name)
        survivor = next(s for s in servers if s is not victim)
        host, port = victim.address
        victim.stop()
        for _ in range(4):
            st, _, served = _post(router.address, "/v1/generate",
                                  {"prompt": shared + [1, 2, 3],
                                   "max_new": 2})
            assert st == 200 and served == survivor.name
        for _ in range(3):  # failed polls count toward the breaker too
            router.poll_health()
        states = router.replica_states()
        assert not states[name]["healthy"]
        assert states[name]["breaker"]["state"] == OPEN
        assert _prom(_get(router.address, "/metrics")[1].decode(),
                     "router_retries_total") >= 1
        # restarted on the same port: health alone does not close it
        revived = ServingServer(_engine(params, n_slots=4), host=host,
                                port=port).start()
        router.poll_health()
        st = router.replica_states()[name]
        assert st["healthy"] and st["breaker"]["state"] == OPEN
        # the half-open probe goes out only when no closed replica is left:
        # drain the survivor
        assert _post(survivor.address, "/drain", {})[0] == 200
        router.poll_health()
        deadline = time.monotonic() + 30.0
        while router.replica_states()[name]["breaker"]["state"] != CLOSED:
            assert time.monotonic() < deadline, "breaker never closed"
            time.sleep(0.3)  # the probe's backoff elapses, then a request
            _post(router.address, "/v1/generate",
                  {"prompt": shared + [4, 5], "max_new": 2})
        assert "breaker" in [e[2] for e in router.flight._events]
    finally:
        _stop_all(router, *servers, *([revived] if revived else []))
    names = [e["name"] for e in tracer.chrome_trace()["traceEvents"]
             if e.get("ph") == "X"]
    assert names.count("dispatch") >= 13


def test_router_partition_bounded_breaker_cycle(params):
    """A partitioned replica gives bounded 5xx (never a hang), opens its
    breaker; health polls alone do not close it, one half-open probe
    request does."""
    srv = _server(params)
    proxy = ChaosProxy(srv.address, seed=1)
    name = proxy.address
    router = ReplicaRouter([("127.0.0.1", proxy.port)],
                           health_interval_s=600.0)
    try:
        router.poll_health()
        st = router.replica_states()[name]
        assert st["healthy"] and st["breaker"]["state"] == CLOSED
        proxy.set_partition(True)
        t0 = time.monotonic()
        status, _, served = router.route({"prompt": [1, 2, 3, 4],
                                          "max_new": 2}, deadline_ms="3000")
        assert status in (503, 504) and served is None
        assert time.monotonic() - t0 < 5.0
        router.poll_health()
        router.poll_health()
        assert router.replica_states()[name]["breaker"]["state"] == OPEN
        proxy.set_partition(False)
        router.poll_health()
        st = router.replica_states()[name]
        assert st["healthy"] and st["breaker"]["state"] == OPEN
        t0 = time.monotonic()
        status, _, served = router.route({"prompt": [1, 2, 3, 4],
                                          "max_new": 2})
        assert status == 503 and served is None
        assert time.monotonic() - t0 < 2.0
        time.sleep(1.05)  # the backoff elapses: a probe is due
        status, _, served = router.route({"prompt": [1, 2, 3, 4],
                                          "max_new": 2})
        assert status == 200 and served == name
        assert router.replica_states()[name]["breaker"]["state"] == CLOSED
    finally:
        router._httpd.server_close()
        _stop_all(proxy, srv)


# -- live migration over HTTP -----------------------------------------------------


def _wait_live_slot(eng, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if any(st is not None for st in eng._slots):
            return True
        time.sleep(0.002)
    return False


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "T0.8"])
def test_http_migration_mid_generation_parity(jparams, params, temperature):
    """``POST /migrate`` on a replica with a generate in flight: the
    session seats on the target, and the original blocked client gets the
    destination's tokens, the uninterrupted run's byte for byte (and the
    reference engine's, up to a near-tie); no token lost or doubled."""
    prompt = _prompt(35, 8)
    kw = dict(temperature=temperature)
    src_eng = _engine(params, rng_seed=5,
                      faults=FaultInjector(delay_s=0.05), **kw)
    dst_eng = _engine(params, rng_seed=99, **kw)
    dst = ServingServer(dst_eng, port=0).start()
    src = ServingServer(src_eng, port=0,
                        migrate_targets=(_name(dst),)).start()
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(resp=_post(
            src.address, "/v1/generate", {"prompt": prompt, "max_new": 16},
            timeout=120)))
        t.start()
        assert _wait_live_slot(src_eng), "the generate never admitted"
        status, res, _ = _post(src.address, "/migrate", {}, timeout=60)
        assert status == 200, res
        assert res["exported"] == 1 and res["migrated"] == 1, res
        t.join(timeout=120)
        assert not t.is_alive(), "the client hung across the migration"
        status, body, _ = out["resp"]
        assert status == 200, body
        ref = _mono_tokens(params, prompt, 16, rng_seed=5, **kw)
        assert body["tokens"] == ref
        _check_near_tie(jparams, params,
                        _ref_stream(jparams, prompt, 16, temperature, 5),
                        np.asarray(body["tokens"]), temperature,
                        threefry.split(threefry.key(5))[1])
        kinds = [e[2] for e in src_eng.flight._events]
        assert {"migrate_out", "migrate_push", "migrate_settled"} <= set(
            kinds)
        assert "migrate_seated" in [e[2] for e in dst_eng.flight._events]
        for ev in src_eng.flight.dump("test")["events"]:
            if str(ev["kind"]).startswith("migrate"):
                assert not isinstance(ev.get("tokens"), list)
        summary = src_eng.metrics.summary()["migration"]
        assert summary["migrations_out"] == 1
        assert summary["migrations_settled_ok"] == 1
    finally:
        _stop_all(src, dst)


def test_migrate_deadline_during_export_settles_every_session(params):
    """A ``/migrate`` whose budget (``X-Deadline-Ms``) runs out while the
    engine loop is exporting: the poster waits for the export it started
    and settles every session it parked (cancelled, with its partial
    tokens), so every caller gets an answer and none waits for tokens
    nobody will send."""
    src_eng = _engine(params, faults=FaultInjector(delay_s=0.02))
    dst = _server(params)
    src = ServingServer(src_eng, port=0,
                        migrate_targets=(_name(dst),)).start()
    export = src_eng.export_sessions

    def slow_export():
        time.sleep(1.5)  # outlasts the 300 ms budget below
        return export()

    src_eng.export_sessions = slow_export
    try:
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.update({
            i: _post(src.address, "/v1/generate",
                     {"prompt": _prompt(47 + i, 8), "max_new": 16},
                     timeout=120)})) for i in range(2)]
        for t in threads:
            t.start()
        assert _wait_live_slot(src_eng), "the generate never admitted"
        conn = http.client.HTTPConnection(*src.address, timeout=60)
        try:
            conn.request("POST", "/migrate", body=b"{}",
                         headers={"Content-Type": "application/json",
                                  "X-Deadline-Ms": "300"})
            r = conn.getresponse()
            status, res = r.status, json.loads(r.read())
        finally:
            conn.close()
        assert status == 503, res
        assert res["error"] == "deadline expired during the export", res
        assert res["exported"] == res["failed"] >= 1 and res["migrated"] == 0
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "a caller hung on a parked session"
        answers = [out[i][:2] for i in range(2)]
        cancelled = [b for st, b in answers if st == 499]
        assert len(cancelled) == res["failed"], answers
        assert all(b["status"] == "cancelled" for b in cancelled)
        assert all(st in (200, 499) for st, _ in answers)
        summary = src_eng.metrics.summary()["migration"]
        assert summary["migrations_settled_failed"] == res["failed"]
    finally:
        _stop_all(src, dst)


def test_kv_session_wire_robustness_soft_declines_and_fallback(params):
    """Over ``/v1/kv_session``: a truncated frame, corrupt header bytes
    and a plain segment (no session state) are 400s; the intact frame
    seats and finishes with the uninterrupted tokens; a duplicate push is
    409; the receiver's own next request draws as a fresh engine of its
    seed (the seat split no key)."""
    from tests.test_torch_disagg import _export_session, _frame

    prompt = _prompt(31, 8)
    kw = dict(temperature=0.8)
    src = _engine(params, rng_seed=5, **kw)
    dst = ServingServer(_engine(params, rng_seed=99, **kw), port=0).start()
    try:
        _, sess = _export_session(src, prompt)
        frame = _frame(sess, sess["gen"])
        status, body = _post_frame(dst.address, frame[:len(frame) // 2],
                                   timeout=30)
        assert status == 400, body
        mangled = bytearray(frame)
        for i in range(10, 26):
            mangled[i] ^= 0xFF
        assert _post_frame(dst.address, bytes(mangled), timeout=30)[0] == 400
        status, body = _post_frame(dst.address, _frame(sess), timeout=30)
        assert status == 400 and "gen" in body["error"]
        status, body = _post_frame(dst.address, frame, idem="mig-k1")
        assert status == 200 and body["status"] == "finished", body
        assert body["tokens"] == _mono_tokens(params, prompt, 10,
                                              rng_seed=5, **kw)
        status, body = _post_frame(dst.address, frame, idem="mig-k1",
                                   timeout=30)
        assert status == 409 and body["duplicate"] is True
        status, body, _ = _post(dst.address, "/v1/generate",
                                {"prompt": prompt, "max_new": 4})
        assert status == 200
        assert body["tokens"] == _mono_tokens(params, prompt, 4,
                                              rng_seed=99, **kw)
        src.complete_migrated(sess["req"], body["tokens"])
    finally:
        dst.stop()


def test_kv_session_push_through_chaos_proxy_never_hangs(params):
    """A session push whose transport is cut (dropped, truncated) fails
    clean within its timeout; the receiver still seats the frame sent
    directly."""
    from tests.test_torch_disagg import _export_session, _frame

    prompt = _prompt(33, 8)
    src = _engine(params)
    dst = _server(params)
    proxy = ChaosProxy(dst.address, seed=3)
    via = ("127.0.0.1", proxy.port)
    try:
        _, sess = _export_session(src, prompt)
        frame = _frame(sess, sess["gen"])
        proxy.plan("drop", at=proxy.n_connections)
        t0 = time.monotonic()
        with pytest.raises(OSError):
            _post_frame(via, frame, timeout=5)
        assert time.monotonic() - t0 < 6.0
        proxy.plan("truncate", at=proxy.n_connections)
        t0 = time.monotonic()
        complete = None
        try:
            status, body = _post_frame(via, frame, timeout=5)
            if status == 200:
                complete = body
        except Exception:
            pass
        assert complete is None and time.monotonic() - t0 < 6.0
        status, body = _post_frame(dst.address, frame)
        assert status == 200 and body["status"] == "finished", body
        src.complete_migrated(sess["req"], body["tokens"])
    finally:
        _stop_all(proxy, dst)


def test_controller_drain_with_migration(params):
    """``/fleet/drain`` with ``{"migrate": true}`` relays the replica's
    ``/migrate`` to the other members: the client blocked on the drained
    replica gets the uninterrupted tokens."""
    r1_eng = _engine(params, faults=FaultInjector(delay_s=0.05))
    r1 = ServingServer(r1_eng, port=0).start()
    r2 = _server(params)
    ctl = FleetController([_name(r1), _name(r2)],
                          health_interval_s=0.2).start()
    try:
        prompt = _prompt(43, 8)
        out = {}
        t = threading.Thread(target=lambda: out.update(resp=_post(
            r1.address, "/v1/generate", {"prompt": prompt, "max_new": 16},
            timeout=120)))
        t.start()
        assert _wait_live_slot(r1_eng), "the generate never admitted"
        status, body, _ = _post(ctl.address, "/fleet/drain",
                                {"replica": _name(r1), "migrate": True},
                                timeout=90)
        assert status == 200 and body["draining"] is True, body
        assert body["migration"].get("migrated") == 1, body
        t.join(timeout=120)
        assert not t.is_alive()
        status, resp, _ = out["resp"]
        assert status == 200
        assert resp["tokens"] == _mono_tokens(params, prompt, 16)
        assert _prom(ctl.registry.render(),
                     'fleet_migrations_total{result="ok"}') == 1
    finally:
        _stop_all(ctl, r1, r2)


# -- the journal, the standby and the hedged transfer --------------------------------


def test_controller_journal_failover_and_standby_gate(params, tmp_path):
    """The warm standby answers 503 while the primary lives, then promotes
    from the journal after missed health checks (roles, stickiness and
    breaker state restored) and routes again."""
    srv = _server(params)
    live, dead = _name(srv), f"127.0.0.1:{_dead_port()}"
    jpath = str(tmp_path / "journal.json")
    specs = [live, f"{dead}=prefill"]
    primary = FleetController(specs, journal=jpath,
                              health_interval_s=600.0).start()
    standby = FleetController(specs, journal=jpath, health_interval_s=0.05,
                              standby_of="%s:%d" % primary.address,
                              failover_after=3).start()
    try:
        status, body, _ = _post(standby.address, "/v1/generate",
                                {"prompt": [1, 2, 3], "max_new": 1})
        assert status == 503 and body.get("standby") is True
        status, body, _ = _post(standby.address, "/fleet/drain",
                                {"replica": live})
        assert status == 503 and body.get("standby") is True
        status, body, _ = _post(primary.address, "/fleet/role",
                                {"replica": dead, "role": "decode"})
        assert status == 200, body
        primary._note_session("conv-9", live)
        for _ in range(3):
            primary._member(dead).breaker.record_failure()
        primary._write_journal()
        journal = json.loads(Path(jpath).read_text())
        assert journal["roles"][dead] == "decode"
        assert ["conv-9", live] in journal["sessions"]
        assert journal["breakers"][dead]["state"] == OPEN
        primary.stop()
        t0 = time.monotonic()
        while not standby.fleet_state()["active"]:
            assert time.monotonic() - t0 < 20.0, "the standby never promoted"
            time.sleep(0.05)
        st = standby.fleet_state()
        assert st["replicas"][dead]["role"] == "decode"
        assert st["replicas"][dead]["breaker"]["state"] == OPEN
        assert "conv-9" in standby._sessions
        assert _prom(standby.registry.render(), "fleet_failovers_total") == 1
        status, body, served = _post(standby.address, "/v1/generate",
                                     {"prompt": [1, 2, 3], "max_new": 1})
        assert status == 200 and served == live, body
    finally:
        _stop_all(primary, standby, srv)


def test_hedged_transfer_leg_fires_and_wins(params):
    """The transfer leg hedges onto the second prefill replica when the
    first stalls past the hedge delay; the hedge wins, the tokens are the
    monolithic ones, and the loser's late push is deduplicated."""
    pf0, pf1 = _server(params), _server(params)
    dc = ServingServer(_engine(params, prefix_cache=True), port=0).start()
    proxy = ChaosProxy(pf0.address, seed=5, latency_s=2.5)
    pf0_name = proxy.address
    ctl = FleetController(
        [f"{pf0_name}=prefill", f"{_name(pf1)}=prefill",
         f"{_name(dc)}=decode"],
        disagg_threshold=12, health_interval_s=600.0).start()
    try:
        t0 = time.monotonic()
        while (ctl._member(pf0_name).last_health is None
               and time.monotonic() - t0 < 30.0):
            time.sleep(0.02)
        assert ctl._member(pf0_name).last_health is not None
        time.sleep(0.2)
        proxy.plan("latency", at=proxy.n_connections, times=8)
        prompt = _prompt(41)
        t0 = time.monotonic()
        status, body, served = _post(ctl.address, "/v1/generate",
                                     {"prompt": prompt, "max_new": 4},
                                     timeout=90)
        assert status == 200, body
        assert served == _name(dc) and time.monotonic() - t0 < 30.0
        assert body["tokens"] == _mono_tokens(params, prompt, 4)
        prom = ctl.registry.render()
        assert _prom(prom, 'fleet_hedges_total{result="fired"}') == 1
        assert _prom(prom, 'fleet_hedges_total{result="won"}') == 1
        kinds = [e[2] for e in ctl.flight._events]
        assert "hedge_fired" in kinds and "hedge_won" in kinds
    finally:
        _stop_all(ctl, proxy, pf0, pf1, dc)


# -- the CLI ------------------------------------------------------------------------


def _spawn(args, env):
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "deeplearning4j_tpu_torch", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_port_file(path: Path, proc, timeout=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if path.exists():
            info = json.loads(path.read_text())
            return info["host"], int(info["port"])
        assert proc.poll() is None, proc.stdout.read()
        time.sleep(0.1)
    raise AssertionError(f"{path} never written")


def test_cli_router_over_two_serve_subprocesses(tmp_path):
    """``router --replica A --replica B --port-file F`` over two ``serve
    --device cpu --demo`` subprocesses (one found by its own
    ``--port-file``, one by its announce line): it announces itself, writes
    its
    address, routes (``X-Served-By`` one of the two), reports both
    replicas healthy under /replicas with their config hash, and exits 0
    on SIGINT; ``controller`` rejects a bad role with exit 2, and ``router
    --sanitize`` runs under the sanitizers and reports them clean at
    shutdown."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    serve = ["serve", "--demo", "--device", "cpu", "--port", "0",
             "--d-model", "32", "--n-layers", "1", "--n-heads", "2",
             "--seq-len", "32", "--slots", "2", "--temperature", "0",
             "--probe-cache", "off"]
    serve_pf = tmp_path / "serve.json"
    procs = [_spawn(serve + ["--port-file", str(serve_pf)], env),
             _spawn(serve, env)]
    router = None
    try:
        addrs = ["%s:%d" % _wait_port_file(serve_pf, procs[0])]
        for line in procs[1].stdout:
            if "serving on http://" in line:
                addrs.append(line.split("serving on http://")[1].split()[0])
                break
        assert len(addrs) == 2, "a replica never announced itself"
        pf = tmp_path / "router.json"
        router = _spawn(["router", "--replica", addrs[0], "--replica",
                         addrs[1], "--port", "0", "--port-file", str(pf),
                         "--health-interval", "0.2"], env)
        addr = _wait_port_file(pf, router)
        status, body, served = _post(addr, "/v1/generate",
                                     {"prompt": [1, 2, 3, 4], "max_new": 3})
        assert status == 200 and len(body["tokens"]) == 7
        assert served in addrs
        states = json.loads(_get(addr, "/replicas")[1])
        reps = states.get("replicas", states)
        assert set(reps) == set(addrs)
        assert all(r["healthy"] and r["config_hash"] for r in reps.values())
        router.send_signal(signal.SIGINT)
        assert router.wait(timeout=30) == 0
        assert "routing on http://" in router.stdout.read()
    finally:
        for p in procs + ([router] if router else []):
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "controller",
         "--replica", "127.0.0.1:1=chef", "--port", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "controller:" in out.stderr
    pf = tmp_path / "router_san.json"
    router = _spawn(["router", "--replica", "127.0.0.1:1", "--port", "0",
                     "--port-file", str(pf), "--sanitize"], env)
    try:
        _wait_port_file(pf, router)
    finally:
        router.send_signal(signal.SIGINT)
        assert router.wait(timeout=30) == 0
    out = router.stdout.read()
    assert "sanitizers: lock + sync active" in out
    assert "locks tracked, sync counts {}" in out
    assert "sanitizers: clean" in out
