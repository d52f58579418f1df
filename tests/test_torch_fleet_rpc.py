"""The port's fleet RPC primitives (``serving/rpc.py``) and network chaos
proxy (``serving/netfaults.py``): the reference's ``test_fleet_chaos.py``
unit tests of deadlines, circuit breakers, the latency window, hedging,
the idempotency registry and the chaos proxy, as port cases.

Both modules are stdlib copies of the reference's, so every scripted case
runs on the port's module and on the reference's (``pkg``): the two give
the same transitions, budgets and seeded draws. Nothing here loads a
model."""

import http.client
import json
import queue
import threading
import time
from http.server import ThreadingHTTPServer

import pytest

from deeplearning4j_tpu.serving import netfaults as j_netfaults
from deeplearning4j_tpu.serving import rpc as j_rpc
from deeplearning4j_tpu_torch.serving import netfaults, rpc
from deeplearning4j_tpu_torch.utils.httpjson import QuietHandler, send_json

_PKGS = {"port": (rpc, netfaults), "reference": (j_rpc, j_netfaults)}


@pytest.fixture(params=sorted(_PKGS))
def pkg(request):
    """(rpc module, netfaults module) of one package."""
    return _PKGS[request.param]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# -- deadlines -------------------------------------------------------------------


def test_deadline_budget_and_header_propagation(pkg):
    m = pkg[0]
    clk = _Clock()
    dl = m.Deadline.from_header("2000", default_s=30.0, clock=clk)
    assert dl.remaining_s() == pytest.approx(2.0)
    assert dl.timeout(10.0) == pytest.approx(2.0)
    assert dl.timeout(0.5) == pytest.approx(0.5)
    clk.t += 1.99
    assert dl.timeout(10.0) == pytest.approx(0.05)  # the floor
    assert dl.timeout(10.0, floor=0.0) == pytest.approx(0.01, abs=1e-6)
    assert not dl.expired()
    clk.t += 1.0
    assert dl.expired() and dl.remaining_s() == 0.0
    assert dl.header_value() == "1"  # never grants zero downstream
    assert m.DEADLINE_HEADER == "X-Deadline-Ms"


def test_deadline_malformed_header_falls_back_to_default(pkg):
    m = pkg[0]
    for bad in (None, "", "soon", "-5", "0", object()):
        dl = m.Deadline.from_header(bad, default_s=7.0, clock=_Clock())
        assert dl.remaining_s() == pytest.approx(7.0)


# -- circuit breaker -------------------------------------------------------------


def test_breaker_opens_after_consecutive_failures_only(pkg):
    m = pkg[0]
    br = m.CircuitBreaker(failure_threshold=3, reset_s=1.0, clock=_Clock())
    br.record_failure()
    br.record_failure()
    br.record_success()  # a success resets the consecutive count
    br.record_failure()
    br.record_failure()
    assert br.state == m.CLOSED and br.allow()
    br.record_failure()
    assert br.state == m.OPEN
    assert not br.allow()  # the backoff has not elapsed


def test_breaker_half_open_probe_and_exponential_backoff(pkg):
    m = pkg[0]
    clk = _Clock()
    transitions = []
    br = m.CircuitBreaker(
        failure_threshold=1, reset_s=1.0, max_reset_s=3.0, clock=clk,
        on_transition=lambda o, n: transitions.append((o, n)))
    br.record_failure()
    assert br.state == m.OPEN
    clk.t += 1.01
    assert br.allow()  # the half-open probe
    assert br.state == m.HALF_OPEN
    assert not br.allow()  # everyone else declined while it probes
    br.record_failure()  # the probe failed: open, backoff doubled
    assert br.state == m.OPEN
    clk.t += 1.01
    assert not br.allow()
    clk.t += 1.01
    assert br.allow()
    br.record_success()
    assert br.state == m.CLOSED
    br.record_failure()  # the success reset the backoff
    clk.t += 1.01
    assert br.allow()
    C, O, H = m.CLOSED, m.OPEN, m.HALF_OPEN
    assert transitions == [(C, O), (O, H), (H, O), (O, H), (H, C), (C, O),
                           (O, H)]


def test_breaker_snapshot_restore_is_probe_due(pkg):
    m = pkg[0]
    br = m.CircuitBreaker(failure_threshold=1, reset_s=1.0, clock=_Clock())
    br.record_failure()
    snap = br.snapshot()
    assert snap["state"] == m.OPEN
    br2 = m.CircuitBreaker(failure_threshold=1, reset_s=1.0, clock=_Clock())
    br2.restore(snap)
    # a restored OPEN breaker is due for its probe at once
    assert br2.state == m.OPEN and br2.allow()
    assert br2.state == m.HALF_OPEN
    br3 = m.CircuitBreaker(clock=_Clock())
    br3.restore({"state": m.HALF_OPEN, "failures": 1, "reset_s": 1.0})
    assert br3.state == m.OPEN  # the probe's owner died
    br4 = m.CircuitBreaker(clock=_Clock())
    br4.restore({"state": "garbled"})
    assert br4.state == m.CLOSED


def test_latency_window_default_until_min_samples(pkg):
    m = pkg[0]
    w = m.LatencyWindow(cap=100, min_samples=5, default_s=2.5)
    for x in (0.1, 0.2, 0.3):
        w.record(x)
    assert w.quantile(0.99) == 2.5  # warm-up: no hedging storm
    for x in (0.1, 0.2):
        w.record(x)
    assert w.quantile(0.99) <= 0.3
    assert w.quantile(0.0) == pytest.approx(0.1)


# -- hedging ---------------------------------------------------------------------


def test_hedge_not_fired_when_primary_is_fast(pkg):
    assert pkg[0].run_hedged(lambda leg: f"leg{leg}", delay_s=5.0) == (
        "leg0", 1, 0)


def test_hedge_fires_and_wins_when_primary_stalls(pkg):
    hedged = []

    def attempt(leg):
        if leg == 0:
            time.sleep(2.0)
        return f"leg{leg}"

    assert pkg[0].run_hedged(attempt, delay_s=0.1,
                             on_hedge=lambda: hedged.append(1)) == (
        "leg1", 2, 1)
    assert hedged == [1]


def test_hedge_first_completion_wins_even_when_it_failed(pkg):
    def attempt(leg):
        raise OSError("primary died")

    with pytest.raises(OSError, match="primary died"):
        pkg[0].run_hedged(attempt, delay_s=5.0)


def test_hedge_second_leg_rescues_failed_primary(pkg):
    def attempt(leg):
        if leg == 0:
            time.sleep(0.1)
            raise OSError("primary died late")
        time.sleep(0.3)
        return "hedge saved it"

    assert pkg[0].run_hedged(attempt, delay_s=0.05) == ("hedge saved it",
                                                        2, 1)


def test_hedge_respects_deadline_budget(pkg):
    m = pkg[0]
    t0 = time.monotonic()
    with pytest.raises(queue.Empty):
        m.run_hedged(lambda leg: time.sleep(10.0), delay_s=0.5,
                     deadline=m.Deadline(0.3))
    assert time.monotonic() - t0 < 2.0


def test_idempotency_registry_lru(pkg):
    reg = pkg[0].IdempotencyRegistry(cap=3)
    assert reg.first_seen("a") and not reg.first_seen("a")
    assert reg.first_seen("b") and reg.first_seen("c")
    _ = reg.first_seen("a")  # touch: most recent
    assert reg.first_seen("d")  # evicts b
    assert reg.first_seen("b")  # b was forgotten
    assert not reg.first_seen("a")
    assert reg.first_seen("") and reg.first_seen("")  # unkeyed: no dedup


# -- the chaos proxy -------------------------------------------------------------


class _EchoHTTP:
    """GET /ping answers 200 JSON; POST /echo answers the body's length."""

    def __init__(self):
        class Handler(QuietHandler):
            def do_GET(self):
                send_json(self, 200, {"pong": True})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                data = self.rfile.read(n)
                send_json(self, 200, {"nbytes": len(data)})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    @property
    def address(self):
        return self._httpd.server_address[:2]

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _http(addr, method, path, body=b"", timeout=5.0):
    if isinstance(addr, str):
        host, port = addr.rsplit(":", 1)
        addr = (host, int(port))
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request(method, path, body=body or None)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


@pytest.fixture
def echo():
    target = _EchoHTTP()
    yield target
    target.stop()


def test_chaos_proxy_passthrough_and_counters(pkg, echo):
    proxy = pkg[1].ChaosProxy(echo.address, seed=7)
    try:
        status, data = _http(proxy.address, "GET", "/ping")
        assert status == 200 and json.loads(data)["pong"]
        status, data = _http(proxy.address, "POST", "/echo", b"x" * 500)
        assert status == 200 and json.loads(data)["nbytes"] == 500
        assert proxy.n_connections == 2
        assert all(v == 0 for v in proxy.counts.values())
    finally:
        proxy.stop()


def test_chaos_proxy_refuse_partition_and_drop_are_bounded(pkg, echo):
    proxy = pkg[1].ChaosProxy(echo.address, seed=7).plan("refuse", at=0)
    try:
        for kind, arm in (("refuse", None),
                          ("refused_partition",
                           lambda: proxy.set_partition(True)),
                          ("drop", lambda: (proxy.set_partition(False),
                                            proxy.plan(
                                                "drop",
                                                at=proxy.n_connections)))):
            if arm is not None:
                arm()
            t0 = time.monotonic()
            with pytest.raises(OSError):
                _http(proxy.address, "GET", "/ping", timeout=3.0)
            assert time.monotonic() - t0 < 3.5
            assert proxy.counts[kind] == 1
        status, _ = _http(proxy.address, "GET", "/ping")  # healed
        assert status == 200
    finally:
        proxy.stop()


def test_chaos_proxy_truncates_and_corrupts(pkg, echo):
    proxy = pkg[1].ChaosProxy(echo.address, seed=7)
    try:
        # truncate: a cut mid-frame, never a hang and never a whole 200
        proxy.plan("truncate", at=proxy.n_connections)
        t0 = time.monotonic()
        complete = None
        try:
            status, data = _http(proxy.address, "POST", "/echo",
                                 b"y" * 4096, timeout=3.0)
            if status == 200:
                complete = json.loads(data)["nbytes"]
        except Exception:
            pass
        assert complete is None
        assert time.monotonic() - t0 < 3.5
        assert proxy.counts["truncate"] == 1
        # corrupt: a mangled request fails clean
        proxy.plan("corrupt", at=proxy.n_connections)
        t0 = time.monotonic()
        try:
            status, _ = _http(proxy.address, "POST", "/echo", b"z" * 64,
                              timeout=3.0)
            assert status >= 400
        except Exception:
            pass
        assert time.monotonic() - t0 < 3.5
        assert proxy.counts["corrupt"] == 1
    finally:
        proxy.stop()


def test_chaos_proxy_seeded_rates_replay():
    """One seed gives one sequence of faults, in both packages alike."""
    draws = []
    for mod in (netfaults, netfaults, j_netfaults):
        target = _EchoHTTP()
        proxy = mod.ChaosProxy(target.address, seed=42, refuse_rate=0.5)
        try:
            outcomes = []
            for _ in range(8):
                try:
                    status, _ = _http(proxy.address, "GET", "/ping",
                                      timeout=3.0)
                    outcomes.append(status == 200)
                except OSError:
                    outcomes.append(False)
            draws.append(tuple(outcomes))
            assert proxy.counts["refuse"] >= 1
        finally:
            proxy.stop()
            target.stop()
    assert draws[0] == draws[1] == draws[2]
