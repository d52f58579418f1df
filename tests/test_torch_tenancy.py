"""Tenancy in the port (``serving/tenancy.py``, the scheduler's DRR tier,
per-tenant slot caps, quotas, metrics and SLO burn, and the server's API
keys) held against the reference's (``tests/test_serving_tenancy.py``
:145-:301).

Bars:

- fairness: a flooding tenant cannot starve its classmates (the victims
  complete measurably earlier than under FIFO) and greedy streams stay
  byte-identical (the scheduler only reorders); weight biases the share;
- quotas: a tenant's bucket rejects at submit with ``QuotaExceeded``,
  refills on an injected clock and never gates another tenant;
- the port's scheduler pops in the reference ``RequestScheduler``'s order
  over one seeded sequence of submits, pops and requeues, with a registry
  and without one.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import RequestScheduler as JScheduler
from deeplearning4j_tpu.serving import TenantConfig as JTenantConfig
from deeplearning4j_tpu.serving import TenantRegistry as JTenantRegistry
from deeplearning4j_tpu.serving import QuotaExceeded as JQuotaExceeded
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import (
    Backpressure,
    QuotaExceeded,
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

CFG = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                           n_layers=2, d_ff=64, max_len=32)


@pytest.fixture(scope="module")
def params():
    return pt.init_params(CFG, seed=0, device="cpu")


def _engine(params, n_slots=2, tenancy=None, quantum=64):
    return ServingEngine(
        CFG, params, n_slots=n_slots, temperature=0.0, device="cpu",
        scheduler=RequestScheduler(max_queue_depth=64, tenancy=tenancy,
                                   drr_quantum=quantum),
        tenancy=tenancy)


def _requests(n, seed=0, tenant_id="", adapter=0, max_new=6):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, CFG.vocab_size,
                                        (int(rng.integers(3, 10)),)),
                    max_new=max_new, tenant_id=tenant_id, adapter=adapter,
                    done=threading.Event()) for _ in range(n)]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.id: engine.pop_result(r.id) for r in reqs}


def _run_ordered(engine, reqs):
    """Step by step, each request's completion rank (requests retired in
    one step share a rank)."""
    for r in reqs:
        engine.submit(r)
    rank, ranks = 0, {}
    while not engine.idle:
        engine.step()
        newly = [r for r in reqs if r.done.is_set() and r.id not in ranks]
        for r in newly:
            ranks[r.id] = rank
        rank += bool(newly)
    return ranks


def _flood_and_victims(tagged=True):
    """``tagged=False`` blanks the tenant ids: one implicit tenant, the
    FIFO baseline."""
    flood = _requests(12, seed=1, tenant_id="flood" if tagged else "")
    victims = [r for v in range(3) for r in _requests(
        2, seed=10 + v, tenant_id=f"victim{v}" if tagged else "")]
    return flood, victims


def _fair_registry():
    return TenantRegistry([TenantConfig("flood", api_key="f")]
                          + [TenantConfig(f"victim{v}", api_key=f"v{v}")
                             for v in range(3)])


def test_drr_flood_does_not_starve_victims(params):
    flood_a, victims_a = _flood_and_victims(tagged=False)
    fifo = _run_ordered(_engine(params), flood_a + victims_a)
    flood_b, victims_b = _flood_and_victims()
    drr = _run_ordered(_engine(params, tenancy=_fair_registry()),
                       flood_b + victims_b)

    def pos(ranks, victims):
        return np.mean([ranks[r.id] for r in victims]) / max(ranks.values())

    fifo_pos, drr_pos = pos(fifo, victims_a), pos(drr, victims_b)
    assert fifo_pos > 0.7, fifo_pos
    assert drr_pos < fifo_pos - 0.2, (drr_pos, fifo_pos)
    for r in flood_b + victims_b:
        assert r.status is RequestStatus.FINISHED
    # greedy decode does not depend on order: the bytes are the FIFO run's
    clean = _run(_engine(params), [Request(prompt=r.prompt.copy(),
                                           max_new=r.max_new)
                                   for r in flood_a + victims_a])
    fair_reqs = [Request(prompt=r.prompt.copy(), max_new=r.max_new,
                         tenant_id=r.tenant_id) for r in flood_b + victims_b]
    fair = _run(_engine(params, tenancy=_fair_registry()), fair_reqs)
    for a, b in zip(clean.values(), fair_reqs):
        np.testing.assert_array_equal(a, fair[b.id])


def test_drr_weight_biases_share(params):
    """weight 3 vs 1 under symmetric floods, the quantum below one
    request's cost and the light tenant first in the rotation: only the
    weight can make the heavy tenant finish earlier."""
    tenancy = TenantRegistry([
        TenantConfig("heavy", api_key="h", weight=3.0),
        TenantConfig("light", api_key="l", weight=1.0)])
    heavy = _requests(6, seed=2, tenant_id="heavy")
    light = _requests(6, seed=3, tenant_id="light")
    ranks = _run_ordered(_engine(params, tenancy=tenancy, quantum=8),
                         [r for pair in zip(light, heavy) for r in pair])
    assert (np.mean([ranks[r.id] for r in heavy])
            < np.mean([ranks[r.id] for r in light]))


def test_quota_429_and_refill(params):
    now = [0.0]
    tenancy = TenantRegistry(
        # each request below costs 8 prompt + 8 max_new = 16 tokens
        [TenantConfig("metered", api_key="m", rate=16.0, burst=32.0),
         TenantConfig("open", api_key="o")], clock=lambda: now[0])
    engine = _engine(params, tenancy=tenancy)
    prompt = np.arange(8, dtype=np.int32)

    def req(tid):
        return Request(prompt=prompt.copy(), max_new=8, tenant_id=tid)

    engine.submit(req("metered"))
    engine.submit(req("metered"))  # 32 = the burst
    with pytest.raises(QuotaExceeded):
        engine.submit(req("metered"))
    engine.submit(req("open"))  # a dry bucket gates no one else
    assert tenancy.bucket_level("metered") == pytest.approx(0.0)
    now[0] += 1.0  # +16 tokens: exactly one more request
    engine.submit(req("metered"))
    with pytest.raises(QuotaExceeded):
        engine.submit(req("metered"))
    engine.run()
    s = engine.metrics.summary()
    assert s["rejections"] == {"quota": 2}
    assert s["tenants"]["metered"]["n_rejected"] == 2
    assert s["tenants"]["metered"]["n_finished"] == 3
    assert s["tenants"]["open"]["n_finished"] == 1
    assert issubclass(QuotaExceeded, Backpressure)
    prom = engine.metrics.render_prometheus()
    assert 'serve_rejections_total{reason="quota",tenant="metered"} 2' in prom
    assert 'serve_tenant_tokens_total{tenant="open"} 8' in prom


def test_slo_burn_gauge_from_per_tenant_p99(params):
    tenancy = TenantRegistry([
        TenantConfig("gold", api_key="g", slo_p99_tpot_s=0.001),
        TenantConfig("free", api_key="f")])
    engine = _engine(params, tenancy=tenancy)
    # declared but no samples yet: no gauge line
    assert "serve_tenant_slo_burn{" not in engine.metrics.render_prometheus()
    prompt = np.arange(8, dtype=np.int32)
    for tid in ("gold", "free", "gold"):
        engine.submit(Request(prompt=prompt.copy(), max_new=8,
                              tenant_id=tid))
    engine.run()
    lines = [ln for ln in engine.metrics.render_prometheus().splitlines()
             if ln.startswith("serve_tenant_slo_burn{")]
    assert len(lines) == 1 and 'tenant="gold"' in lines[0]
    burn = float(lines[0].split()[-1])
    s = engine.metrics.summary()
    assert burn == pytest.approx(s["tenants"]["gold"]["tpot_p99_s"] / 0.001)
    assert s["tenants"]["gold"]["slo_burn"] == pytest.approx(burn)
    assert "slo_burn" not in s["tenants"]["free"]


def test_max_slots_caps_concurrency(params):
    tenancy = TenantRegistry([
        TenantConfig("capped", api_key="c", max_slots=1),
        TenantConfig("roomy", api_key="r")])
    engine = _engine(params, n_slots=3, tenancy=tenancy)
    reqs = (_requests(3, seed=4, tenant_id="capped")
            + _requests(3, seed=5, tenant_id="roomy"))
    for r in reqs:
        engine.submit(r)
    peak = peak_all = 0
    while not engine.idle:
        engine.step()
        held = [st.req.tenant_id for st in engine._slots if st is not None]
        peak = max(peak, held.count("capped"))
        peak_all = max(peak_all, len(held))
    assert peak == 1 and peak_all == 3
    for r in reqs:
        assert r.status is RequestStatus.FINISHED


def test_registry_config_and_validation(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"tenants": [
        {"id": "a", "api_key": "ka", "priority": 0, "weight": 2,
         "max_slots": 3, "rate_tokens_per_s": 5, "default_adapter": 1,
         "slo_p99_tpot_s": 0.25},
        {"id": "anon"}]}))
    reg = TenantRegistry.from_file(path)
    a = reg.get("a")
    assert (a.priority, a.weight, a.max_slots, a.rate, a.burst,
            a.default_adapter, a.slo_p99_tpot_s) == (0, 2.0, 3, 5, 5, 1, 0.25)
    assert reg.resolve_key("ka") is a
    assert reg.resolve_key(None).tenant_id == "anon"
    assert reg.resolve_key("").tenant_id == "anon"
    assert reg.resolve_key("nope") is None
    assert reg.tenant_ids() == ["a", "anon"] and len(reg) == 2
    assert reg.bucket_level("anon") is None
    assert TenantRegistry.from_json([{"id": "t"}]).get("t").weight == 1.0
    for bad, match in [(dict(weight=0), "weight"), (dict(max_slots=0),
                       "max_slots"), (dict(rate=-1), "rate"),
                       (dict(default_adapter=-1), "default_adapter"),
                       (dict(slo_p99_tpot_s=0.0), "slo_p99_tpot_s")]:
        with pytest.raises(ValueError, match=match):
            TenantConfig("bad", **bad)
    with pytest.raises(ValueError, match="duplicate tenant_id"):
        TenantRegistry([TenantConfig("x"), TenantConfig("x", api_key="k")])
    with pytest.raises(ValueError, match="anonymous"):
        TenantRegistry([TenantConfig("x"), TenantConfig("y")])
    with pytest.raises(ValueError, match="duplicate api_key"):
        TenantRegistry([TenantConfig("x", api_key="k"),
                        TenantConfig("y", api_key="k")])


def _script(seed):
    """A seeded sequence of operations: submits over three tenants of
    varied cost and two classes, pops (some with an admissible predicate
    that turns tenant "b" away), requeues of popped requests and deficit
    adjustments."""
    rng = np.random.default_rng(seed)
    ops, n = [], 0
    for _ in range(120):
        u = rng.random()
        if u < 0.5:
            ops.append(("submit", n, ["a", "b", "c"][rng.integers(3)],
                        int(rng.integers(1, 12)), int(rng.integers(1, 20)),
                        int(rng.integers(0, 2))))
            n += 1
        elif u < 0.85:
            ops.append(("pop", bool(rng.random() < 0.3)))
        elif u < 0.93:
            ops.append(("requeue",))
        else:
            ops.append(("adjust", float(rng.integers(-30, 30))))
    return ops


def _replay_script(ops, sched_cls, req_cls, registry):
    sched = sched_cls(max_queue_depth=256, tenancy=registry, drr_quantum=16)
    order, popped = [], []
    for op in ops:
        if op[0] == "submit":
            _, i, tid, plen, new, pri = op
            r = req_cls(prompt=np.arange(plen) % 50, max_new=new,
                        priority=pri, tenant_id=tid if registry else "",
                        id=f"r{i}")
            sched.submit(r)
        elif op[0] == "pop":
            gate = (lambda r: r.tenant_id != "b") if op[1] else None
            r = sched.pop(admissible=gate)
            order.append(None if r is None else r.id)
            if r is not None:
                popped.append(r)
        elif op[0] == "requeue" and popped:
            sched.requeue(popped.pop())
        elif op[0] == "adjust" and popped:
            sched.adjust_deficit(popped[-1], op[1])
    while (r := sched.pop()) is not None:
        order.append(r.id)
    return order


@pytest.mark.parametrize("tenanted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pop_order_matches_reference_scheduler(tenanted, seed):
    def registry(config_cls, registry_cls):
        if not tenanted:
            return None
        return registry_cls([config_cls("a", api_key="ka", weight=1.0),
                             config_cls("b", api_key="kb", weight=2.0),
                             config_cls("c", api_key="kc", weight=0.5)])

    ops = _script(seed)
    want = _replay_script(ops, JScheduler, JRequest,
                          registry(JTenantConfig, JTenantRegistry))
    got = _replay_script(ops, RequestScheduler, Request,
                         registry(TenantConfig, TenantRegistry))
    assert got == want
    # every submitted request pops once, and each requeue once more
    n_sub = sum(op[0] == "submit" for op in ops)
    assert len(set(x for x in got if x is not None)) == n_sub


def test_quota_charge_matches_reference_registry():
    """The same charges on the same clock: the buckets agree and reject
    the same requests."""
    now = [0.0]
    regs = [cls([cfg("m", api_key="k", rate=10.0, burst=25.0)],
                clock=lambda: now[0])
            for cls, cfg in ((TenantRegistry, TenantConfig),
                             (JTenantRegistry, JTenantConfig))]
    rng = np.random.default_rng(2)
    for _ in range(40):
        now[0] += float(rng.random())
        cost = int(rng.integers(1, 15))
        out = []
        for reg, exc in zip(regs, (QuotaExceeded, JQuotaExceeded)):
            try:
                reg.charge("m", cost)
                out.append(True)
            except exc:
                out.append(False)
        assert out[0] == out[1]
        assert regs[0].bucket_level("m") == regs[1].bucket_level("m")


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_resolves_api_keys(params):
    """401 for an unknown key and for no key without an anonymous tenant;
    ``Authorization: Bearer`` resolves like ``X-API-Key``; the tenant's
    quota answers 429 and labels the rejection; its priority is the
    default."""
    tenancy = TenantRegistry([
        TenantConfig("a", api_key="ka", priority=0),
        TenantConfig("q", api_key="kq", rate=1.0, burst=12.0)])
    srv = ServingServer(_engine(params, tenancy=tenancy), port=0).start()
    host, port = srv.address
    url = f"http://{host}:{port}/v1/generate"
    body = {"prompt": [1, 2, 3], "max_new": 4}
    try:
        assert _post(url, body, {"X-API-Key": "zz"})[0] == 401
        assert _post(url, body)[0] == 401
        code, out = _post(url, body, {"Authorization": "Bearer ka"})
        assert code == 200 and len(out["tokens"]) == 7
        assert _post(url, body, {"X-API-Key": "kq"})[0] == 200
        code, out = _post(url, body, {"X-API-Key": "kq"})
        assert code == 429 and "quota" in out["error"]
        s = srv.engine.metrics.summary()
        assert s["tenants"]["q"]["n_rejected"] == 1
        assert s["tenants"]["a"]["n_finished"] == 1
        assert srv._parse({"prompt": [1], "max_new": 1},
                          tenancy.get("a")).priority == 0
    finally:
        srv.stop()
