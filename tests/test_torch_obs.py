"""The port's observability layer (``obs/trace.py``, ``obs/flight.py``,
``obs/logs.py``, ``obs/profiler.py``, ``obs/collect.py``, the engine's
tracer, flight and attribution hooks, and the server's ``/debug/dump``,
``/profile`` and metrics sidecar), held against the reference's.

- Given the same calls, the port's ``Tracer`` export, ``redact``, the
  flight bundle, ``merge_traces`` and ``JsonLogFormatter`` give the
  reference's output.
- A disabled tracer records nothing over a whole serving run.
- A traced engine run records the reference engine's (track, span name)
  set on the same greedy workload, and its Chrome trace is well formed
  (tracks named and ordered, spans nested on the engine and slot tracks).
- The engine's JSON log lines correlate by ``req_id``; the attribution
  families are the reference's; probes count toward none of them.
- The server: ``/debug/dump`` answers a redacted bundle, a crash writes one
  into ``flight_dir``, ``POST /profile?s=N`` arms a ``torch.profiler``
  capture (CPU activity here) and answers 409 while armed, the sidecar
  serves the scrape surface, and a ``traceparent`` reaches the admission
  span and the access log.
"""

import json
import logging
import re
import time
import urllib.error
import urllib.request
from io import StringIO

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import obs as jobs
from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.obs.trace import ENGINE_TRACK, SCHEDULER_TRACK
from deeplearning4j_tpu_torch.serving import (
    FaultInjector,
    Request,
    ServingEngine,
    ServingServer,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

JCFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _prompts(n=8, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, int(rng.integers(3, 10))).astype(np.int32),
             int(rng.integers(4, 12))) for _ in range(n)]


def _engine(params, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("n_slots", 3)
    return ServingEngine(CFG, params, device="cpu", **kw)


def _run(engine, cls, prompts):
    reqs = [cls(prompt=p.copy(), max_new=n) for p, n in prompts]
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    return [np.asarray(res[r.id]) for r in reqs]


@pytest.fixture(scope="module")
def traced(params, jparams):
    """One traced greedy run on each package: 8 requests into 3 slots at
    K 2, submitted together."""
    out = {}
    for name, make, cls in (
            ("port", lambda t: _engine(params, decode_horizon=2, tracer=t),
             Request),
            ("ref", lambda t: JEngine(JCFG, jparams, n_slots=3,
                                      temperature=0.0, decode_horizon=2,
                                      tracer=t), JRequest)):
        tracer = (obs.Tracer if name == "port" else jobs.Tracer)(
            enabled=True, capacity=1 << 14)
        eng = make(tracer)
        out[name] = (eng, tracer, _run(eng, cls, _prompts()))
    return out


# -- the modules against the reference's, call for call -------------------

def _trace_calls(t):
    t.span("engine", "step", 10.0, 0.25, n=1)
    t.span("slot-1", "prefill", 10.001, 0.01, req_id="r1", prompt_len=7,
           trace_id="ab" * 16, span_id="cd" * 8)
    t.instant("scheduler", "submit", ts=10.0005, req_id="r1")
    t.counter("scheduler", "queue_depth", 3, ts=10.3)
    t.span("slot-0", "decode", 10.2, 0.05, req_id="r0", k=4)
    t.instant("slot-0", "finished", ts=10.4, req_id="r0", n_tokens=9)
    t.span("migrate", "x", 10.5, -1.0)


def test_tracer_export_equals_reference(tmp_path):
    """The same calls on both tracers give byte-identical exports."""
    ours = obs.Tracer(enabled=True, capacity=64, process_name="serve a")
    ref = jobs.Tracer(enabled=True, capacity=64, process_name="serve a")
    ref._t0, ref._wall0 = ours._t0, ours._wall0
    for t in (ours, ref):
        _trace_calls(t)
    assert json.dumps(ours.chrome_trace()) == json.dumps(ref.chrome_trace())
    a = ours.export(tmp_path / "a.json").read_bytes()
    assert a == ref.export(tmp_path / "b.json").read_bytes()
    assert (ours.n_events, ours.dropped) == (ref.n_events, ref.dropped)


def test_tracer_ring_buffer_bounds_memory():
    """The reference's ring-buffer test, on both tracers."""
    for cls in (obs.Tracer, jobs.Tracer):
        t = cls(enabled=True, capacity=8)
        for i in range(100):
            t.span("trk", "s", float(i), 0.5)
        assert (t.n_events, t.dropped) == (8, 92)
        spans = [e for e in t.chrome_trace()["traceEvents"]
                 if e["ph"] == "X"]
        assert [e["ts"] for e in spans] == sorted(e["ts"] for e in spans)
        t.clear()
        assert t.n_events == 0 and t.dropped == 0
        with pytest.raises(ValueError):
            cls(capacity=0)


def test_traceparent_helpers_equal_reference():
    tid, sid = obs.new_trace_id(), obs.new_span_id()
    assert len(tid) == 32 and len(sid) == 16
    hdr = obs.format_traceparent(tid, sid)
    assert hdr == jobs.format_traceparent(tid, sid)
    for h in (hdr, hdr.upper(), None, "", "00-" + "0" * 32 + "-" + sid
              + "-01", "junk", f"00-{tid}-{sid}"):
        assert obs.parse_traceparent(h) == jobs.parse_traceparent(h)
    assert obs.parse_traceparent(hdr) == (tid, sid)


def test_redact_and_flight_bundle_equal_reference():
    """``redact`` and the flight bundle, for the same recorded events,
    equal the reference's (clock fields and the pid aside)."""
    payload = {"prompt": [1, 2, 3], "nested": [{"text": "secret",
                                                 "keep": 1}],
               "tokens": (4, 5), "Body": b"xy", "output": 7, "n": 2}
    assert obs.redact(payload) == jobs.redact(payload)
    ours, ref = obs.FlightRecorder(capacity=4), jobs.FlightRecorder(
        capacity=4)
    for fr in (ours, ref):
        for i in range(6):
            fr.record("dispatch", k=4, n_active=i, prompt=[1] * i)
        fr.record("admit", req_id="r9", text="hi")
    a = ours.dump("why", extra={"server": "s", "prompt": "p"})
    b = ref.dump("why", extra={"server": "s", "prompt": "p"})

    def scrub(d):
        d = dict(d, t_wall=0, pid=0)
        d["events"] = [dict(e, t_wall=0, t_mono=0) for e in d["events"]]
        return d

    assert scrub(a) == scrub(b)
    assert a["n_events"] == 4 and a["n_dropped"] == 3
    assert a["events"][-1]["text"] == "[redacted] len=2"
    off = obs.FlightRecorder(enabled=False)
    off.record("x")
    assert off.n_events == 0


def test_merge_traces_equals_reference(tmp_path):
    """Two per-process exports (the second's span a child of the first's)
    merge into the reference's document, and ``trace-merge`` writes it."""
    docs = []
    for i in range(2):
        t = obs.Tracer(enabled=True, process_name=f"serve {i}")
        t._wall0 = 1000.0 + i
        if i == 0:
            t.span("engine", "dispatch", t._t0 + 0.1, 0.2,
                   trace_id="ab" * 16, span_id="11" * 8)
        else:
            t.span("slot-0", "prefill", t._t0 + 0.05, 0.1,
                   trace_id="ab" * 16, span_id="22" * 8,
                   parent_span_id="11" * 8)
        docs.append(t.chrome_trace())
    merged = obs.merge_traces(docs)
    assert merged == jobs.merge_traces(docs)
    assert sum(1 for e in merged["traceEvents"] if e["ph"] == "s") == 1
    paths = []
    for i, d in enumerate(docs):
        paths.append(tmp_path / f"t{i}.json")
        paths[-1].write_text(json.dumps(d))
    out = tmp_path / "merged.json"
    assert cli.main(["trace-merge", *map(str, paths), "-o", str(out)]) == 0
    assert json.loads(out.read_text()) == merged
    assert cli.main(["trace-merge", str(tmp_path / "none.json"), "-o",
                     str(out)]) == 2


def test_json_log_formatter_equals_reference():
    rec = logging.LogRecord("deeplearning4j_tpu_torch.serving.engine",
                            logging.INFO, __file__, 1, "request_admitted",
                            (), None)
    rec.created = 1700000000.123456
    rec.req_id, rec.slot, rec.obj = "r3", 1, object
    out = obs.JsonLogFormatter().format(rec)
    assert out == jobs.JsonLogFormatter().format(rec)
    assert json.loads(out)["event"] == "request_admitted"


# -- the engine -------------------------------------------------------------

def test_disabled_tracer_records_nothing(params):
    """The default tracer is disabled and buffers no event over a whole
    serving run; ``region`` takes no timestamp either."""
    eng = _engine(params)
    assert not eng.tracer.enabled
    _run(eng, Request, _prompts(3, seed=5))
    assert eng.tracer.n_events == 0 and eng.tracer.dropped == 0
    with eng.tracer.region("t", "x"):
        pass
    assert eng.tracer.n_events == 0
    assert eng.flight.enabled and eng.flight.n_events > 0


def _track_names(tracer):
    evs = tracer.chrome_trace()["traceEvents"]
    tids = {e["tid"]: e["args"]["name"] for e in evs
            if e["ph"] == "M" and e["name"] == "thread_name"}
    return {(tids[e["tid"]], e["name"]) for e in evs if e["ph"] != "M"}


def test_engine_tracks_and_spans_equal_reference(traced):
    """The same greedy workload records the same (track, span name) set on
    both engines, and the same streams."""
    port_eng, port_t, port_streams = traced["port"]
    ref_eng, ref_t, ref_streams = traced["ref"]
    assert _track_names(port_t) == _track_names(ref_t)
    for a, b in zip(port_streams, ref_streams):
        np.testing.assert_array_equal(a, b)
    names = {n for _, n in _track_names(port_t)}
    assert {"queued", "prefill", "decode", "dispatch", "sync", "step",
            "first_token", "finished", "submit", "queue_depth",
            "kv_slots_active", "batch_parity_probe"} <= names


def test_chrome_trace_export_is_valid(traced, tmp_path):
    """The reference's structural test on the port's export: metadata
    tracks, non-negative µs stamps, thread-scoped instants, request ids on
    spans, and spans nested on the engine and slot tracks."""
    _, tracer, _ = traced["port"]
    doc = json.loads(tracer.export(tmp_path / "trace.json").read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    tid_name = {e["tid"]: e["args"]["name"] for e in meta
                if e["name"] == "thread_name"}
    assert {e["tid"] for e in meta if e["name"] == "thread_sort_index"} == (
        set(tid_name))
    assert tid_name[0] == ENGINE_TRACK and tid_name[1] == SCHEDULER_TRACK
    spans = [e for e in evs if e["ph"] == "X"]
    assert all(e["pid"] == 1 and e["ts"] >= 0 and e["dur"] >= 0
               for e in spans)
    assert all(e["s"] == "t" for e in evs if e["ph"] == "i")
    assert any("req_id" in (e.get("args") or {}) for e in spans)
    eps = 0.5
    checked = 0
    for tid, name in tid_name.items():
        if not (name == ENGINE_TRACK or name.startswith("slot-")):
            continue
        checked += 1
        stack = []
        for e in sorted((e for e in spans if e["tid"] == tid),
                        key=lambda e: (e["ts"], -e["dur"])):
            start, end = e["ts"], e["ts"] + e["dur"]
            while stack and stack[-1] <= start + eps:
                stack.pop()
            if stack:
                assert end <= stack[-1] + eps, (name, e["name"])
            stack.append(end)
    assert checked >= 2


def test_untraced_run_gives_the_traced_streams(params, traced):
    """Tracing changes nothing but the buffer."""
    _, _, traced_streams = traced["port"]
    plain = _run(_engine(params, decode_horizon=2), Request, _prompts())
    for a, b in zip(plain, traced_streams):
        np.testing.assert_array_equal(a, b)


def test_attribution_families_equal_reference(traced):
    """Each program family's dispatches and seconds (dispatch call to the
    readback that proved it complete) are in the summary and in
    ``/metrics``; the families and their dispatch counts are the
    reference's on the same workload."""
    port_eng = traced["port"][0]
    ref_eng = traced["ref"][0]
    s, rs = port_eng.metrics.summary(), ref_eng.metrics.summary()
    assert s["program_dispatches"] == rs["program_dispatches"]
    assert set(s["program_seconds"]) == set(rs["program_seconds"])
    assert all(v > 0 for v in s["program_seconds"].values())
    prom = port_eng.metrics.render_prometheus()
    for fam in s["program_dispatches"]:
        assert f'serve_program_dispatches_total{{family="{fam}"}}' in prom
        assert f'serve_program_seconds_total{{family="{fam}"}}' in prom


def test_probes_and_recovery_count_toward_no_family(params):
    """Runtime probes and replay after a crash leave the attribution as
    it was: their dispatches are no serving time."""
    eng = _engine(params, n_slots=2, chunked_replay=True,
                  faults=FaultInjector().plan("step", 2, "crash"))
    _run(eng, Request, _prompts(2, seed=3))
    assert eng.metrics.n_restarts == 1
    n = dict(eng.metrics.program_dispatches)
    eng._probe_batch_parity("miss", 8, 2)
    eng._probe_prefix_parity()
    assert eng.metrics.program_dispatches == n and not eng._pending_attr
    # the two admissions took one batched prefill; the replay's prefills
    # are not counted, nor is the horizon the crash dropped unread
    assert n == {"batch_prefill": 1, "step": eng.metrics._step - 1}


def test_json_logs_correlate_by_req_id(params):
    """Every engine log line is one JSON object; each request's lines
    share its ``req_id``, from submit to retirement."""
    buf = StringIO()
    pkg = logging.getLogger("deeplearning4j_tpu_torch")
    old = pkg.level
    handler = obs.configure_json_logging(level=logging.DEBUG, stream=buf)
    try:
        _run(_engine(params, n_slots=2), Request, _prompts(3, seed=9))
    finally:
        pkg.removeHandler(handler)
        pkg.setLevel(old)
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.strip()]
    assert recs and all({"ts", "level", "logger", "event"} <= set(r)
                        for r in recs)
    by_req = {}
    for r in recs:
        if "req_id" in r:
            by_req.setdefault(r["req_id"], set()).add(r["event"])
    assert len(by_req) == 3
    for events in by_req.values():
        assert {"request_submitted", "request_admitted",
                "request_retired"} <= events


def test_profile_trigger_step_scoped_capture(tmp_path):
    """The reference's trigger test on the port's: a capture of the next
    two steps writes a ``torch.profiler`` Chrome trace; one capture at a
    time; disarmed hooks do nothing."""
    trig = obs.ProfileTrigger(log_dir=tmp_path)
    assert not trig.armed
    d = trig.arm(2)
    assert trig.armed and d.parent == tmp_path
    with pytest.raises(RuntimeError):
        trig.arm(1)
    for _ in range(3):
        trig.step_start()
        (torch.ones(64) * 2).sum()
        trig.step_end()
    assert not trig.armed and trig.n_captures == 1
    doc = json.loads((d / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in doc["traceEvents"])
    trig.step_start()
    trig.step_end()
    assert trig.n_captures == 1
    with pytest.raises(ValueError):
        trig.arm(0)


# -- the server ---------------------------------------------------------------

def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _post(base, path, body=None, headers=None):
    req = urllib.request.Request(
        f"{base}{path}", method="POST", headers=headers or {},
        data=json.dumps(body).encode() if body is not None else b"")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_sidecar_debug_dump_and_profile(params, tmp_path):
    """The reference's ``test_server_metrics_sidecar_and_profile_
    endpoint`` on the port's server, plus ``/debug/dump`` and a capture
    armed over HTTP that lands after the next steps."""
    engine = _engine(params, n_slots=2,
                     profile=obs.ProfileTrigger(log_dir=tmp_path))
    srv = ServingServer(engine, port=0, metrics_port=0).start()
    try:
        main = "http://%s:%d" % srv.address
        side = "http://%s:%d" % srv.metrics_address
        assert srv.metrics_address[1] != srv.address[1]
        for base in (main, side):
            code, ctype, text = _get(base, "/metrics")
            assert code == 200 and "version=0.0.4" in ctype
            assert "# TYPE serve_queue_depth gauge" in text
            assert "serve_engine_alive 1" in text
            assert "serve_draining 0" in text
        assert _get(side, "/healthz")[0] == 200
        code, body = _post(main, "/profile?s=2")
        assert code == 200 and body["armed"] == 2
        assert _post(main, "/profile?s=1")[0] == 409
        assert _post(main, "/profile?s=0")[0] == 400
        code, out = _post(main, "/v1/generate",
                          {"prompt": [1, 2, 3, 4], "max_new": 5})
        assert code == 200 and len(out["tokens"]) == 9
        deadline = time.monotonic() + 30
        while engine.profile.armed and time.monotonic() < deadline:
            time.sleep(0.01)
        doc = json.loads((engine.profile.last_capture_dir
                          / "trace.json").read_text())
        assert any(e.get("name", "").startswith("aten::")
                   for e in doc["traceEvents"])
        code, _, text = _get(main, "/debug/dump")
        bundle = json.loads(text)
        assert code == 200 and bundle["reason"] == "debug_dump"
        assert {e["kind"] for e in bundle["events"]} >= {"admit",
                                                         "dispatch"}
        assert bundle["metrics"]["n_finished"] == 1
        assert bundle["health"]["ok"] and bundle["server"] == srv.name
    finally:
        srv.stop()
    engine2 = _engine(params, n_slots=2)
    srv2 = ServingServer(engine2, port=0).start()
    try:
        assert _post("http://%s:%d" % srv2.address, "/profile?s=1")[0] == 503
    finally:
        srv2.stop()


def test_server_dumps_flight_on_crash(params, tmp_path):
    """An injected crash writes a redacted bundle into ``flight_dir``
    before recovery; its last fault event names the crash; the request
    still gets the uninterrupted stream."""
    prompt = [5, 6, 7, 8, 9]
    ref = _run(_engine(params, n_slots=2), Request,
               [(np.array(prompt, np.int32), 8)])[0]
    engine = _engine(params, n_slots=2,
                     faults=FaultInjector().plan("step", 2, "crash"))
    srv = ServingServer(engine, port=0, flight_dir=str(tmp_path)).start()
    try:
        code, out = _post("http://%s:%d" % srv.address, "/v1/generate",
                          {"prompt": prompt, "max_new": 8})
    finally:
        srv.stop()
    assert code == 200 and out["tokens"] == ref.tolist()
    dumps = sorted(tmp_path.glob("flight-*-engine_crash-*.json"))
    assert len(dumps) == 1
    bundle = json.loads(dumps[0].read_text())
    assert bundle["reason"] == "engine_crash"
    faults = [e for e in bundle["events"] if e["kind"] == "fault"]
    assert faults[-1]["fault"] == "crash"
    admit = [e for e in bundle["events"] if e["kind"] == "admit"]
    assert admit and admit[0]["prompt_len"] == len(prompt)
    assert "EngineCrash" in bundle["last_error"]


def test_traceparent_reaches_the_span_and_the_access_log(params):
    """A caller's ``traceparent``: its trace id names the admission span
    (whose parent is the caller's span) and the access line; a request
    without one gets a fresh trace id."""
    tracer = obs.Tracer(enabled=True)
    engine = _engine(params, n_slots=2, tracer=tracer)
    buf = StringIO()
    pkg = logging.getLogger("deeplearning4j_tpu_torch")
    old = pkg.level
    handler = obs.configure_json_logging(level=logging.INFO, stream=buf)
    tid, sid = obs.new_trace_id(), obs.new_span_id()
    srv = ServingServer(engine, port=0).start()
    try:
        base = "http://%s:%d" % srv.address
        assert _post(base, "/v1/generate", {"prompt": [1, 2], "max_new": 3},
                     {"traceparent": obs.format_traceparent(tid, sid)}
                     )[0] == 200
        assert _post(base, "/v1/generate",
                     {"prompt": [3, 4], "max_new": 3})[0] == 200
    finally:
        srv.stop()
        pkg.removeHandler(handler)
        pkg.setLevel(old)
    prefill = [e for e in tracer.chrome_trace()["traceEvents"]
               if e["name"] == "prefill"]
    assert prefill[0]["args"]["trace_id"] == tid
    assert prefill[0]["args"]["parent_span_id"] == sid
    assert re.fullmatch(r"[0-9a-f]{16}", prefill[0]["args"]["span_id"])
    access = [json.loads(ln) for ln in buf.getvalue().splitlines()
              if '"event": "access"' in ln]
    assert [a["http"] for a in access] == [200, 200]
    assert access[0]["trace_id"] == tid and access[0]["parent_span_id"] == sid
    assert access[1]["trace_id"] not in (None, tid)
    assert access[0]["served_by"] == srv.name
