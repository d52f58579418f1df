"""A serving cell: ``ServingEngine.submit`` and ``step``, driven by the
benchmark's own load generator (``run_request_trace``'s loop, with due
times), and the check against the plain reference.

Every request carries a recorder as its ``stream``: the engine puts each
token there when the token reaches the host, and the recorder stamps it
with the host clock. Time to first token runs from the request's due time
in the schedule; a request the engine refuses or fails counts in
``failed`` and as an infinite latency.

Arrivals: a backlog (``flood``) keeps the engine's queue at its depth,
so a slot that frees is filled at the next step; a process with due
times (``poisson``) submits each request when it is due (an open loop;
how late the generator ran is printed). Set-up
warms every admission shape the mix reaches (each prompt bucket alone
and in batched groups of 2 up to the queue depth, which runs the engine's
batched-admission probes once per checkout: their verdicts are kept under
``benchmarks/.cache`` at a path named by a digest of the program's
sources) and then fills the engine (a backlog) or serves a short spell of
the mix (an open loop) before the window.

The cell file's ``engine`` block is passed to ``ServingEngine`` as its
keyword arguments and its ``scheduler`` block to ``RequestScheduler``:
a later cell sets an engine option as data, and a name either does not
know raises. The harness itself sets what the check needs (greedy
decoding) and what it supplies (the device, tracer, probe cache).

The check: after the window, a sample drawn from the seed of the
requests the window finished, the longest among them, is run through the
float32 reference over prompt + served tokens; ``max_gap`` is the widest
gap by which a served token's logit lies below the reference's best.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from benchmarks import counts
from benchmarks.harness import weights
from benchmarks.harness.core import (CACHE, Spans, log, percentile,
                                     sources_digest)
from benchmarks.harness.devtrace import WINDOW_SPAN, read_profile
from benchmarks.reference import gpt2_plain
from benchmarks.traffic.generator import RequestStream

#: what a serving cell's file holds: ``engine`` and ``scheduler`` go to
#: the program as keyword arguments, ``model`` to ``transformer_config``
CELL_KEYS = frozenset({"mode", "config", "traffic", "chips", "model",
                       "engine", "scheduler", "warmup_s", "drain_s",
                       "trace_steps", "check"})

#: engine arguments the harness sets itself: greedy decoding, which the
#: check needs, and what it supplies
HARNESS_SET = frozenset({"temperature", "top_k", "scheduler", "probe_cache",
                         "tracer", "device"})


class Recorder:
    """A request's token stream: each token and the host clock when it
    reached the host, and the harness's step count then."""

    __slots__ = ("toks", "times", "steps", "done", "step_ref")

    def __init__(self, step_ref: list):
        self.toks, self.times, self.steps = [], [], []
        self.done = None
        self.step_ref = step_ref

    def put(self, tok):
        now = time.perf_counter()
        if tok is None:
            self.done = now
            return
        self.toks.append(int(tok))
        self.times.append(now)
        self.steps.append(self.step_ref[0])


class Sent:
    """One request of the run, as the harness sees it."""

    __slots__ = ("req", "rec", "due", "submitted", "seated", "refused",
                 "late")

    def __init__(self, req, rec, due: float):
        self.req, self.rec, self.due = req, rec, due
        self.submitted = self.seated = None
        self.refused = False
        self.late = 0.0


def prompt_buckets(lengths, max_bucket: int) -> list[tuple[int, int, int]]:
    """(bucket, lo, hi): the engine's power-of-two prompt buckets (8 at
    least) that the given prompt lengths fall in, with the shortest and
    longest length each takes. A bucket no length reaches is left out."""
    lengths = np.unique(np.asarray(lengths))
    out, b = [], 8
    while b <= max_bucket:
        a = b // 2 + 1 if b > 8 else 1
        inb = lengths[(lengths >= a) & (lengths <= b)]
        if inb.size:
            out.append((b, int(inb[0]), int(inb[-1])))
        b *= 2
    return out


class Driver:
    """Submits the mix to the engine and steps it; one ``tick`` is one
    engine step (or a short wait for the next due request)."""

    def __init__(self, engine, stream, spans: Spans):
        from deeplearning4j_tpu_torch.serving.scheduler import Request

        self.Request = Request
        self.engine, self.stream = engine, stream
        self.depth = engine.scheduler.max_queue_depth
        self.flood = stream.backlog
        self.spans = spans
        self.step_ref = [0]
        self.sent: list[Sent] = []
        self.waiting: list[Sent] = []
        self.origin = None
        self._base = None
        self._next = None

    def make(self, prompt_range=None) -> Sent:
        toks, max_new, due = self.stream.next(prompt_range)
        rec = Recorder(self.step_ref)
        req = self.Request(prompt=toks, max_new=max_new, stream=rec)
        return Sent(req, rec, due)

    def submit(self, s: Sent) -> None:
        from deeplearning4j_tpu_torch.serving.scheduler import Backpressure

        s.submitted = time.perf_counter()
        if self.flood:
            # a backlog's request is due when it joins the queue
            s.due = s.submitted
        self.sent.append(s)
        try:
            with self.spans("bench.submit"):
                self.engine.submit(s.req)
        except Backpressure:
            s.refused = True
            s.rec.done = s.submitted
            return
        self.waiting.append(s)

    def step(self) -> bool:
        with self.spans("bench.engine_step"):
            worked = self.engine.step()
        self.step_ref[0] += 1
        now = time.perf_counter()
        still = []
        for s in self.waiting:
            if s.req.status.name == "QUEUED":
                still.append(s)
            else:
                s.seated = now
        self.waiting = still
        return worked

    def start(self) -> None:
        """Arrivals from now on: the next request is due now."""
        self.origin = time.perf_counter()
        self._base = None

    def tick(self) -> bool:
        """Submit what is due (flood: refill the queue), then step; an
        idle engine with nothing due waits a little instead."""
        if self.flood:
            while len(self.engine.scheduler) < self.depth:
                self.submit(self.make())
            return self.step()
        now = time.perf_counter()
        while True:
            if self._next is None:
                self._next = self.make()
            if self._base is None:
                self._base = self._next.due
            due_abs = self.origin + self._next.due - self._base
            if due_abs > now:
                break
            s, self._next = self._next, None
            s.due = due_abs
            s.late = now - due_abs
            self.submit(s)
        if self.engine.idle:
            time.sleep(max(0.0, min(due_abs - now, 0.002)))
            return False
        return self.step()

    def run_until_idle(self) -> None:
        while not self.engine.idle:
            self.step()


def build_engine(cell: dict, seed: int, device, trace: bool):
    """The cell's engine over weights made from the seed, and its tracer
    (recording only with ``trace``)."""
    from deeplearning4j_tpu_torch.models.transformer import param_shapes
    from deeplearning4j_tpu_torch.obs.trace import Tracer
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.serving.scheduler import RequestScheduler

    from benchmarks.harness.model import transformer_config

    cfg, c = cell["config"], cell["cell"]
    set_here = HARNESS_SET & set(c["engine"])
    if set_here:
        raise ValueError(f"the harness sets {sorted(set_here)} itself")
    tcfg = transformer_config(cfg, c["model"])
    params = weights.make_params(param_shapes(tcfg), seed, cfg["n_embd"],
                                 cfg["n_inner"], device, tcfg.compute_dtype)
    probe_cache = None
    if device.type == "cuda":
        CACHE.mkdir(parents=True, exist_ok=True)
        probe_cache = str(CACHE / f"probes-{sources_digest()}.json")
    tracer = Tracer(enabled=trace, capacity=1 << 19)
    engine = ServingEngine(
        tcfg, params, **c["engine"], temperature=0.0, top_k=None,
        scheduler=RequestScheduler(**c["scheduler"]),
        probe_cache=probe_cache, tracer=tracer, device=device)
    return engine, tracer


def warm_shapes(engine, cell: dict, seed: int, spans: Spans,
                seconds: float | None = None) -> Driver:
    """Every admission shape the mix reaches, once: each prompt bucket
    that the window's lengths fall in, alone and in groups of 2, 4, ... up
    to the queue depth. Returns the warm-up driver: its own stream of
    requests, over the same lengths as a window of ``seconds``."""
    from deeplearning4j_tpu_torch.serving.engine import PREFILL_MAX_BUCKET

    mix = cell["traffic"]
    depth, n_slots = engine.scheduler.max_queue_depth, engine.n_slots
    stream = RequestStream(mix, seed, cell["config"]["vocab_size"], "warmup",
                           seconds)
    warm = Driver(engine, stream, spans)
    outstanding = 0
    max_bucket = cell["cell"]["engine"].get("prefill_max_bucket",
                                            PREFILL_MAX_BUCKET)
    for _, lo, hi in prompt_buckets(stream.prompt_pool, max_bucket):
        nb = 1
        while nb <= depth:
            if outstanding + nb > n_slots:
                warm.run_until_idle()
                outstanding = 0
            for _ in range(nb):
                warm.submit(warm.make(prompt_range=(lo, hi)))
            warm.step()
            outstanding += nb
            nb *= 2
    return warm


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> dict:
    import torch

    cfg, c, mix = cell["config"], cell["cell"], cell["traffic"]
    engine, tracer = build_engine(cell, seed, device, trace)
    vocab, depth, n_slots = (cfg["vocab_size"],
                             engine.scheduler.max_queue_depth, engine.n_slots)
    dtype = engine.cfg.compute_dtype
    log("engine built")
    spans = Spans()
    warm = warm_shapes(engine, cell, seed, spans, seconds)
    log(f"admission shapes warmed ({warm.step_ref[0]} steps)")

    drv = Driver(engine, RequestStream(mix, seed, vocab, "window", seconds),
                 spans)
    drv.step_ref = warm.step_ref
    if drv.flood:
        # fill every slot before the window (a mix whose requests finish
        # faster than the queue refills them never does: stop after the
        # steps a fill at the queue's depth takes, twice over)
        for _ in range(2 * (n_slots // depth + 1)):
            if sum(1 for s in drv.sent + warm.sent
                   if s.seated is not None and s.rec.done is None) >= n_slots:
                break
            drv.tick()
    else:
        # a spell of the mix itself, then an empty engine
        warm.run_until_idle()
        warm.start()
        t_w = time.perf_counter()
        while time.perf_counter() - t_w < c["warmup_s"]:
            warm.tick()
        warm.run_until_idle()

    # a checkout's first run built the admission probes' scratch slot sets:
    # hand their cached blocks back so the window allocates as later runs do
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"engine filled ({drv.step_ref[0]} steps); window starts")
    occ = engine.metrics.occupancy
    tracer.clear()
    # set-up's objects out of the collector's way for the window
    gc.collect()
    gc.freeze()
    drv.start()
    t0 = drv.origin
    setup_s = t0 - t_start
    n0, tot0 = occ.n, occ.total
    s0 = drv.step_ref[0]
    if drv.flood:
        while time.perf_counter() - t0 < seconds:
            drv.tick()
        t1 = time.perf_counter()
        window_reqs = [s for s in drv.sent + warm.sent
                       if s.rec.done is not None and t0 <= s.rec.done <= t1]
    else:
        # the arrivals go on until every request due in the window is done
        t1 = t0 + seconds
        limit = t1 + c["drain_s"]
        while time.perf_counter() < limit:
            drv.tick()
            if time.perf_counter() >= t1 and all(
                    s.rec.done is not None for s in drv.sent if s.due < t1):
                break
        window_reqs = [s for s in drv.sent if s.due < t1]
    s1 = drv.step_ref[0]
    n1, tot1 = occ.n, occ.total
    gc.unfreeze()

    log(f"window done ({s1 - s0} steps, {len(window_reqs)} requests)")
    dtrace, work = None, {}
    if trace:
        dtrace, work = _traced_tail(drv, engine, c, device, cfg)
        log("traced tail read")

    queued = {}
    if trace:
        for ev in tracer.chrome_trace()["traceEvents"]:
            if ev.get("name") == "queued" and ev.get("args"):
                queued[ev["args"].get("req_id")] = ev["dur"] / 1e6
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)

    # what the window did
    all_reqs = drv.sent + warm.sent
    window_s = t1 - t0
    if drv.flood:
        tokens = sum(sum(1 for t in s.rec.times if t0 <= t <= t1)
                     for s in all_reqs)
    else:
        tokens = sum(len(s.rec.times) for s in window_reqs)
    flops = 0.0
    for s in all_reqs:
        n = len(s.req.prompt)
        if s.seated is not None and t0 <= s.seated <= t1:
            flops += counts.prefill_flops(cfg, n)
        for j, t in enumerate(s.rec.times):
            if t0 <= t <= t1:
                flops += counts.decode_flops(cfg, n + j + 1)
    ttft, tpot, qwait, failed = [], [], [], 0
    for s in window_reqs:
        ok = (not s.refused and s.req.status.name == "FINISHED"
              and len(s.rec.toks) == s.req.max_new)
        if not ok:
            failed += 1
            ttft.append(math.inf)
            tpot.append(math.inf)
            continue
        first, last = s.rec.times[0], s.rec.times[-1]
        ttft.append(first - s.due)
        tpot.append((last - first) / max(1, len(s.rec.times) - 1))
        if s.req.id in queued and s.req.arrival_time is not None:
            qwait.append(s.req.arrival_time - s.due + queued[s.req.id])
    del engine, drv.engine, warm.engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check
    log("program state freed; reference check starts")
    t_ref = time.perf_counter()
    done = [s for s in window_reqs if not s.refused
            and s.req.status.name == "FINISHED" and s.rec.times]
    gap, n_tok, sample, ctl = _check(cell, seed, done, device, dtype,
                                     control)
    check = {"max_gap": (gap, c["check"]["max_gap"])}
    e2e = {}
    if drv.flood:
        e2e["serve_tokens_per_s"] = tokens / window_s
        e2e["serve_requests_per_s"] = len(window_reqs) / window_s
    else:
        e2e["ttft_p95_ms"] = percentile(ttft, 95) * 1e3
        e2e["tpot_p95_ms"] = percentile(tpot, 95) * 1e3
    return {
        "setup_s": setup_s,
        "e2e": e2e,
        "record": {
            "kind": "serve", "config": cfg, "cell": c,
            "window": {"seconds": window_s, "tokens": tokens,
                       "model_flops": flops, "steps": s1 - s0,
                       "occupancy_mean": ((tot1 - tot0) / (n1 - n0)
                                          if n1 > n0 else None),
                       "n_slots": n_slots,
                       "queue_wait_s": qwait, "ttft_s": ttft,
                       "tpot_s": tpot},
            "trace": dtrace,
            "work": work,
        },
        "check": check,
        "attempted": len(window_reqs),
        "failed": failed,
        "memory_peak_bytes": peak,
        "reference_s": time.perf_counter() - t_ref,
        "lateness": (sorted(s.late for s in window_reqs)
                     if not drv.flood else []),
        "readings": {"max_gap": gap, "tokens_compared": n_tok,
                     "sample": sample, "control_max_gap": ctl},
    }


def _traced_tail(drv: Driver, engine, c: dict, device, cfg: dict):
    """A few engine steps under the profiler, the load going on as in the
    window; returns the trace and the work its decode horizons did."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    occ = engine.metrics.occupancy
    steps = int(c["trace_steps"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    drv.spans.profiling = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            s_first, n0 = drv.step_ref[0], occ.n
            done = 0
            while done < steps:
                if drv.tick():
                    done += 1
            s_last, n1 = drv.step_ref[0], occ.n
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    drv.spans.profiling = False
    drv.step()  # reads back the last traced horizon
    dtrace = read_profile(prof)
    # the horizons dispatched in the traced steps s_first .. s_last - 1
    # put their tokens in steps s_first + 1 .. s_last
    rows = tokens = 0
    for s in drv.sent:
        n = len(s.req.prompt)
        for j, st in enumerate(s.rec.steps):
            if s_first + 1 <= st <= s_last:
                tokens += 1
                rows += n + j + 1
    return dtrace, {"decode_tokens": tokens, "decode_rows": rows,
                    "substeps": (n1 - n0) * engine.decode_horizon,
                    "n_layer": cfg["n_layer"], "d": cfg["n_embd"]}


def _check(cell: dict, seed: int, done: list, device, dtype,
           control: bool = False):
    """(widest gap, tokens compared, sampled request ids, the control's
    widest gap or None) over a sample of the finished requests drawn from
    the seed, the longest in it. ``control`` also reads the gap of the
    token an fp8 reference puts first at each of the same positions."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import param_shapes

    from benchmarks.harness.model import transformer_config

    cfg, c = cell["config"], cell["cell"]
    if not done:
        return math.inf, 0, [], None
    rng = np.random.default_rng([int(seed), 7])
    longest = max(range(len(done)), key=lambda i: len(done[i].req.prompt)
                  + len(done[i].rec.toks))
    rest = [i for i in range(len(done)) if i != longest]
    k = min(len(rest), int(c["check"]["sample"]) - 1)
    pick = [longest] + list(rng.choice(rest, size=k, replace=False))
    tcfg = transformer_config(cfg, c["model"])
    params = weights.make_params(param_shapes(tcfg), seed, cfg["n_embd"],
                                 cfg["n_inner"], device, dtype)
    gap, n_tok, ctl = 0.0, 0, (0.0 if control else None)
    for i in pick:
        s = done[i]
        prompt = torch.as_tensor(s.req.prompt, device=device).long()
        served = torch.as_tensor(s.rec.toks, device=device).long()
        gaps, low = gpt2_plain.served_gaps(params, prompt, served,
                                           cfg["n_head"],
                                           "fp8" if control else "f32")
        gap = max(gap, float(gaps.max()))
        if control:
            ctl = max(ctl, float(low.max()))
        n_tok += len(s.rec.toks)
    return gap, n_tok, [int(i) for i in pick], ctl
