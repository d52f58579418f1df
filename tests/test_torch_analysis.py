"""graftlint and the runtime sanitizers of the PyTorch port
(``deeplearning4j_tpu_torch/analysis``), the cases of the JAX package's
``tests/test_analysis.py`` with each rule's PyTorch meaning.

- STATIC: each rule is fed sources seeded with its bug class in PyTorch
  form (a readback in a hot path, a ``torch.from_numpy`` alias of a mutated
  buffer, a threefry key drawn twice, a guarded attribute outside its lock,
  a compile or kernel build per call) and must flag it AND stay quiet on
  the blessed idiom beside it. ``lock-discipline`` is language-neutral: on
  the same sources (the synthetic ones and every port serving module) it
  gives the reference rule's findings. Plus the baseline mechanics, the
  lint CLI's exit codes and the meta-test: the port lints clean.
- RUNTIME: each sanitizer is fed a seeded violation (lock-order inversion,
  unlocked cross-thread write, a readback inside dispatch, an in-flight
  buffer mutation, an out-of-family program key) and must report it, on a
  CPU engine; the disabled path is the production path (raw locks,
  pristine torch methods).
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import rules as ref_rules
from deeplearning4j_tpu.analysis.core import ModuleInfo as RefModuleInfo
from deeplearning4j_tpu_torch.analysis.baseline import Baseline
from deeplearning4j_tpu_torch.analysis.core import ModuleInfo
from deeplearning4j_tpu_torch.analysis.lint import (
    default_root,
    lint_paths,
    main as lint_main,
)
from deeplearning4j_tpu_torch.analysis.rules import run_rules
from deeplearning4j_tpu_torch.analysis.sanitizers import (
    CompileCountGuard,
    LockSanitizer,
    SanitizerViolation,
    SyncSanitizer,
    note_access,
    wrap_lock,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "deeplearning4j_tpu_torch"


def _findings(src, rules=None):
    return run_rules(ModuleInfo("synthetic.py", src, "synthetic.py"),
                     rules=rules)


def _rules_fired(src, rules=None):
    return [f.rule for f in _findings(src, rules)]


# -- rule: host-sync ------------------------------------------------------


def test_host_sync_flags_hot_path_only():
    src = '''
# lint: hot-path
def dispatch(x):
    return x.cpu()

def cold(x):
    return x.cpu()
'''
    fs = _findings(src, ["host-sync"])
    assert [f.qualname for f in fs] == ["dispatch"]


@pytest.mark.parametrize("expr", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "float(y)", "int(y)",
    "bool(x)", "np.asarray(x)", "np.array(x)", "torch.cuda.synchronize()",
    "ev.synchronize()", "x.nonzero()", "torch.nonzero(x)",
    "x.masked_select(m)", "torch.unique(x)", 'x.to("cpu")',
])
def test_host_sync_flags_each_readback(expr):
    src = f'''
import numpy as np
import torch

# lint: hot-path
def f(x, y, m, ev):
    return {expr}
'''
    assert _rules_fired(src, ["host-sync"]) == ["host-sync"]


@pytest.mark.parametrize("expr", [
    "np.asarray([1, 2])", "np.zeros(4)", "int(len(x))", "float(3)",
    'x.to("cuda", non_blocking=True)', "x.float()",
    "host.copy_(x, non_blocking=True)",
])
def test_host_sync_quiet_on_host_values(expr):
    src = f'''
import numpy as np

# lint: hot-path
def f(x, host):
    return {expr}
'''
    assert _findings(src, ["host-sync"]) == []


def test_host_sync_sync_ok_suppresses():
    src = '''
# lint: hot-path
def process(horizon):
    horizon.event.synchronize()  # lint: sync-ok the designated readback
    return horizon.toks.numpy()  # lint: sync-ok host tensor
'''
    assert _findings(src, ["host-sync"]) == []


def test_host_sync_follows_helpers_in_the_module():
    src = '''
class Engine:
    # lint: hot-path
    def step(self):
        return self._helper()

    def _helper(self):
        return self._deeper()

    def _deeper(self):
        return self.t.item()
'''
    fs = _findings(src, ["host-sync"])
    assert [f.qualname for f in fs] == ["Engine.step"]
    assert "Engine._helper" in fs[0].message and ".item()" in fs[0].message


# -- rule: zero-copy-alias ------------------------------------------------


def test_alias_flags_mutation_after_from_numpy():
    src = '''
import numpy as np
import torch

def f(fn, seq):
    buf = np.zeros((8,), np.int32)
    fn(torch.from_numpy(buf))
    buf[0] = 1
'''
    assert _rules_fired(src, ["zero-copy-alias"]) == ["zero-copy-alias"]


def test_alias_flags_buffer_hoisted_out_of_loop():
    # one buffer uploaded and mutated every iteration: on the CPU the
    # tensor of iteration N is the buffer iteration N+1 writes
    src = '''
import numpy as np

def g(fn, n, dev):
    pos = np.zeros((4,), np.int32)
    for j in range(n):
        fn(upload(pos, dev))
        pos[0] += 1
'''
    assert _rules_fired(src, ["zero-copy-alias"]) == ["zero-copy-alias"]


def test_alias_fresh_buffer_per_iteration_is_clean():
    src = '''
import numpy as np
import torch

def g(fn, chunks):
    for seq in chunks:
        pad = np.zeros((1, 8), np.int64)
        pad[0, :len(seq)] = seq
        fn(torch.as_tensor(pad))
'''
    assert _findings(src, ["zero-copy-alias"]) == []


def test_alias_defensive_copy_is_clean():
    src = '''
import numpy as np
import torch

def g(fn, n):
    pos = np.zeros((4,), np.int32)
    for j in range(n):
        fn(torch.from_numpy(pos.copy()))
        pos[0] += 1
'''
    assert _findings(src, ["zero-copy-alias"]) == []


def test_alias_class_attribute_variant():
    src = '''
class Engine:
    def seat(self, slot, kd):
        self.keys[slot] = kd

    def dispatch(self, fn):
        return fn(self._upload(self.keys))

    def dispatch_safe(self, fn):
        return fn(self._upload(self.keys.copy()))
'''
    fs = _findings(src, ["zero-copy-alias"])
    assert [f.qualname for f in fs] == ["Engine.dispatch"]


def test_alias_ok_suppresses():
    src = '''
import torch

def f(fn, buf):
    fn(torch.from_numpy(buf))  # lint: alias-ok caller guarantees no writes
    buf[0] = 1
'''
    assert _findings(src, ["zero-copy-alias"]) == []


# -- rule: prng-reuse -----------------------------------------------------


def test_prng_flags_double_consume():
    src = '''
from deeplearning4j_tpu_torch.ops import threefry

def f(logits):
    k = threefry.split(threefry.key(0), 2)[0]
    a = threefry.uniform(k, (4,))
    b = threefry.uniform(k, (4,))
    return a, b
'''
    assert _rules_fired(src, ["prng-reuse"]) == ["prng-reuse"]


def test_prng_split_between_sinks_is_clean():
    src = '''
from deeplearning4j_tpu_torch import rng

def f(model, x, key):
    key, k1 = rng.split(key)
    a = model(x, k1)
    key, k2 = rng.split(key)
    b = model(x, k2)
    return a, b
'''
    assert _findings(src, ["prng-reuse"]) == []


def test_prng_fold_in_derives():
    src = '''
from deeplearning4j_tpu_torch.ops import threefry

def f(model, x, key):
    k = threefry.key(3)
    a = model(x, threefry.fold_in(k, 1))
    b = model(x, threefry.fold_in(k, 2))
    return a, b
'''
    assert _findings(src, ["prng-reuse"]) == []


def test_prng_exclusive_branches_are_clean():
    src = '''
from deeplearning4j_tpu_torch.ops import threefry

def f(model, x, flag):
    k = threefry.split(threefry.key(0), 2)[1]
    if flag:
        return model(x, k)
    else:
        return model(x * 2, k)
'''
    assert _findings(src, ["prng-reuse"]) == []


def test_prng_outer_key_consumed_in_loop_flags():
    src = '''
from deeplearning4j_tpu_torch import rng

def f(model, xs):
    k = rng.key_for(0)
    out = []
    for x in xs:
        out.append(model(x, k))
    return out
'''
    assert _rules_fired(src, ["prng-reuse"]) == ["prng-reuse"]


def test_prng_ok_suppresses():
    src = '''
from deeplearning4j_tpu_torch.ops import threefry

def f(model, x):
    k = threefry.key(0)
    a = model(x, k)
    b = model(x, k)  # lint: prng-ok correlated on purpose
    return a, b
'''
    assert _findings(src, ["prng-reuse"]) == []


# -- rule: lock-discipline ------------------------------------------------

_LOCK_SRC = '''
import threading

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._free = []  # guarded-by: _lock

    def bad(self):
        return len(self._free)

    def good(self):
        with self._lock:
            return len(self._free)

    def helper(self):  # lint: holds _lock
        return self._free.pop()

    # lint: holds _lock
    def helper_above(self):
        return self._free.pop()
'''

_LOCK_OK_SRC = '''
import threading

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._free = []  # guarded-by: _lock

    def snapshot(self):
        return list(self._free)  # lint: lock-ok read-only debug dump
'''


def test_lock_discipline_guarded_by():
    fs = _findings(_LOCK_SRC, ["lock-discipline"])
    assert [f.qualname for f in fs] == ["Pool.bad"]


def test_lock_ok_suppresses():
    assert _findings(_LOCK_OK_SRC, ["lock-discipline"]) == []


def _lock_view(findings):
    return [(f.line, f.col, f.qualname, f.message, f.snippet)
            for f in findings]


@pytest.mark.parametrize(
    "rel",
    ["<synthetic>", "<synthetic-ok>"] + sorted(
        str(p.relative_to(ROOT)) for p in
        list((PKG / "serving").glob("*.py")) + [PKG / "obs" / "registry.py"]),
)
def test_lock_discipline_equals_the_reference_rule(rel):
    """The language-neutral rule gives the reference rule's findings on
    the same source, line for line."""
    src = {"<synthetic>": _LOCK_SRC, "<synthetic-ok>": _LOCK_OK_SRC}.get(rel)
    if src is None:
        src = (ROOT / rel).read_text()
    mine = ModuleInfo(rel, src, rel)
    theirs = RefModuleInfo(rel, src, rel)
    from deeplearning4j_tpu_torch.analysis.rules import check_lock_discipline

    assert _lock_view(check_lock_discipline(mine)) == _lock_view(
        ref_rules.check_lock_discipline(theirs))


# -- rule: retrace-hazard -------------------------------------------------


def test_retrace_flags_immediate_compile_and_loop():
    src = '''
import torch

def serve(fns, xs):
    out = [torch.compile(fns[0])(xs[0])]
    for f in fns:
        g = torch.compile(f)
        out.append(g(xs[0]))
    return out

class E:
    def __init__(self, f):
        self._fn = torch.compile(f)
'''
    fs = _findings(src, ["retrace-hazard"])
    assert len(fs) == 2  # immediate call + compile-in-loop; __init__ exempt
    assert all(f.qualname == "serve" for f in fs)


def test_retrace_flags_kernel_build_and_capture_on_a_hot_path():
    src = '''
import torch
from deeplearning4j_tpu_torch.ops import _build

# lint: hot-path
def step(x):
    _build.build_all()
    g = torch.cuda.CUDAGraph()
    return x

def warmup():
    _build.build_all()
'''
    fs = _findings(src, ["retrace-hazard"])
    assert [f.qualname for f in fs] == ["step", "step"]


def test_retrace_ok_suppresses():
    src = '''
import torch

def probe(f, x):
    return torch.compile(f)(x)  # lint: retrace-ok one-shot probe
'''
    assert _findings(src, ["retrace-hazard"]) == []


# -- finding keys + baseline ----------------------------------------------

_HOT_SRC = '''
# lint: hot-path
def f(x):
    return x.item()
'''


def test_finding_key_is_line_number_independent():
    (f1,) = _findings(_HOT_SRC, ["host-sync"])
    (f2,) = _findings("\n\n\n" + _HOT_SRC, ["host-sync"])
    assert f1.line != f2.line
    assert f1.key == f2.key


def test_baseline_roundtrip_and_stale(tmp_path):
    (f1,) = _findings(_HOT_SRC, ["host-sync"])
    path = tmp_path / "lint_baseline.json"
    bl = Baseline(str(path))
    bl.write([f1])
    data = json.loads(path.read_text())
    assert data["version"] == 1
    assert data["accepted"][0]["key"] == f1.key
    assert data["accepted"][0]["reason"].startswith("TODO")
    bl2 = Baseline(str(path))
    new, suppressed, stale = bl2.split([f1])
    assert (new, len(suppressed), stale) == ([], 1, [])
    # the site disappears -> its entry goes stale
    new, suppressed, stale = bl2.split([])
    assert stale == [f1.key]


def test_lint_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("# lint: hot-path\ndef f(x):\n    return x.item()\n")
    bl = tmp_path / "bl.json"
    assert lint_main([str(bad), "--no-baseline"]) == 1
    assert "[host-sync] .item()" in capsys.readouterr().out
    assert lint_main([str(bad), "--baseline", str(bl),
                      "--write-baseline"]) == 0
    # baselined -> clean; --strict still fails on the TODO reason
    assert lint_main([str(bad), "--baseline", str(bl)]) == 0
    assert lint_main([str(bad), "--baseline", str(bl), "--strict"]) == 1
    data = json.loads(bl.read_text())
    data["accepted"][0]["reason"] = "probe path, built once"
    bl.write_text(json.dumps(data))
    assert lint_main([str(bad), "--baseline", str(bl), "--strict"]) == 0
    assert lint_main([str(bad), "--rules", "no-such-rule"]) == 2


def test_lint_subcommand_in_a_fresh_process(tmp_path):
    """``python -m deeplearning4j_tpu_torch lint --strict`` exits 0 on the
    port; a seeded violation with ``--no-baseline`` exits 1 and prints
    the finding."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    cli = [sys.executable, "-m", "deeplearning4j_tpu_torch", "lint"]
    out = subprocess.run(cli + ["--strict"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "graftlint: 0 finding(s)" in out.stdout
    bad = tmp_path / "engine_like.py"
    bad.write_text("class E:\n    # lint: hot-path\n    def _dispatch(self):"
                   "\n        return self.toks.tolist()\n")
    out = subprocess.run(cli + [str(bad), "--no-baseline"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1
    assert "[host-sync] .tolist() in hot-path function 'E._dispatch'" in (
        out.stdout)


def test_port_lints_clean():
    """The load-bearing meta-test: the port package has no unaccepted
    findings under all five rules (``lint --strict`` runs the same
    check), and the seven hot paths are marked."""
    findings, errors = lint_paths([default_root()])
    assert errors == []
    assert [f.render() for f in findings] == []
    src = (PKG / "serving" / "engine.py").read_text()
    mod = ModuleInfo("engine.py", src)
    from deeplearning4j_tpu_torch.analysis.core import iter_functions

    hot = sorted(q for fn, q in iter_functions(mod.tree)
                 if mod.def_directive(fn, "hot-path") is not None)
    assert hot == sorted(f"ServingEngine.{n}" for n in (
        "_sweep_lifecycle", "_admit", "_execute_plans", "_dispatch",
        "_process", "step", "_seat"))


def test_default_root_is_the_port():
    assert Path(default_root()).name == "deeplearning4j_tpu_torch"


# -- sanitizers: disabled path --------------------------------------------

_PATCHED = ("item", "tolist", "numpy", "__array__", "__bool__", "cpu", "to",
            "copy_")


def test_disabled_sanitizers_cost_nothing():
    """With no sanitizer installed, wrap_lock is the identity, torch's
    readback methods are the pristine ones and note_access is a no-op;
    install patches them, uninstall restores the exact originals."""
    lock = threading.Lock()
    assert wrap_lock(lock, "x") is lock
    orig = {n: getattr(torch.Tensor, n) for n in _PATCHED}
    own = {n: n in torch.Tensor.__dict__ for n in _PATCHED}
    sync = torch.cuda.synchronize
    note_access("anything", write=True)  # must not record or raise
    san = SyncSanitizer(devices=("cpu",)).install()
    try:
        assert all(getattr(torch.Tensor, n) is not orig[n] for n in _PATCHED)
        assert torch.cuda.synchronize is not sync
    finally:
        san.uninstall()
    assert all(getattr(torch.Tensor, n) is orig[n] for n in _PATCHED)
    assert {n: n in torch.Tensor.__dict__ for n in _PATCHED} == own
    assert torch.cuda.synchronize is sync
    assert wrap_lock(lock, "x") is lock


# -- sanitizers: seeded violations ----------------------------------------


def test_lock_sanitizer_reports_order_inversion():
    with LockSanitizer() as san:
        a = wrap_lock(threading.Lock(), "a")
        b = wrap_lock(threading.Lock(), "b")
        with a:
            with b:
                pass
        with b:
            with a:  # closes the a->b->a cycle
                pass
    assert any("lock-order inversion" in v for v in san.violations)
    with pytest.raises(SanitizerViolation):
        san.assert_clean()


def test_lock_sanitizer_consistent_order_is_clean():
    with LockSanitizer() as san:
        a = wrap_lock(threading.Lock(), "a")
        b = wrap_lock(threading.Lock(), "b")
        for _ in range(3):
            with a:
                with b:
                    pass
    san.assert_clean()


def test_lock_sanitizer_reports_unlocked_cross_thread_write():
    with LockSanitizer() as san:
        def writer():
            note_access("shared.table", write=True)

        t = threading.Thread(target=writer, name="other-writer")
        t.start()
        t.join()
        note_access("shared.table", write=True)
    assert any("shared.table" in v for v in san.violations)


def test_lock_sanitizer_single_writer_is_clean():
    with LockSanitizer() as san:
        for _ in range(5):
            note_access("swmr.value", write=True)
    san.assert_clean()


def test_sync_sanitizer_budget_and_phases():
    x = torch.arange(4)
    san = SyncSanitizer(budgets={"dispatch": 0}, devices=("cpu",)).install()
    try:
        san.set_phase("process")
        san.note_horizon()
        x.numpy()  # the designated readback
        np.asarray(np.arange(4))  # plain numpy: no tensor, no sync
        san.set_phase("dispatch")
        int(x[1])  # over budget
    finally:
        san.uninstall()
    assert san.sync_count("process") == 1
    assert san.sync_count("dispatch") == 1
    assert any("dispatch" in v for v in san.violations)
    with pytest.raises(SanitizerViolation):
        san.assert_budgets()


def test_sync_sanitizer_per_horizon_budget():
    x = torch.arange(4)
    san = SyncSanitizer(devices=("cpu",)).install()
    try:
        san.set_phase("process")
        san.note_horizon()
        x.numpy()
        x.tolist()  # a second readback in one horizon
    finally:
        san.uninstall()
    assert san.sync_count("process") == 2 and san.horizons == 1
    assert any("exceeds budget 1" in v for v in san.violations)


def test_sync_sanitizer_counts_only_the_watched_device():
    x = torch.arange(4)
    san = SyncSanitizer().install()  # the card's readbacks only
    try:
        san.set_phase("dispatch")
        x.tolist()
        float(x[0])
        np.asarray(x)
    finally:
        san.uninstall()
    assert san.counts == {} and san.violations == []


def test_sync_sanitizer_alias_tripwire():
    san = SyncSanitizer()
    buf = np.arange(8, dtype=np.int64)
    san.track("dispatch.keys", buf)
    san.check("dispatch.keys")
    assert san.violations == []
    san.track("dispatch.keys", buf)
    buf[3] = 99  # mutated while "in flight"
    san.check("dispatch.keys")
    assert any("in flight" in v for v in san.violations)


# -- sanitizers: engine integration ---------------------------------------


@pytest.fixture(scope="module")
def tiny_serving():
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1,
                            d_ff=64, max_len=48)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(cfg, params, **kw):
    from deeplearning4j_tpu_torch.serving import ServingEngine

    kw.setdefault("n_slots", 2)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("decode_horizon", 2)
    kw.setdefault("prefill_max_bucket", 16)
    return ServingEngine(cfg, params, device="cpu", **kw)


def _reqs(n, seed=0, lengths=None):
    from deeplearning4j_tpu_torch.serving import Request

    rng = np.random.default_rng(seed)
    lengths = lengths or [int(rng.integers(3, 8)) for _ in range(n)]
    return [Request(id=f"r{i}", prompt=rng.integers(1, 60, (m,))
                    .astype(np.int32), max_new=int(rng.integers(3, 8)))
            for i, m in enumerate(lengths)]


def _armed_run(cfg, params, reqs, **kw):
    lock_san = LockSanitizer().install()
    sync_san = SyncSanitizer(devices=("cpu",)).install()
    try:
        eng = _engine(cfg, params, **kw)
        eng.attach_sanitizer(sync_san)
        for r in reqs:
            eng.submit(r)
        results = eng.run()
    finally:
        sync_san.uninstall()
        lock_san.uninstall()
    return eng, results, lock_san, sync_san


def test_engine_clean_under_all_sanitizers(tiny_serving):
    """A serve run with every sanitizer armed: no readback inside the
    dispatch critical section, one readback per processed horizon,
    untouched dispatch buffers, program keys inside their families, no
    lock findings — and the same streams as the run without them."""
    cfg, params = tiny_serving
    eng, results, lock_san, sync_san = _armed_run(
        cfg, params, _reqs(4), temperature=0.8)
    assert len(results) == 4
    lock_san.assert_clean()
    sync_san.assert_clean()
    sync_san.assert_budgets()
    assert sync_san.sync_count("dispatch") == 0
    assert 1 <= sync_san.sync_count("process") <= sync_san.horizons
    CompileCountGuard(eng).assert_ok()
    assert lock_san.n_wrapped > 0  # the stack's locks went through wrap_lock
    plain = _engine(cfg, params, temperature=0.8)
    for r in _reqs(4):
        plain.submit(r)
    assert {k: v.tolist() for k, v in plain.run().items()} == {
        k: v.tolist() for k, v in results.items()}


def test_engine_seeded_lock_order_inversion_is_caught(tiny_serving):
    """The engine's scheduler lock and results lock taken in both orders
    from two threads: the order graph closes a cycle."""
    cfg, params = tiny_serving
    with LockSanitizer() as san:
        eng = _engine(cfg, params)

        def one():
            with eng.scheduler._lock:
                with eng._results_lock:
                    pass

        def other():
            with eng._results_lock:
                with eng.scheduler._lock:
                    pass

        for fn in (one, other):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
    assert any("lock-order inversion" in v and "engine.results" in v
               for v in san.violations)


def test_engine_seeded_sync_inside_dispatch_is_caught(tiny_serving,
                                                      monkeypatch):
    """A readback planted in the step dispatch is counted in the
    dispatch phase and breaks its zero budget."""
    cfg, params = tiny_serving
    from deeplearning4j_tpu_torch.serving import ServingEngine

    real = ServingEngine._run_step

    def syncing(self, k):
        toks = real(self, k)
        toks.sum().item()  # the planted sync
        return toks

    monkeypatch.setattr(ServingEngine, "_run_step", syncing)
    _, results, _, sync_san = _armed_run(cfg, params, _reqs(2))
    assert len(results) == 2
    assert sync_san.sync_count("dispatch") >= 1
    assert any("phase 'dispatch'" in v for v in sync_san.violations)
    with pytest.raises(SanitizerViolation):
        sync_san.assert_budgets()


def test_engine_seeded_alias_mutation_is_caught(tiny_serving):
    """Mutate the host key words the in-flight horizon consumed: the
    readback's integrity check fires."""
    cfg, params = tiny_serving
    sync_san = SyncSanitizer(devices=("cpu",)).install()
    try:
        eng = _engine(cfg, params, temperature=0.8)
        eng.attach_sanitizer(sync_san)
        eng.submit(_reqs(1, seed=3)[0])
        eng.step()  # admit + dispatch: tracks the key snapshot
        tracked = sync_san._tracked.get("dispatch.slot_keys")
        assert tracked  # one outstanding dispatch
        buf, _snap = tracked[0]
        buf[...] += 1  # a concurrent writer corrupts the in-flight buffer
        eng.step()  # processes the previous horizon -> check() fires
    finally:
        sync_san.uninstall()
    assert any("in flight" in v for v in sync_san.violations)


def test_compile_count_guard_after_mixed_prompt_lengths(tiny_serving):
    """Prompts from 1 to 40 tokens (buckets 8 and 16, chunked past 16,
    batched same-bucket admissions) key programs inside the families; a
    planted request-shaped key is caught."""
    cfg, params = tiny_serving
    eng = _engine(cfg, params, n_slots=4, adaptive_horizon=True)
    for r in _reqs(8, seed=5, lengths=[1, 3, 8, 9, 15, 16, 17, 40]):
        eng.submit(r)
    eng.run()
    keys = eng.program_keys
    assert keys["prefill"] <= {8, 16} and keys["chunk"] <= {8, 16}
    assert keys["chunk"] and keys["step"] <= {1, 2}
    guard = CompileCountGuard(eng)
    guard.assert_ok()
    allowed = guard.allowed()
    assert allowed["prefill"] == {8, 16} and allowed["step"] == {1, 2}
    keys["step"].add(7)  # a request-shaped key: the retrace bug class
    with pytest.raises(SanitizerViolation):
        guard.assert_ok()
    keys["step"].discard(7)
    keys["prefill"].add(13)  # off the pow2 bucket grid
    with pytest.raises(SanitizerViolation):
        guard.assert_ok()
    keys["prefill"].discard(13)
    keys["batch_prefill"].add((8, 3))  # not a pow2 group
    with pytest.raises(SanitizerViolation):
        guard.assert_ok()


# -- regressions the reference's suite carries ----------------------------


def test_scheduler_len_is_locked_and_consistent():
    from deeplearning4j_tpu_torch.serving import RequestScheduler

    s = RequestScheduler(max_queue_depth=64)
    for r in _reqs(8, seed=1):
        s.submit(r)
    assert len(s) == 8
    errs = []

    def hammer(seed):
        try:
            for r in _reqs(16, seed=seed):
                s.submit(r)
                len(s)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=hammer, args=(i,)) for i in (2, 3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert errs == []
    assert len(s) == 8 + 32


def test_registry_scrape_survives_concurrent_labelset_inserts():
    from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    c = reg.counter("hits_total", labelnames=("k",))
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0), labelnames=("k",))
    stop = threading.Event()
    errs = []

    def scraper():
        try:
            while not stop.is_set():
                reg.render()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=scraper, name="metrics-serve")
    t.start()
    try:
        for i in range(300):
            c.inc(k=str(i))
            h.observe(0.05, k=str(i))
    finally:
        stop.set()
        t.join()
    assert errs == []
    assert "hits_total" in reg.render()


def test_router_locks_are_sanitizer_clean_under_mark_unhealthy():
    """The router's health flip path under the LockSanitizer: its route
    lock is wrapped, the flip is noted under it, no inversion."""
    from deeplearning4j_tpu_torch.serving.router import ReplicaRouter

    with LockSanitizer() as san:
        router = ReplicaRouter([("127.0.0.1", 1), ("127.0.0.1", 2)])
        try:
            t = threading.Thread(
                target=router._mark_unhealthy,
                args=(router.replicas[0], "from poller"),
                name="health-poll")
            t.start()
            t.join()
            router._mark_unhealthy(router.replicas[0], "seeded again")
            states = router.replica_states()
            assert states[router.replicas[0].name]["healthy"] is False
        finally:
            router._httpd.server_close()
    assert san.n_wrapped >= 2
    san.assert_clean()


def test_serve_sanitize_cli_on_the_cpu(tmp_path):
    """``serve --sanitize --device cpu``: greedy and sampled requests, then
    SIGTERM; the summary line carries the sync counts (no ``dispatch``
    entry, process syncs within the horizons) and ``sanitizers: clean``,
    exit 0; the streams equal the run without ``--sanitize``."""
    import signal
    import time
    import urllib.request

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)

    def run(extra):
        pf = tmp_path / f"pf{len(extra)}.json"
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "deeplearning4j_tpu_torch", "serve",
             "--demo", "--device", "cpu", "--port", "0", "--port-file",
             str(pf), "--d-model", "32", "--n-layers", "1", "--n-heads",
             "2", "--seq-len", "48", "--slots", "3", "--temperature", "0",
             "--probe-cache", "off", "--sampling-surface", *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            t0 = time.time()
            while not pf.exists():
                assert proc.poll() is None and time.time() - t0 < 120
                time.sleep(0.1)
            time.sleep(0.1)
            port = json.loads(pf.read_text())["port"]

            def post(body):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/generate",
                    data=json.dumps(body).encode(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    return json.loads(r.read())["tokens"]

            streams = [post({"prompt": [1, 2, 3, 4, 5], "max_new": 5}),
                       post({"prompt": list(range(1, 20)), "max_new": 5}),
                       post({"prompt": [7, 8, 9], "max_new": 5,
                             "temperature": 0.8})]
        finally:
            proc.send_signal(signal.SIGTERM)
            out = proc.communicate(timeout=120)[0]
        return streams, proc.returncode, out

    streams, rc, out = run(["--sanitize"])
    assert rc == 0, out
    assert "sanitizers: lock + sync active" in out
    assert "sanitizers: clean" in out, out
    line = next(x for x in out.splitlines() if "locks tracked" in x)
    assert "dispatch" not in line
    import ast

    counts = ast.literal_eval(line.split("sync counts ")[1].split("}")[0]
                              + "}")
    horizons = int(line.rsplit("horizons ", 1)[1])
    assert 1 <= counts["process"] <= horizons
    plain, rc2, out2 = run([])
    assert rc2 == 0 and "sanitizers" not in out2
    assert plain == streams
