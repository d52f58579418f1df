"""Opt-in runtime sanitizers for the serving stack (the port's versions of
``deeplearning4j_tpu/analysis/sanitizers.py``).

Three detectors, each targeting a bug class the serving stack can hit, all
ZERO-COST when off (the disabled path is one module-global ``None``
check, and nothing is wrapped or patched unless a sanitizer is
installed):

- :class:`LockSanitizer` — Eraser/ThreadSanitizer-style lockset
  tracking plus lock-order cycle detection across the engine / HTTP /
  metrics / health threads (a copy of the reference's). Serving modules
  create their locks through :func:`wrap_lock`, which is the identity
  while no sanitizer is installed and returns an instrumented proxy while
  one is; writes to shared structures report through :func:`note_access`
  and are checked with a single-writer lockset discipline (two writer
  threads with no common lock -> violation; GIL-atomic
  single-writer/multi-reader patterns are deliberately NOT flagged).
- :class:`SyncSanitizer` — counts device->host syncs per engine phase by
  patching torch's readback entry points while installed (below), with
  per-phase budgets: zero inside the dispatch critical section, one
  designated readback per horizon in the process phase. Also carries the
  zero-copy-alias tripwire: the engine registers the exact host buffer
  each dispatch consumed (:meth:`SyncSanitizer.track`) and the readback
  verifies the bytes did not change while the horizon was in flight.
- :class:`CompileCountGuard` — the engine's program-surface contract
  after (or during) a serve run: the engine records each family's shape
  key at dispatch (one set-add, ``ServingEngine.program_keys``);
  prefill/chunk keys must stay on the power-of-two bucket grid
  (O(log max_len) of them), step keys within {1, K}, batched admission
  within the (bucket, pow2 group) grid. The dynamic complement of the
  static ``retrace-hazard`` rule.

The sync mechanism. While installed, the sanitizer wraps the Python entry
points through which a value leaves a tensor for the host:
``Tensor.item``, ``tolist``, ``numpy``, ``__array__`` (``np.asarray``),
``__bool__``, ``__float__``, ``__int__``, ``__index__``, ``cpu``, a
blocking ``Tensor.to``/``copy_`` from the card to the host, the
data-sized ``nonzero``, and ``torch.cuda.synchronize`` with the
``synchronize`` of CUDA events and streams. A tensor readback counts when
the tensor lies on a watched device type (``devices``: ``("cuda",)`` on
the card; ``("cpu",)`` for an engine on the CPU, where the same call
sites would sync on the card). The patches are class attributes, so they
see every thread; the phase is thread-local and set by the engine on its
own thread (a ``TorchDispatchMode`` would be thread-local itself, and it
would not see ``Event.synchronize``). What the patches cannot see: a sync
inside one ATen op (boolean-mask indexing, ``torch.unique`` on the card).

Nothing here imports torch or numpy at module level — detection is by
``sys.modules`` lookup — so importing this module (which every serving
module does for ``wrap_lock``) adds no dependency: the router and the
controller, which import no torch, patch nothing.
"""

from __future__ import annotations

import logging
import math
import sys
import threading
import traceback

_log = logging.getLogger(__name__)

#: the installed sanitizers (module globals so the disabled-path check
#: at call sites is a single load + None test)
_ACTIVE_LOCK: "LockSanitizer | None" = None
_ACTIVE_SYNC: "SyncSanitizer | None" = None

#: cap per sanitizer so a hot violation site cannot grow memory
_MAX_VIOLATIONS = 200


class SanitizerViolation(AssertionError):
    """Raised by ``assert_clean``/``assert_ok`` when a sanitizer
    recorded violations."""


def _caller() -> str:
    """file:line of the frame that triggered a detector (skipping
    sanitizer frames) — enough context to find the site, cheap enough
    to compute only on violation."""
    for frame in reversed(traceback.extract_stack(limit=12)[:-2]):
        if "analysis/sanitizers" not in frame.filename.replace("\\", "/"):
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


# -------------------------------------------------------------------- #
# LockSanitizer                                                        #
# -------------------------------------------------------------------- #


class _SanLock:
    """Lock proxy recording acquisition order and per-thread locksets.
    Delegates everything to the wrapped lock, so semantics (blocking,
    timeouts, ``with``) are unchanged."""

    __slots__ = ("_san", "_lock", "name")

    def __init__(self, san: "LockSanitizer", lock, name: str):
        self._san = san
        self._lock = lock
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._san._before_acquire(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._san._on_acquire(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        self._san._on_release(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class LockSanitizer:
    """Lockset tracking + lock-order cycle detection.

    ``install()`` makes :func:`wrap_lock` return instrumented proxies
    for locks created from then on (the serving stack creates its
    locks at construction, so install BEFORE building the engine/
    server/router). The order graph records an edge A->B whenever B is
    acquired while A is held; acquiring in an order that closes a
    cycle is reported immediately — a potential deadlock, caught
    without needing the interleaving that would actually deadlock.
    """

    def __init__(self):
        self._mu = threading.Lock()  # guards graph/violations/access
        self._tls = threading.local()
        self._edges: dict[str, set[str]] = {}
        self._access: dict[str, dict] = {}
        self.violations: list[str] = []
        self.n_wrapped = 0

    # -- lifecycle ----------------------------------------------------

    def install(self) -> "LockSanitizer":
        global _ACTIVE_LOCK
        _ACTIVE_LOCK = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE_LOCK
        if _ACTIVE_LOCK is self:
            _ACTIVE_LOCK = None

    def __enter__(self) -> "LockSanitizer":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- wrapping -----------------------------------------------------

    def wrap(self, lock, name: str) -> _SanLock:
        self.n_wrapped += 1
        return _SanLock(self, lock, name)

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _before_acquire(self, name: str) -> None:
        """Order check happens BEFORE blocking on the lock, so a cycle
        is reported even when the acquisition would deadlock."""
        held = self._held()
        if not held:
            return
        with self._mu:
            for h in held:
                if h == name:
                    continue
                edges = self._edges.setdefault(h, set())
                if name in edges:
                    continue
                edges.add(name)
                if self._reaches(name, h):
                    self._violate(
                        f"lock-order inversion: acquiring {name!r} while "
                        f"holding {h!r} at {_caller()}, but the opposite "
                        f"order {name!r} -> ... -> {h!r} was observed "
                        f"earlier — potential deadlock"
                    )

    def _on_acquire(self, name: str) -> None:
        self._held().append(name)

    def _on_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    def _reaches(self, src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    # -- shared-write discipline (Eraser lockset, single-writer) ------

    def note_access(self, key: str, write: bool = False) -> None:
        """Report an access to a named shared structure. Only writes
        are checked: two writer THREADS with an empty common lockset is
        a violation; single-writer/multi-reader under the GIL is not
        (flagging it would drown the report in benign races this
        codebase relies on)."""
        if not write:
            return
        held = frozenset(self._held())
        tid = threading.get_ident()
        with self._mu:
            e = self._access.setdefault(
                key, {"lockset": None, "writers": {}, "reported": False}
            )
            e["writers"][tid] = threading.current_thread().name
            e["lockset"] = (set(held) if e["lockset"] is None
                            else e["lockset"] & held)
            if (len(e["writers"]) >= 2 and not e["lockset"]
                    and not e["reported"]):
                e["reported"] = True
                self._violate(
                    f"unlocked write race on {key!r}: written by threads "
                    f"{sorted(e['writers'].values())} with no common lock "
                    f"held (last write at {_caller()})"
                )

    # -- reporting ----------------------------------------------------

    def _violate(self, msg: str) -> None:
        if len(self.violations) < _MAX_VIOLATIONS:
            self.violations.append(msg)
        _log.error("LockSanitizer: %s", msg)

    def lock_order_edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def report(self) -> str:
        return "\n".join(self.violations) or "LockSanitizer: clean"

    def assert_clean(self) -> None:
        if self.violations:
            raise SanitizerViolation(self.report())


# -------------------------------------------------------------------- #
# SyncSanitizer                                                        #
# -------------------------------------------------------------------- #

#: tensor methods that hand a tensor's values to the host
_READBACKS = ("item", "tolist", "numpy", "__array__", "__bool__",
              "__float__", "__int__", "__index__", "cpu", "nonzero")


def _to_host(args, kwargs) -> bool:
    """Does ``Tensor.to(*args, **kwargs)`` name the CPU, blocking?"""
    if kwargs.get("non_blocking") or (len(args) > 1 and args[1] is True):
        return False
    dev = kwargs.get("device", args[0] if args else None)
    return str(dev).startswith("cpu") if dev is not None else False


class SyncSanitizer:
    """Count device->host syncs per engine phase, enforce budgets, and
    verify dispatch-consumed host buffers stay unchanged while their
    horizon is in flight.

    ``install()`` patches torch's readback entry points (the module
    docstring lists them) with wrappers that note the call and attribute
    it to the current thread's engine phase (set by the engine via
    :meth:`set_phase` when a sanitizer is attached); ``uninstall()``
    restores them. Budgets: a phase mapped to ``N`` in ``budgets``
    tolerates at most N syncs for the sanitizer's lifetime, and one in
    ``per_horizon`` at most N for every horizon the engine processed
    (:meth:`note_horizon`); unmapped phases are counted, unbudgeted.
    Defaults: ``{"dispatch": 0}`` — the critical section must never
    block — and ``{"process": 1}``, the designated readback.
    """

    def __init__(self, budgets: dict[str, int] | None = None,
                 per_horizon: dict[str, int] | None = None,
                 devices=("cuda",)):
        self.budgets = dict(budgets) if budgets is not None else {
            "dispatch": 0,
        }
        self.per_horizon = (dict(per_horizon) if per_horizon is not None
                            else {"process": 1})
        self.devices = frozenset(devices)
        self._mu = threading.Lock()
        self._tls = threading.local()
        self.counts: dict[str, int] = {}
        self.horizons = 0
        self.violations: list[str] = []
        self._tracked: dict[str, list] = {}  # name -> FIFO of (buf, snapshot)
        self._orig: list | None = None
        self.active = False

    # -- lifecycle ----------------------------------------------------

    def install(self) -> "SyncSanitizer":
        global _ACTIVE_SYNC
        torch = sys.modules.get("torch")
        if self._orig is None and torch is not None:
            self._orig = self._patch(torch)
        self.active = True
        _ACTIVE_SYNC = self
        return self

    def _patch(self, torch) -> list:
        """Wrap the readback entry points; returns what restores them
        (owner, attribute, the owner's own attribute or None)."""
        san = self
        saved = []

        def swap(owner, name, make):
            orig = getattr(owner, name)
            saved.append((owner, name, owner.__dict__.get(name)))
            setattr(owner, name, make(orig))

        def tensor_method(name):
            def make(orig):
                def wrapper(self, *a, **kw):
                    if self.device.type in san.devices:
                        san._note(name)
                    return orig(self, *a, **kw)
                return wrapper
            return make

        for name in _READBACKS:
            swap(torch.Tensor, name, tensor_method(name))

        def make_to(orig):
            def to(self, *a, **kw):
                if self.device.type == "cuda" and _to_host(a, kw):
                    san._note("to(cpu)")
                return orig(self, *a, **kw)
            return to

        def make_copy(orig):
            def copy_(self, src, non_blocking=False):
                if (not non_blocking and self.device.type == "cpu"
                        and src.device.type == "cuda"):
                    san._note("copy_(d2h)")
                return orig(self, src, non_blocking)
            return copy_

        def make_sync(what):
            def make(orig):
                def sync(*a, **kw):
                    san._note(what)
                    return orig(*a, **kw)
                return sync
            return make

        swap(torch.Tensor, "to", make_to)
        swap(torch.Tensor, "copy_", make_copy)
        swap(torch, "nonzero", tensor_method("nonzero"))
        cuda = torch.cuda
        swap(cuda, "synchronize", make_sync("cuda.synchronize"))
        swap(cuda.Event, "synchronize", make_sync("event.synchronize"))
        swap(cuda.Stream, "synchronize", make_sync("stream.synchronize"))
        return saved

    def uninstall(self) -> None:
        global _ACTIVE_SYNC
        self.active = False
        if self._orig is not None:
            for owner, name, own in reversed(self._orig):
                if own is None:
                    delattr(owner, name)
                else:
                    setattr(owner, name, own)
            self._orig = None
        if _ACTIVE_SYNC is self:
            _ACTIVE_SYNC = None

    def __enter__(self) -> "SyncSanitizer":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- phase + counting ---------------------------------------------

    def set_phase(self, phase: str | None) -> None:
        self._tls.phase = phase

    @property
    def phase(self) -> str | None:
        return getattr(self._tls, "phase", None)

    def note_horizon(self) -> None:
        """One horizon's readback is about to happen (the engine calls
        this at the top of its process phase)."""
        with self._mu:
            self.horizons += 1

    def _note(self, what: str) -> None:
        if not self.active or getattr(self._tls, "busy", False):
            return
        # re-entrancy guard: a readback entry point may call another
        # (``__array__`` calls ``numpy``)
        self._tls.busy = True
        try:
            ph = self.phase or "unphased"
            with self._mu:
                n = self.counts.get(ph, 0) + 1
                self.counts[ph] = n
                budget = self.budgets.get(ph)
                per = self.per_horizon.get(ph)
                if per is not None:
                    budget = per * self.horizons
            if budget is not None and n > budget:
                self._violate(
                    f"blocking device->host sync ({what}) in phase {ph!r} "
                    f"at {_caller()}: count {n} exceeds budget {budget}"
                )
        finally:
            self._tls.busy = False

    def sync_count(self, phase: str) -> int:
        return self.counts.get(phase, 0)

    # -- zero-copy-alias tripwire -------------------------------------

    def track(self, name: str, buf) -> None:
        """Register the exact host buffer an async dispatch consumed;
        :meth:`check` at the readback verifies it was not mutated while
        the horizon was in flight (if it was, and a tensor aliased it —
        ``torch.from_numpy`` on the CPU, a pinned copy read late on the
        card — the program read torn data). Entries queue FIFO per name:
        with pipelined horizons the NEXT dispatch is tracked before the
        previous readback checks, so check() always pops the oldest
        outstanding dispatch. The queue is bounded — crash recovery can
        drop an in-flight horizon without ever processing it."""
        q = self._tracked.setdefault(name, [])
        q.append((buf, buf.tobytes()))
        del q[:-8]

    def check(self, name: str | None = None) -> None:
        names = [name] if name is not None else list(self._tracked)
        for n in names:
            q = self._tracked.get(n)
            if not q:
                continue
            buf, snap = q.pop(0)
            if buf.tobytes() != snap:
                self._violate(
                    f"dispatch-aliased host buffer {n!r} mutated while "
                    f"its horizon was in flight — zero-copy aliasing "
                    f"race (snapshot the buffer with .copy() before "
                    f"dispatch)"
                )

    # -- reporting ----------------------------------------------------

    def _violate(self, msg: str) -> None:
        if len(self.violations) < _MAX_VIOLATIONS:
            self.violations.append(msg)
        _log.error("SyncSanitizer: %s", msg)

    def assert_budgets(self) -> None:
        limits = dict(self.budgets)
        limits.update({ph: per * self.horizons
                       for ph, per in self.per_horizon.items()})
        over = [
            f"phase {ph!r}: {self.counts.get(ph, 0)} > budget {b}"
            for ph, b in limits.items()
            if self.counts.get(ph, 0) > b
        ]
        if over:
            raise SanitizerViolation("sync budgets exceeded: "
                                     + "; ".join(over))

    def report(self) -> str:
        lines = [f"sync counts: {dict(sorted(self.counts.items()))}"]
        lines += self.violations
        return "\n".join(lines)

    def assert_clean(self) -> None:
        if self.violations:
            raise SanitizerViolation(self.report())


# -------------------------------------------------------------------- #
# CompileCountGuard                                                    #
# -------------------------------------------------------------------- #


#: the step families and the keyed prefill families of the port's engine
STEP_FAMILIES = ("step", "paged_step", "masked_step", "paged_masked_step")
BUCKET_FAMILIES = ("prefill", "paged_prefill", "chunk")
GROUP_FAMILIES = ("batch_prefill", "batch_hit")


class CompileCountGuard:
    """Assert the engine's program-surface contract.

    The port compiles nothing, but its programs are keyed all the same:
    the kernels and the library pick their code by shape, a probe gates
    each batched geometry once, and a CUDA graph (the speed queues) would
    capture one per key. Traffic shape must never grow that surface beyond
    fixed families: prefill and chunk programs live on the power-of-two
    bucket grid (O(log max_len) of them), fused step programs on {1, K}
    (adaptive horizon), batched admission programs on (bucket, pow2 group
    size). A regression that keys a program on a request-varying value
    (the retrace-hazard bug class) shows up here as an out-of-family key.
    The engine records every dispatched key in ``program_keys``.

    Use as a context manager around a serve run, or call
    :meth:`check`/:meth:`assert_ok` directly.
    """

    def __init__(self, engine):
        self.engine = engine
        self.violations: list[str] = []

    def _allowed_buckets(self) -> set[int]:
        eng = self.engine
        b, out = eng._min_bucket, set()
        while b <= eng._max_bucket:
            out.add(b)
            b *= 2
        return out

    def allowed(self) -> dict[str, set]:
        """Every keyed family's allowed keys: the bucket grid, {1, K}
        (K alone without the adaptive horizon) and the (bucket, pow2 group
        <= n_slots) grid — ``analysis.programs.expected_surface`` of the
        engine's geometry."""
        eng = self.engine
        buckets = self._allowed_buckets()
        steps = ({1, eng.decode_horizon} if eng.adaptive_horizon
                 else {eng.decode_horizon})
        groups, g = set(), 1
        while g <= eng.n_slots:
            groups.add(g)
            g *= 2
        grid = {(b, n) for b in buckets for n in groups}
        out = {label: set(buckets) for label in BUCKET_FAMILIES}
        out.update({label: set(steps) for label in STEP_FAMILIES})
        out.update({label: set(grid) for label in GROUP_FAMILIES})
        return out

    def check(self) -> list[str]:
        eng = self.engine
        keys = eng.program_keys
        allowed = self.allowed()
        v: list[str] = []
        log_bound = int(math.log2(eng._max_bucket)) + 1
        for label in BUCKET_FAMILIES:
            got = set(keys.get(label, ()))
            if not got <= allowed[label]:
                v.append(
                    f"{label} programs keyed outside the pow2 bucket "
                    f"family {sorted(allowed[label])}: "
                    f"{sorted(got - allowed[label])}"
                )
            if len(got) > log_bound:
                v.append(
                    f"{label} program count {len(got)} exceeds the "
                    f"O(log max_len) bound {log_bound}"
                )
        for label in STEP_FAMILIES:
            got = set(keys.get(label, ()))
            if not got <= allowed[label]:
                v.append(
                    f"{label} programs keyed outside "
                    f"{sorted(allowed[label])}: "
                    f"{sorted(got - allowed[label])}"
                )
        for label in GROUP_FAMILIES:
            bad = sorted(set(keys.get(label, ())) - allowed[label])
            if bad:
                v.append(
                    f"{label} programs keyed outside the "
                    f"(bucket, pow2 group <= n_slots) grid: {bad}"
                )
        self.violations = v
        return v

    def assert_ok(self) -> None:
        if self.check():
            raise SanitizerViolation(
                "compile-count contract broken: "
                + "; ".join(self.violations)
            )

    def __enter__(self) -> "CompileCountGuard":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.assert_ok()
        return False


# -------------------------------------------------------------------- #
# module-level hooks (the zero-cost-when-off seam)                     #
# -------------------------------------------------------------------- #


def wrap_lock(lock, name: str):
    """Identity while no :class:`LockSanitizer` is installed (the
    default, production path); an instrumented proxy while one is.
    Serving modules create every cross-thread lock through this."""
    san = _ACTIVE_LOCK
    if san is None:
        return lock
    return san.wrap(lock, name)


def note_access(key: str, write: bool = False) -> None:
    """Report a shared-structure access to the installed
    :class:`LockSanitizer`; no-op (one global None check) when none
    is."""
    san = _ACTIVE_LOCK
    if san is not None:
        san.note_access(key, write=write)


def lock_sanitizer() -> LockSanitizer | None:
    return _ACTIVE_LOCK


def sync_sanitizer() -> SyncSanitizer | None:
    return _ACTIVE_SYNC
