"""The five lint rules, each an ``ast`` pass over one module (the port's
versions of ``deeplearning4j_tpu/analysis/rules.py``).

Every rule returns a list of :class:`~.core.Finding`; inline allow
annotations (``# lint: sync-ok <reason>`` etc.) suppress a site at the
source, the checked-in baseline suppresses it centrally. The package
docstring says what each rule's bug class is in PyTorch. ``lock-discipline``
is language-neutral and is the reference's rule unchanged: on the same
source it gives the same findings.
"""

from __future__ import annotations

import ast

from deeplearning4j_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    call_name,
    dotted,
    iter_functions,
    self_attr,
)

#: module aliases this repo uses (import numpy as np)
_NP = {"np", "numpy"}
#: readback methods: each copies a tensor's values to the host and, on a
#: CUDA tensor, waits for every kernel queued ahead of it
_READBACK_METHODS = {"item", "tolist", "cpu", "numpy"}
#: ops whose output size depends on the data: the host must learn the size
#: before it can allocate the output, so each is a sync on the card
_DATA_SIZED = {"nonzero", "masked_select", "unique", "unique_consecutive",
               "bincount", "repeat_interleave"}
#: modules whose key functions this rule tracks (ops/threefry.py, rng.py)
_KEY_MODULES = ("threefry.", "rng.")
#: key functions that DERIVE or carry keys rather than consuming them
_KEY_DERIVERS = {"split", "fold_in", "key", "as_key", "key_for",
                 "device_keys"}
#: the port's zero-copy constructors: a CPU tensor over the numpy buffer
#: (``upload`` is ``torch.from_numpy`` on the CPU)
_ALIAS_SINKS = {"torch.from_numpy", "torch.as_tensor", "torch.asarray",
                "upload", "self._upload"}
#: one-time work a hot path must not redo per call: kernel builds, graph
#: captures and compiles
_ONE_TIME = {"torch.compile", "torch.jit.script", "torch.jit.trace",
             "torch.cuda.CUDAGraph", "torch.cuda.graph",
             "torch.cuda.make_graphed_callables"}


# -- rule 1: host-sync ----------------------------------------------------

def check_host_sync(mod: ModuleInfo) -> list[Finding]:
    """Implicit device->host syncs inside ``# lint: hot-path``
    functions. Only designated sync points (``# lint: sync-ok``) are
    allowed: the engine's pipelined readback budgets ONE blocking sync
    per horizon, and any extra one serializes dispatch against
    readback.

    INTERPROCEDURAL within the module: a hot-path function calling a
    helper that syncs (directly, or through further helpers — a
    fixpoint over the module call graph) is itself a finding at the
    call site, naming the chain. Resolution covers ``self.helper()``
    within a class and bare-name calls to module-level functions.
    Hot-path callees are NOT re-flagged through their callers: their own
    sync sites already produce findings, and annotating one ``sync-ok``
    must not require annotating every transitive caller too."""
    funcs = {qual: fn for fn, qual in iter_functions(mod.tree)}
    hot = {
        qual for qual, fn in funcs.items()
        if mod.def_directive(fn, "hot-path") is not None
    }

    def callee_qual(caller: str, call: ast.Call) -> str | None:
        f = call.func
        if (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self" and "." in caller):
            cand = caller.rsplit(".", 1)[0] + "." + f.attr
            if cand in funcs:
                return cand
        elif isinstance(f, ast.Name) and f.id in funcs:
            return f.id
        return None

    # seed: non-hot-path functions with an UNANNOTATED direct sync (an
    # annotated site is a designated readback — callers inherit the
    # designation, not the hazard)
    via: dict[str, str] = {}
    for qual, fn in funcs.items():
        if qual in hot:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            label = _sync_call_label(node)
            if label and not mod.has_directive(node, "sync-ok"):
                via[qual] = label
                break

    # fixpoint: propagate syncing-ness up the call graph
    changed = True
    while changed:
        changed = False
        for qual, fn in funcs.items():
            if qual in hot or qual in via:
                continue
            for node in ast.walk(fn):
                if (not isinstance(node, ast.Call)
                        or mod.has_directive(node, "sync-ok")):
                    continue
                cq = callee_qual(qual, node)
                if cq is not None and cq in via:
                    via[qual] = f"{cq}: {via[cq]}"
                    changed = True
                    break

    out: list[Finding] = []
    for qual in hot:
        for node in ast.walk(funcs[qual]):
            if not isinstance(node, ast.Call):
                continue
            if mod.has_directive(node, "sync-ok"):
                continue
            label = _sync_call_label(node)
            if label is not None:
                out.append(mod.finding(
                    "host-sync", node,
                    f"{label} in hot-path function {qual!r} is an "
                    f"implicit device->host sync; annotate the "
                    f"designated readback point with "
                    f"'# lint: sync-ok <reason>' or move the sync "
                    f"off the hot path",
                    qual,
                ))
                continue
            cq = callee_qual(qual, node)
            if cq is not None and cq in via:
                out.append(mod.finding(
                    "host-sync", node,
                    f"hot-path function {qual!r} calls {cq!r}, which "
                    f"syncs ({via[cq]}); annotate the call with "
                    f"'# lint: sync-ok <reason>' or move the sync "
                    f"out of {cq!r}",
                    qual,
                ))
    return out


def _bare(node: ast.AST) -> bool:
    """A value that may be a tensor: a name, an attribute or a subscript
    (a literal, a display or a call's result is taken as host data)."""
    return isinstance(node, (ast.Name, ast.Attribute, ast.Subscript))


def _sync_call_label(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        base = dotted(fn.value)
        if (fn.attr in ("asarray", "array") and base in _NP
                and node.args and _bare(node.args[0])):
            return f"{base}.{fn.attr}()"
        if (fn.attr in _READBACK_METHODS and not node.args
                and not node.keywords):
            return f".{fn.attr}()"
        if fn.attr == "synchronize":
            return ".synchronize()"
        if fn.attr in _DATA_SIZED:
            return f"{fn.attr}() (output sized from the data)"
        if (fn.attr == "to" and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "cpu"):
            return '.to("cpu")'
    elif isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool"):
        if len(node.args) == 1 and _bare(node.args[0]):
            return f"{fn.id}()"
    return None


# -- rule 2: zero-copy-alias ----------------------------------------------

def check_zero_copy_alias(mod: ModuleInfo) -> list[Finding]:
    """``torch.from_numpy(x)`` (or ``torch.as_tensor``, ``torch.asarray``,
    the port's ``upload``) over a numpy buffer that is also mutated
    elsewhere. On the CPU the tensor IS the buffer, so a later host write
    changes what a program reads or what device state holds; on the card,
    a non-blocking copy out of a pinned alias reads the buffer whenever the
    stream gets to it. Pass a defensive ``.copy()`` (as the engine's
    dispatch does) or annotate ``# lint: alias-ok <reason>``."""
    out: list[Finding] = []

    # class-attribute variant: self.X subscript-mutated anywhere in the
    # class AND passed bare to an alias sink anywhere in the class
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        mutated = _subscript_mutated_self_attrs(cls)
        if not mutated:
            continue
        for fn, qual in iter_functions(ast.Module(body=cls.body,
                                                  type_ignores=[])):
            qual = f"{cls.name}.{qual}"
            for node in ast.walk(fn):
                sink, attr = _alias_sink_arg(node)
                name = self_attr(attr) if attr is not None else None
                if name in mutated and not mod.has_directive(node, "alias-ok"):
                    out.append(mod.finding(
                        "zero-copy-alias", node,
                        f"{sink}(self.{name}) may zero-copy alias a "
                        f"mutable host buffer (self.{name} is subscript-"
                        f"mutated elsewhere in {cls.name}); pass "
                        f"self.{name}.copy()",
                        qual,
                    ))

    # function-local variant: a sink over v where the SAME buffer
    # generation of v (rebinding ``v = np.zeros(...)`` starts a new one) is
    # subscript-mutated after the call, or persists across iterations of
    # the loop the call sits in while being mutated there
    for fn, qual in iter_functions(mod.tree):
        muts: list[tuple[str, int, int, tuple[int, ...]]] = []
        calls: list[tuple[str, int, ast.AST, tuple[int, ...], str]] = []
        state = {"gen": {}, "birth": {}}
        _collect_local_alias_sites(fn, (), state, muts, calls)
        for name, gen, node, loops, sink in calls:
            if mod.has_directive(node, "alias-ok"):
                continue
            birth = state["birth"].get((name, gen), ())
            hazard = any(
                m_name == name and m_gen == gen and (
                    m_line > node.lineno
                    or (loops and m_loops[:len(loops)] == loops
                        and len(birth) < len(loops))
                )
                for m_name, m_gen, m_line, m_loops in muts
            )
            if hazard:
                out.append(mod.finding(
                    "zero-copy-alias", node,
                    f"{sink}({name}) may zero-copy alias {name!r}, which "
                    f"is mutated while the tensor over it is still in "
                    f"use — snapshot with {name}.copy() first",
                    qual,
                ))
    return out


def _alias_sink_arg(node: ast.AST) -> tuple[str | None, ast.AST | None]:
    if isinstance(node, ast.Call) and node.args:
        name = call_name(node)
        if name in _ALIAS_SINKS:
            return name, node.args[0]
    return None, None


def _subscript_mutated_self_attrs(cls: ast.ClassDef) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(cls):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                name = self_attr(t.value)
                if name:
                    out.add(name)
    return out


def _collect_local_alias_sites(node, loops, state, muts, calls):
    """Walk one function in document order recording, per buffer
    GENERATION, subscript mutations of local names and bare-name sink
    calls, each tagged with its loop stack.

    A plain assignment to a bare name (``buf = np.zeros(...)``) starts a
    new generation: mutations of the fresh buffer cannot touch memory an
    earlier tensor aliased. ``state`` carries ``gen`` (name -> current
    generation) and ``birth`` ((name, gen) -> loop stack where the
    generation was born); a generation born inside the same loop as the
    call is fresh every iteration."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue  # separate scope
        child_loops = loops
        if isinstance(child, (ast.For, ast.While)):
            child_loops = loops + (id(child),)
        if isinstance(child, ast.Assign):
            for t in child.targets:
                for leaf in ([t] if not isinstance(t, (ast.Tuple, ast.List))
                             else t.elts):
                    if isinstance(leaf, ast.Name):
                        g = state["gen"].get(leaf.id, 0) + 1
                        state["gen"][leaf.id] = g
                        state["birth"][(leaf.id, g)] = child_loops
                    elif (isinstance(leaf, ast.Subscript)
                          and isinstance(leaf.value, ast.Name)):
                        n = leaf.value.id
                        muts.append((n, state["gen"].get(n, 0),
                                     child.lineno, child_loops))
        elif isinstance(child, (ast.AugAssign, ast.AnnAssign)):
            t = child.target
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                n = t.value.id
                muts.append((n, state["gen"].get(n, 0),
                             child.lineno, child_loops))
            elif isinstance(t, ast.Name) and isinstance(child, ast.AugAssign):
                # numpy ``buf += x`` mutates in place — a write, not a
                # rebind
                muts.append((t.id, state["gen"].get(t.id, 0),
                             child.lineno, child_loops))
            elif (isinstance(t, ast.Name) and isinstance(child, ast.AnnAssign)
                  and child.value is not None):
                g = state["gen"].get(t.id, 0) + 1
                state["gen"][t.id] = g
                state["birth"][(t.id, g)] = child_loops
        sink, arg = _alias_sink_arg(child)
        if arg is not None and isinstance(arg, ast.Name):
            calls.append((arg.id, state["gen"].get(arg.id, 0),
                          child, child_loops, sink))
        _collect_local_alias_sites(child, child_loops, state, muts, calls)


# -- rule 3: prng-reuse ---------------------------------------------------

def check_prng_reuse(mod: ModuleInfo) -> list[Finding]:
    """A threefry key (``ops/threefry.py``, ``rng.py``: the reference's key
    stream, pure values as JAX's keys are) consumed by two sinks without an
    intervening ``split``/``fold_in`` — drawing twice from one key
    correlates streams (or, in replay, re-draws a stream the original run
    already consumed)."""
    out: list[Finding] = []
    for fn, qual in iter_functions(mod.tree):
        state: dict[str, dict] = {}
        _prng_walk(fn.body, (), state, mod, qual, out)
    return out


def _is_key_call(cn: str | None) -> bool:
    return bool(cn) and cn.startswith(_KEY_MODULES) and (
        cn.rsplit(".", 1)[-1] in _KEY_DERIVERS)


def _track_key_targets(target, loops, state):
    names = []
    if isinstance(target, ast.Tuple):
        names = [t for t in target.elts]
    else:
        names = [target]
    for t in names:
        name = dotted(t)
        if name:
            state[name] = {"used": None, "loops": loops}


def _prng_walk(body, loops, state, mod, qual, out):
    for node in body:
        if isinstance(node, ast.Assign):
            # unwrap indexing so `split(key, 2)[0]` still reads as a
            # key-producing assignment
            value = node.value
            while isinstance(value, ast.Subscript):
                value = value.value
            cn = call_name(value) if isinstance(value, ast.Call) else None
            if _is_key_call(cn):
                for t in node.targets:
                    _track_key_targets(t, loops, state)
            else:
                for t in node.targets:
                    name = dotted(t)
                    if name in state:
                        del state[name]  # rebound to something else
            _prng_visit_expr(node.value, loops, state, mod, qual, out)
        elif isinstance(node, ast.If):
            _prng_visit_expr(node.test, loops, state, mod, qual, out)
            snap = {k: dict(v) for k, v in state.items()}
            _prng_walk(node.body, loops, state, mod, qual, out)
            merged = state.copy()
            state.clear()
            state.update(snap)
            _prng_walk(node.orelse, loops, state, mod, qual, out)
            for k, v in merged.items():  # a use on either branch counts
                if k in state and v["used"] and not state[k]["used"]:
                    state[k] = v
        elif isinstance(node, (ast.For, ast.While)):
            inner = loops + (id(node),)
            if isinstance(node, ast.For):
                _prng_visit_expr(node.iter, loops, state, mod, qual, out)
            else:
                _prng_visit_expr(node.test, loops, state, mod, qual, out)
            _prng_walk(node.body, inner, state, mod, qual, out)
            _prng_walk(node.orelse, loops, state, mod, qual, out)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            continue  # separate scope (iter_functions visits it)
        elif isinstance(node, ast.Try):
            _prng_walk(node.body, loops, state, mod, qual, out)
            for h in node.handlers:
                _prng_walk(h.body, loops, state, mod, qual, out)
            _prng_walk(node.orelse, loops, state, mod, qual, out)
            _prng_walk(node.finalbody, loops, state, mod, qual, out)
        elif isinstance(node, ast.With):
            for item in node.items:
                _prng_visit_expr(item.context_expr, loops, state, mod,
                                 qual, out)
            _prng_walk(node.body, loops, state, mod, qual, out)
        else:
            for value in ast.iter_child_nodes(node):
                _prng_visit_expr(value, loops, state, mod, qual, out)


def _prng_visit_expr(expr, loops, state, mod, qual, out):
    if expr is None:
        return
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        cn = call_name(node)
        if cn is None:
            continue
        if _is_key_call(cn):
            continue  # split/fold_in/device_keys derive, never consume
        for arg in node.args:
            name = dotted(arg)
            entry = state.get(name) if name else None
            if entry is None:
                continue
            if mod.has_directive(node, "prng-ok"):
                continue
            if entry["used"] is not None:
                out.append(mod.finding(
                    "prng-reuse", node,
                    f"PRNG key {name!r} consumed again (first sink at "
                    f"line {entry['used']}) without an intervening "
                    f"split/fold_in — streams will correlate",
                    qual,
                ))
            elif loops and entry["loops"][:len(loops)] != loops:
                out.append(mod.finding(
                    "prng-reuse", node,
                    f"PRNG key {name!r} consumed inside a loop but "
                    f"derived outside it — every iteration draws the "
                    f"same stream; split/fold_in per iteration",
                    qual,
                ))
                entry["used"] = node.lineno
            else:
                entry["used"] = node.lineno


# -- rule 4: lock-discipline ----------------------------------------------

def check_lock_discipline(mod: ModuleInfo) -> list[Finding]:
    """Accesses to ``# guarded-by: <lock>`` attributes outside a
    lexical ``with ...<lock>:`` block. ``__init__`` bodies are exempt
    (construction precedes sharing); ``# lint: holds <lock>`` on a def
    marks a helper whose callers all hold the lock."""
    guarded: dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for ln in mod.span_lines(node):
                lock = mod.guarded_lines.get(ln)
                if lock is None:
                    continue
                for t in targets:
                    name = self_attr(t)
                    if name:
                        guarded[name] = lock
    if not guarded:
        return []

    out: list[Finding] = []

    def walk(node, held: frozenset[str], qual: str, in_init: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                h = mod.def_directive(child, "holds")
                child_held = frozenset([h] if h else [])
                walk(child, child_held, q, child.name == "__init__")
                continue
            if isinstance(child, ast.Lambda):
                walk(child, frozenset(), qual, False)
                continue
            if isinstance(child, ast.ClassDef):
                walk(child, frozenset(), f"{qual}.{child.name}".lstrip("."),
                     False)
                continue
            child_held = held
            if isinstance(child, ast.With):
                names = set()
                for item in child.items:
                    d = dotted(item.context_expr)
                    if d:
                        names.add(d.rsplit(".", 1)[-1])
                child_held = held | names
            if isinstance(child, ast.Attribute):
                lock = guarded.get(child.attr)
                if (lock is not None and not in_init
                        and lock not in child_held
                        and not mod.has_directive(child, "lock-ok")
                        and child.lineno not in mod.guarded_lines):
                    out.append(mod.finding(
                        "lock-discipline", child,
                        f".{child.attr} is '# guarded-by: {lock}' but "
                        f"accessed outside a 'with ...{lock}:' block "
                        f"(in {qual or '<module>'})",
                        qual or "<module>",
                    ))
            walk(child, child_held, qual, in_init)

    walk(mod.tree, frozenset(), "", False)
    return out


# -- rule 5: retrace-hazard -----------------------------------------------

def check_retrace_hazard(mod: ModuleInfo) -> list[Finding]:
    """One-time work done per call. The port has no jit cache; what it
    must do once is build a kernel (``ops/_build.py``), capture a CUDA
    graph or compile a function (``torch.compile``, ``torch.jit``). A site
    is a finding when it compiles and calls at once
    (``torch.compile(f)(x)``: the compile is redone whenever ``f``'s
    identity varies), when it sits in a loop, or when it sits in a
    ``# lint: hot-path`` function. ``__init__`` bodies are construction,
    not a retrace. The runtime complement is ``CompileCountGuard``."""
    out: list[Finding] = []
    for fn, qual in iter_functions(mod.tree):
        if fn.name == "__init__":
            continue  # one-time construction cost, not a retrace
        hot = mod.def_directive(fn, "hot-path") is not None
        _retrace_walk(fn, (), mod, qual, hot, out)
    return out


def _one_time_label(node: ast.AST) -> str | None:
    if not isinstance(node, ast.Call):
        return None
    name = call_name(node)
    if name in _ONE_TIME:
        return name
    if name and (name.startswith("_build.") or name == "build_all"):
        return name
    return None


def _retrace_walk(node, loops, mod, qual, hot, out):
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested defs visited by iter_functions
        child_loops = loops
        if isinstance(child, (ast.For, ast.While)):
            child_loops = loops + (id(child),)
        if isinstance(child, ast.Call) and not mod.has_directive(
                child, "retrace-ok"):
            inner = _one_time_label(child.func)
            label = _one_time_label(child)
            if inner is not None:
                out.append(mod.finding(
                    "retrace-hazard", child,
                    f"{inner}(...)(...) invoked immediately in {qual!r}: "
                    f"the compile is redone whenever the wrapped "
                    f"function's identity varies — cache the compiled "
                    f"callable (or annotate '# lint: retrace-ok "
                    f"<reason>')",
                    qual,
                ))
            elif label is not None and (child_loops or hot):
                where = "inside a loop" if child_loops else (
                    "in a hot-path function")
                out.append(mod.finding(
                    "retrace-hazard", child,
                    f"{label} called {where} in {qual!r}: one-time work "
                    f"(a kernel build, a capture or a compile) done per "
                    f"call — hoist it out (or annotate "
                    f"'# lint: retrace-ok <reason>')",
                    qual,
                ))
        _retrace_walk(child, child_loops, mod, qual, hot, out)


# -- registry -------------------------------------------------------------

RULES = {
    "host-sync": check_host_sync,
    "zero-copy-alias": check_zero_copy_alias,
    "prng-reuse": check_prng_reuse,
    "lock-discipline": check_lock_discipline,
    "retrace-hazard": check_retrace_hazard,
}


def run_rules(mod: ModuleInfo, rules=None) -> list[Finding]:
    out: list[Finding] = []
    for name in (rules or RULES):
        out.extend(RULES[name](mod))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out
