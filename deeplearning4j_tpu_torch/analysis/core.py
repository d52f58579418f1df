"""Shared linting infrastructure: parsed modules, directives, findings
(the port's copy of ``deeplearning4j_tpu/analysis/core.py``, stdlib only).

Annotations are line comments the rules understand:

- ``# lint: hot-path`` on a ``def`` line — the function is part of the
  engine's dispatch/readback loop; the host-sync rule applies inside.
- ``# lint: holds <lock>`` on a ``def`` line — every caller holds
  ``<lock>``; the lock-discipline rule treats the body as guarded.
- ``# guarded-by: <lock>`` on an attribute assignment — accesses to
  that attribute elsewhere in the module must sit inside a lexical
  ``with ...<lock>:`` block.
- ``# lint: sync-ok <reason>`` / ``alias-ok`` / ``prng-ok`` /
  ``lock-ok`` / ``retrace-ok`` — per-line allow for one rule, with the
  justification inline where the next reader needs it.

Findings carry a line-number-independent ``key`` (rule, file, enclosing
qualname, normalized source text) so the checked-in baseline survives
unrelated edits above an accepted site.
"""

from __future__ import annotations

import ast
import dataclasses
import re

_DIRECTIVE_RE = re.compile(r"#\s*lint:\s*([a-z-]+)\s*(.*?)\s*$")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative, "/"-separated
    line: int
    col: int
    message: str
    qualname: str = "<module>"

    @property
    def key(self) -> str:
        """Stable baseline key: independent of the line number, so an
        accepted site survives edits elsewhere in the file."""
        return f"{self.rule}::{self.path}::{self.qualname}::{self.snippet}"

    @property
    def snippet(self) -> str:
        return getattr(self, "_snippet", "")

    def with_snippet(self, text: str) -> "Finding":
        object.__setattr__(self, "_snippet", " ".join(text.split()))
        return self

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class ModuleInfo:
    """One parsed source file plus its lint directives."""

    def __init__(self, path: str, source: str, relpath: str | None = None):
        self.path = path
        self.relpath = (relpath or path).replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line number (1-based) -> [(directive, argument)]
        self.directives: dict[int, list[tuple[str, str]]] = {}
        # line number -> lock name from "# guarded-by: <lock>"
        self.guarded_lines: dict[int, str] = {}
        for i, text in enumerate(self.lines, start=1):
            if "#" not in text:
                continue
            m = _DIRECTIVE_RE.search(text)
            if m:
                self.directives.setdefault(i, []).append(
                    (m.group(1), m.group(2))
                )
            g = _GUARDED_RE.search(text)
            if g:
                self.guarded_lines[i] = g.group(1)

    # -- directive queries ------------------------------------------------

    def span_lines(self, node: ast.AST) -> range:
        end = getattr(node, "end_lineno", None) or node.lineno
        return range(node.lineno, end + 1)

    def has_directive(self, node: ast.AST, name: str) -> bool:
        """Is ``# lint: <name>`` present on any physical line of
        ``node`` (multi-line calls carry the annotation anywhere in
        their span)?"""
        for ln in self.span_lines(node):
            for d, _arg in self.directives.get(ln, ()):
                if d == name:
                    return True
        return False

    def directive_arg(self, node: ast.AST, name: str) -> str | None:
        for ln in self.span_lines(node):
            for d, arg in self.directives.get(ln, ()):
                if d == name:
                    return arg
        return None

    def def_directive(self, fn: ast.AST, name: str) -> str | None:
        """A directive attached to a function definition: on the
        ``def`` line itself or the line directly above the first
        decorator/def."""
        first = min(
            [fn.lineno] + [d.lineno for d in getattr(fn, "decorator_list", [])]
        )
        for ln in (first - 1, fn.lineno):
            for d, arg in self.directives.get(ln, ()):
                if d == name:
                    return arg if arg else ""
        return None

    # -- finding construction ---------------------------------------------

    def finding(self, rule: str, node: ast.AST, message: str,
                qualname: str) -> Finding:
        line = node.lineno
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        f = Finding(rule=rule, path=self.relpath, line=line,
                    col=getattr(node, "col_offset", 0), message=message,
                    qualname=qualname)
        return f.with_snippet(text.strip())


# -- small AST helpers ----------------------------------------------------


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call target (``threefry.split`` etc.)."""
    return dotted(node.func)


def self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> "X", else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def iter_functions(tree: ast.Module):
    """Yield ``(funcdef, qualname)`` for every function/method,
    including nested ones (qualnames are dotted: ``Class.method``)."""

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield child, q
                yield from walk(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")
