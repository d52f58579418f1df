"""Grammar-constrained decoding: JSON-schema / regex constraints
compiled into token-level DFAs over the model vocabulary (the port's copy
of ``deeplearning4j_tpu/serving/grammar.py``, standard library and numpy
only; its tables are the reference's, bit for bit).

The pipeline (Outlines / SGLang-constrained style, stdlib-only):

    regex  --parse-->  char-NFA  --subset construction-->  byte DFA
    JSON schema  --lowering-->  regex subset  --> (same path)

and then, against the tokenizer's byte strings (this repo serves a raw
byte-level vocabulary by default — token ``i`` IS byte ``i``), each DFA
is lowered to two token-level tables:

- an int32 **transition table** ``(n_states, V)`` — ``trans[s, t]`` is
  the DFA state after emitting token ``t`` from state ``s``, or ``-1``
  when ``t`` is not permitted there (advanced host-side at readback for
  the engine's mirror, and in-program off the chosen token so K>1
  decode horizons stay constrained);
- a bitmask-packed uint32 **mask table** ``(n_states, ceil(V/32))`` —
  bit ``t`` of row ``s`` set iff token ``t`` is permitted, unpacked
  in-program and applied as ``where(mask, logits, -inf)`` BEFORE
  the greedy/sampled draw.

Termination is baked in at compile time: the EOS token's bit is set
exactly in ACCEPTING states (its transition is a self-loop), and a
state whose only permitted token is EOS forces the stream to retire
through the engine's existing EOS machinery. Constrained requests must
therefore carry an ``eos_token``.

State numbering is grammar-local, 0-based, with ``start`` the entry
state. The ENGINE reserves global state 0 as the unconstrained
sentinel and seats each grammar at a nonzero base offset inside a
fixed-capacity combined table (:class:`GrammarTable`), so one compiled
program serves any mix of constrained and unconstrained slots.

Compiles are cached by ``sha256(kind, spec, tokenizer id, eos, V)`` in
an in-process LRU plus an optional on-disk store (one ``.npz`` per key,
the reference's format), and a state
budget turns pathological regexes into a 400 at submit instead of an
unbounded device table.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from collections import OrderedDict

import numpy as np

__all__ = [
    "GrammarError",
    "GrammarBudgetError",
    "CompiledGrammar",
    "GrammarCache",
    "GrammarTable",
    "StopMatcher",
    "compile_regex",
    "compile_json_schema",
    "schema_to_regex",
    "default_token_bytes",
    "grammar_key",
    "parse_response_format",
    "validate_json_value",
    "MAX_LOGIT_BIAS",
    "MAX_TOP_LOGPROBS",
    "MAX_STOP_SEQUENCES",
    "MAX_STOP_LEN",
]

#: default ceiling on DFA states per grammar — a regex that blows past
#: it is rejected (HTTP 400), never silently truncated
DEFAULT_MAX_STATES = 256

#: per-slot sampling-surface widths BAKED INTO the masked step's traced
#: avals — the sparse logit-bias scatter rows are (slots, MAX_LOGIT_BIAS)
#: and the in-program logprob gather is the chosen token plus a static
#: top-MAX_TOP_LOGPROBS (requests asking for more are rejected at
#: submit, never silently clipped)
MAX_LOGIT_BIAS = 8
MAX_TOP_LOGPROBS = 8
#: stop-sequence bounds: host-side rolling suffix match at readback,
#: so these bound the per-slot hold-back buffer, not a device shape
MAX_STOP_SEQUENCES = 4
MAX_STOP_LEN = 16


class GrammarError(ValueError):
    """Malformed regex / unsupported JSON schema (client error)."""


class GrammarBudgetError(GrammarError):
    """The compiled DFA exceeds the engine's state-count budget."""


# -- regex parsing ----------------------------------------------------------
#
# Byte-level regex subset: literals, escapes (\d \w \s \n \t \r and
# escaped metacharacters), ``.``, character classes ``[a-z0-9_]`` /
# ``[^...]`` with ranges, grouping ``(...)`` (non-capturing — nothing
# captures here), alternation ``|``, and quantifiers ``* + ? {m} {m,}
# {m,n}``. Anchored fullmatch semantics (the whole stream must match).
# Character sets are 256-bit Python ints (bit b set = byte b matches),
# which makes NFA/DFA set algebra plain integer bitwise ops.

_ALL_BYTES = (1 << 256) - 1
_DOT = _ALL_BYTES & ~(1 << ord("\n"))


def _bits(chars) -> int:
    m = 0
    for c in chars:
        m |= 1 << c
    return m


_D = _bits(range(ord("0"), ord("9") + 1))
_W = _D | _bits(range(ord("a"), ord("z") + 1)) \
        | _bits(range(ord("A"), ord("Z") + 1)) | (1 << ord("_"))
_S = _bits(b" \t\n\r\f\v")
_ESCAPES = {
    ord("d"): _D, ord("w"): _W, ord("s"): _S,
    ord("D"): _ALL_BYTES & ~_D, ord("W"): _ALL_BYTES & ~_W,
    ord("S"): _ALL_BYTES & ~_S,
    ord("n"): 1 << ord("\n"), ord("t"): 1 << ord("\t"),
    ord("r"): 1 << ord("\r"), ord("f"): 1 << ord("\f"),
    ord("v"): 1 << ord("\v"), ord("0"): 1 << 0,
}

# AST nodes: ("lit", mask) | ("cat", [..]) | ("alt", [..])
#          | ("rep", node, lo, hi)  (hi None = unbounded)


class _Parser:
    def __init__(self, pattern: str):
        self.src = pattern.encode("utf-8", "strict")
        self.i = 0

    def error(self, msg: str):
        raise GrammarError(f"regex: {msg} at offset {self.i}")

    def peek(self):
        return self.src[self.i] if self.i < len(self.src) else None

    def take(self):
        c = self.peek()
        if c is None:
            self.error("unexpected end of pattern")
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.src):
            self.error("unbalanced ')'")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == ord("|"):
            self.take()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while True:
            c = self.peek()
            if c is None or c in (ord("|"), ord(")")):
                break
            items.append(self._repeat())
        return ("cat", items)

    def _repeat(self):
        node = self._atom()
        while True:
            c = self.peek()
            if c == ord("*"):
                self.take()
                node = ("rep", node, 0, None)
            elif c == ord("+"):
                self.take()
                node = ("rep", node, 1, None)
            elif c == ord("?"):
                self.take()
                node = ("rep", node, 0, 1)
            elif c == ord("{"):
                node = ("rep", node, *self._braces())
            else:
                return node

    def _braces(self):
        self.take()  # '{'
        lo = self._int()
        hi = lo
        if self.peek() == ord(","):
            self.take()
            hi = None if self.peek() == ord("}") else self._int()
        if self.take() != ord("}"):
            self.error("expected '}'")
        if hi is not None and hi < lo:
            self.error(f"bad repeat bounds {{{lo},{hi}}}")
        if (hi if hi is not None else lo) > 4096:
            self.error("repeat bound too large (max 4096)")
        return lo, hi

    def _int(self):
        digits = []
        while self.peek() is not None and ord("0") <= self.peek() <= ord("9"):
            digits.append(self.take())
        if not digits:
            self.error("expected integer")
        return int(bytes(digits))

    def _atom(self):
        c = self.take()
        if c == ord("("):
            # swallow non-capturing prefix "?:" — groups never capture
            if self.peek() == ord("?"):
                self.take()
                if self.take() != ord(":"):
                    self.error("only (?: groups supported")
            node = self._alt()
            if self.take() != ord(")"):
                self.error("expected ')'")
            return node
        if c == ord("["):
            return ("lit", self._char_class())
        if c == ord("."):
            return ("lit", _DOT)
        if c == ord("\\"):
            return ("lit", self._escape())
        if c in (ord("*"), ord("+"), ord("?"), ord("{"), ord(")"),
                 ord("]"), ord("|")):
            self.error(f"unexpected metacharacter {chr(c)!r}")
        return ("lit", 1 << c)

    def _escape(self) -> int:
        c = self.take()
        if c in _ESCAPES:
            return _ESCAPES[c]
        if c == ord("x"):
            h = bytes([self.take(), self.take()])
            try:
                return 1 << int(h, 16)
            except ValueError:
                self.error(f"bad hex escape \\x{h.decode()!r}")
        return 1 << c  # escaped literal (\. \[ \\ ...)

    def _char_class(self) -> int:
        neg = False
        if self.peek() == ord("^"):
            self.take()
            neg = True
        mask = 0
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unterminated character class")
            if c == ord("]") and not first:
                self.take()
                break
            first = False
            c = self.take()
            if c == ord("\\"):
                m = self._escape()
                if m & (m - 1):  # multi-byte escape (\d \w \s): no range
                    mask |= m
                    continue
                lo = m.bit_length() - 1
            else:
                lo = c
            if (self.peek() == ord("-") and self.i + 1 < len(self.src)
                    and self.src[self.i + 1] != ord("]")):
                self.take()  # '-'
                hi = self.take()
                if hi == ord("\\"):
                    hm = self._escape()
                    if hm & (hm - 1):
                        self.error("class escape cannot end a range")
                    hi = hm.bit_length() - 1
                if hi < lo:
                    self.error(f"reversed range {chr(lo)}-{chr(hi)}")
                mask |= _bits(range(lo, hi + 1))
            else:
                mask |= 1 << lo
        return (_ALL_BYTES & ~mask) if neg else mask


# -- NFA (Thompson) + DFA (subset construction) -----------------------------


class _NFA:
    """Epsilon-NFA under construction: ``eps[s]`` epsilon successors,
    ``edges[s]`` list of (charset-mask, dst)."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[int, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def add(self, src: int, mask: int, dst: int):
        self.edges[src].append((mask, dst))

    def link(self, src: int, dst: int):
        self.eps[src].append(dst)


def _build_nfa(node, nfa: _NFA) -> tuple[int, int]:
    """Thompson-construct ``node``; returns (entry, exit) states."""
    kind = node[0]
    if kind == "lit":
        a, b = nfa.state(), nfa.state()
        nfa.add(a, node[1], b)
        return a, b
    if kind == "cat":
        a = prev = nfa.state()
        for item in node[1]:
            ia, ib = _build_nfa(item, nfa)
            nfa.link(prev, ia)
            prev = ib
        return a, prev
    if kind == "alt":
        a, b = nfa.state(), nfa.state()
        for item in node[1]:
            ia, ib = _build_nfa(item, nfa)
            nfa.link(a, ia)
            nfa.link(ib, b)
        return a, b
    if kind == "rep":
        _, inner, lo, hi = node
        a = prev = nfa.state()
        for _ in range(lo):
            ia, ib = _build_nfa(inner, nfa)
            nfa.link(prev, ia)
            prev = ib
        if hi is None:
            ia, ib = _build_nfa(inner, nfa)
            nfa.link(prev, ia)
            nfa.link(ib, ia)  # loop
            out = nfa.state()
            nfa.link(prev, out)
            nfa.link(ib, out)
            return a, out
        out = nfa.state()
        nfa.link(prev, out)
        for _ in range(hi - lo):
            ia, ib = _build_nfa(inner, nfa)
            nfa.link(prev, ia)
            nfa.link(ib, out)
            prev = ib
        nfa.link(prev, out)
        return a, out
    raise AssertionError(f"unknown node {kind}")


def _eps_closure(nfa: _NFA, states: frozenset[int]) -> frozenset[int]:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _regex_to_dfa(pattern: str, max_states: int):
    """Parse + determinize; returns (trans: list[dict byte->state],
    accepting: list[bool], start=0). The transition alphabet is
    partitioned into atomic byte classes first so subset construction
    walks classes, not 256 bytes."""
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    entry, exit_ = _build_nfa(ast, nfa)

    # atomic byte-class partition: split 0..255 by every edge charset
    classes = [_ALL_BYTES]
    for edges in nfa.edges:
        for mask, _ in edges:
            nxt = []
            for cls in classes:
                inter = cls & mask
                if inter and inter != cls:
                    nxt.append(inter)
                    nxt.append(cls & ~mask)
                else:
                    nxt.append(cls)
            classes = nxt
    # one representative byte per class
    reps = []
    for cls in classes:
        reps.append((cls, (cls & -cls).bit_length() - 1))

    start = _eps_closure(nfa, frozenset([entry]))
    index = {start: 0}
    order = [start]
    trans: list[dict[int, int]] = [dict()]
    i = 0
    while i < len(order):
        cur = order[i]
        byte_map: dict[int, int] = {}
        for cls, _rep in reps:
            moved = set()
            for s in cur:
                for mask, dst in nfa.edges[s]:
                    if mask & cls:
                        moved.add(dst)
            if not moved:
                continue
            nxt = _eps_closure(nfa, frozenset(moved))
            j = index.get(nxt)
            if j is None:
                j = index[nxt] = len(order)
                order.append(nxt)
                trans.append(dict())
                if len(order) > max_states:
                    raise GrammarBudgetError(
                        f"regex compiles past the {max_states}-state "
                        f"budget"
                    )
            m = cls
            while m:
                b = (m & -m).bit_length() - 1
                byte_map[b] = j
                m &= m - 1
        trans[i] = byte_map
        i += 1
    accepting = [exit_ in st for st in order]

    # prune states that cannot reach an accepting state (dead ends
    # would otherwise stall the decode with an all-masked row)
    n = len(order)
    rev: list[set[int]] = [set() for _ in range(n)]
    for s, bm in enumerate(trans):
        for dst in bm.values():
            rev[dst].add(s)
    live = {s for s in range(n) if accepting[s]}
    stack = list(live)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise GrammarError("regex matches nothing")
    remap = {}
    for s in range(n):
        if s in live:
            remap[s] = len(remap)
    p_trans = []
    p_acc = []
    for s in range(n):
        if s not in live:
            continue
        p_trans.append({b: remap[d] for b, d in trans[s].items()
                        if d in live})
        p_acc.append(accepting[s])
    return p_trans, p_acc


# -- token-level compilation ------------------------------------------------


def default_token_bytes(vocab_size: int) -> list[bytes | None]:
    """The repo's serving default: a raw byte-level vocabulary where
    token ``i`` IS byte ``i`` (the HTTP layer's latin-1 convention).
    Tokens past 255 have no byte string and are never permitted."""
    return [bytes([i]) if i < 256 else None
            for i in range(int(vocab_size))]


class CompiledGrammar:
    """One grammar lowered to token tables (grammar-local states)."""

    __slots__ = ("key", "n_states", "start", "trans", "mask_words",
                 "accepting", "vocab_size", "eos_token")

    def __init__(self, key: str, trans: np.ndarray, mask_words: np.ndarray,
                 accepting: np.ndarray, start: int, eos_token: int):
        self.key = key
        self.trans = trans            # (S, V) int32, -1 = not permitted
        self.mask_words = mask_words  # (S, ceil(V/32)) uint32
        self.accepting = accepting    # (S,) bool
        self.n_states = int(trans.shape[0])
        self.vocab_size = int(trans.shape[1])
        self.start = int(start)
        self.eos_token = int(eos_token)

    def allows(self, state: int, token: int) -> bool:
        return bool(
            (self.mask_words[state, token >> 5] >> (token & 31)) & 1
        )

    def advance(self, state: int, token: int) -> int:
        nxt = int(self.trans[state, token])
        if nxt < 0:
            raise GrammarError(
                f"token {token} not permitted in state {state}"
            )
        return nxt

    def matches(self, tokens) -> bool:
        """Host-side validation: does the token stream (EOS excluded)
        land in an accepting state with every step permitted?"""
        s = self.start
        for t in tokens:
            t = int(t)
            if t == self.eos_token:
                return bool(self.accepting[s])
            if not self.allows(s, t):
                return False
            s = int(self.trans[s, t])
        return bool(self.accepting[s])


def _pack_masks(allowed: np.ndarray) -> np.ndarray:
    """(S, V) bool -> (S, ceil(V/32)) uint32, bit t of word t//32."""
    S, V = allowed.shape
    W = (V + 31) // 32
    padded = np.zeros((S, W * 32), np.uint8)
    padded[:, :V] = allowed.astype(np.uint8)
    bits = padded.reshape(S, W, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)


def _dfa_to_tokens(byte_trans, accepting, token_bytes, eos_token,
                   key: str) -> CompiledGrammar:
    S = len(byte_trans)
    V = len(token_bytes)
    eos_token = int(eos_token)
    if not (0 <= eos_token < V):
        raise GrammarError(
            f"eos_token {eos_token} outside vocabulary of {V}"
        )
    trans = np.full((S, V), -1, np.int32)
    for t, tb in enumerate(token_bytes):
        if tb is None or t == eos_token or len(tb) == 0:
            continue
        for s in range(S):
            cur = s
            ok = True
            for b in tb:
                nxt = byte_trans[cur].get(b)
                if nxt is None:
                    ok = False
                    break
                cur = nxt
            if ok:
                trans[s, t] = cur
    acc = np.asarray(accepting, bool)
    # EOS: permitted exactly in accepting states, as a self-loop — the
    # engine's EOS machinery retires the stream on it
    trans[acc, eos_token] = np.nonzero(acc)[0].astype(np.int32)
    allowed = trans >= 0
    return CompiledGrammar(key, trans, _pack_masks(allowed), acc, 0,
                           eos_token)


def compile_regex(pattern: str, token_bytes, eos_token: int,
                  max_states: int = DEFAULT_MAX_STATES,
                  key: str | None = None) -> CompiledGrammar:
    byte_trans, accepting = _regex_to_dfa(pattern, max_states)
    if key is None:
        key = grammar_key("regex", pattern, "bytes",
                          eos_token, len(token_bytes))
    return _dfa_to_tokens(byte_trans, accepting, token_bytes,
                          eos_token, key)


# -- JSON schema lowering ---------------------------------------------------

_RE_SPECIAL = set(b".^$*+?()[]{}|\\-")


def _re_escape(s: str) -> str:
    out = []
    for ch in s.encode("utf-8").decode("latin-1"):
        if ord(ch) in _RE_SPECIAL:
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


# control bytes excluded: json.loads rejects raw U+0000..U+001F inside
# strings, so the constrained stream must never be able to emit them
_STRING_RE = r'"(?:[^\x00-\x1f"\\]|\\["\\/bfnrt])*"'
_INT_RE = r"-?(?:0|[1-9][0-9]*)"
_NUMBER_RE = _INT_RE + r"(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"

#: arrays without an explicit maxItems are bounded here — a DFA cannot
#: count, so unbounded arrays unroll to this many items
DEFAULT_MAX_ITEMS = 8


def schema_to_regex(schema, depth: int = 0) -> str:
    """Lower a JSON-schema subset to the regex subset above. Supported:
    objects with fixed keys (``properties``, emitted in declaration
    order, all present), ``string``/``number``/``integer``/``boolean``/
    ``null``, ``enum`` of scalars, ``const``, and arrays of a supported
    ``items`` schema bounded by ``minItems``/``maxItems``. Canonical
    spacing (none) — outputs always ``json.loads``."""
    if depth > 16:
        raise GrammarError("schema nests too deep (max 16)")
    if not isinstance(schema, dict):
        raise GrammarError("schema must be an object")
    if "enum" in schema:
        opts = schema["enum"]
        if not isinstance(opts, list) or not opts:
            raise GrammarError("enum must be a non-empty list")
        return "(?:" + "|".join(
            _re_escape(json.dumps(v, separators=(",", ":")))
            for v in opts
        ) + ")"
    if "const" in schema:
        return _re_escape(
            json.dumps(schema["const"], separators=(",", ":"))
        )
    typ = schema.get("type")
    if typ == "string":
        return _STRING_RE
    if typ == "integer":
        return _INT_RE
    if typ == "number":
        return _NUMBER_RE
    if typ == "boolean":
        return "(?:true|false)"
    if typ == "null":
        return "null"
    if typ == "object":
        props = schema.get("properties")
        if not isinstance(props, dict) or not props:
            raise GrammarError(
                "object schema needs non-empty fixed 'properties'"
            )
        parts = []
        for name, sub in props.items():
            parts.append(
                _re_escape(json.dumps(str(name))) + ":"
                + schema_to_regex(sub, depth + 1)
            )
        return r"\{" + ",".join(parts) + r"\}"
    if typ == "array":
        items = schema.get("items")
        if items is None:
            raise GrammarError("array schema needs 'items'")
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", max(lo, DEFAULT_MAX_ITEMS)))
        if lo < 0 or hi < lo:
            raise GrammarError(f"bad array bounds [{lo},{hi}]")
        if hi > 64:
            raise GrammarError("maxItems too large (max 64)")
        item = "(?:" + schema_to_regex(items, depth + 1) + ")"
        if hi == 0:
            return r"\[\]"
        body = item + "(?:," + item + "){%d,%d}" % (
            max(0, lo - 1), hi - 1
        )
        if lo == 0:
            body = "(?:" + body + ")?"
        return r"\[" + body + r"\]"
    raise GrammarError(f"unsupported schema type {typ!r}")


def compile_json_schema(schema, token_bytes, eos_token: int,
                        max_states: int = DEFAULT_MAX_STATES,
                        key: str | None = None) -> CompiledGrammar:
    pattern = schema_to_regex(schema)
    if key is None:
        key = grammar_key("json_schema", schema, "bytes",
                          eos_token, len(token_bytes))
    return compile_regex(pattern, token_bytes, eos_token, max_states,
                         key=key)


def parse_response_format(rf) -> tuple[str, object]:
    """Normalize an HTTP ``response_format`` body field to a
    ``(kind, spec)`` pair for the compile cache. Accepts the OpenAI
    shape ``{"type": "json_schema", "json_schema": {"schema": {...}}}``
    (with or without the inner ``"schema"`` wrapper) and
    ``{"type": "regex", "regex": "..."}``."""
    if not isinstance(rf, dict):
        raise GrammarError("response_format must be an object")
    typ = rf.get("type")
    if typ == "regex":
        pattern = rf.get("regex", rf.get("pattern"))
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError(
                "response_format.regex must be a non-empty string"
            )
        return "regex", pattern
    if typ == "json_schema":
        spec = rf.get("json_schema", rf.get("schema"))
        if isinstance(spec, dict) and isinstance(
                spec.get("schema"), dict):
            spec = spec["schema"]
        if not isinstance(spec, dict):
            raise GrammarError(
                "response_format.json_schema must carry a schema object"
            )
        return "json_schema", spec
    raise GrammarError(
        f"response_format.type must be 'json_schema' or 'regex', "
        f"got {typ!r}"
    )


def validate_json_value(value, schema) -> bool:
    """Minimal host-side validator for the SUPPORTED schema subset
    (tests assert constrained outputs parse AND validate without an
    external jsonschema dependency). Mirrors :func:`schema_to_regex`:
    enum/const, scalar types, fixed-key objects, bounded arrays."""
    if "enum" in schema:
        return any(value == v for v in schema["enum"])
    if "const" in schema:
        return value == schema["const"]
    typ = schema.get("type")
    if typ == "string":
        return isinstance(value, str)
    if typ == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if typ == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    if typ == "boolean":
        return isinstance(value, bool)
    if typ == "null":
        return value is None
    if typ == "object":
        props = schema.get("properties", {})
        if not isinstance(value, dict):
            return False
        if set(value.keys()) != set(props.keys()):
            return False
        return all(
            validate_json_value(value[k], sub)
            for k, sub in props.items()
        )
    if typ == "array":
        if not isinstance(value, list):
            return False
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems",
                            max(lo, DEFAULT_MAX_ITEMS)))
        if not (lo <= len(value) <= hi):
            return False
        return all(
            validate_json_value(v, schema["items"]) for v in value
        )
    return False


def grammar_key(kind: str, spec, tokenizer_id: str, eos_token: int,
                vocab_size: int) -> str:
    """Cache identity of a compiled grammar: the constraint itself,
    the tokenizer the byte strings came from, the EOS baked into the
    accepting rows, and the vocabulary width of the tables."""
    blob = json.dumps(
        [kind, spec, tokenizer_id, int(eos_token), int(vocab_size)],
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()


# -- compile cache ----------------------------------------------------------


class GrammarCache:
    """LRU of compiled grammars keyed by :func:`grammar_key`, with an
    optional on-disk store (one ``.npz`` per key in a directory).
    ``get_or_compile`` reports how the
    grammar was obtained — ``"hit"`` (memory or disk) or ``"miss"``
    (freshly compiled) — for the
    ``serve_grammar_compiles_total{result}`` metrics."""

    def __init__(self, path: str | None = None, cap: int = 64):
        self._lock = threading.Lock()
        self._mem: OrderedDict[str, CompiledGrammar] = OrderedDict()
        self._cap = max(1, int(cap))
        self._dir = path
        if path:
            os.makedirs(path, exist_ok=True)

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def _disk_path(self, key: str) -> str | None:
        return os.path.join(self._dir, key + ".npz") if self._dir else None

    def _load_disk(self, key: str) -> CompiledGrammar | None:
        p = self._disk_path(key)
        if p is None or not os.path.exists(p):
            return None
        try:
            with np.load(p) as z:
                return CompiledGrammar(
                    key, z["trans"].astype(np.int32),
                    z["mask_words"].astype(np.uint32),
                    z["accepting"].astype(bool),
                    int(z["start"]), int(z["eos_token"]),
                )
        except Exception:  # noqa: BLE001 — corrupt cache entry = miss
            return None

    def _store_disk(self, cg: CompiledGrammar) -> None:
        p = self._disk_path(cg.key)
        if p is None:
            return
        try:
            fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f, trans=cg.trans, mask_words=cg.mask_words,
                    accepting=cg.accepting,
                    start=np.int32(cg.start),
                    eos_token=np.int32(cg.eos_token),
                )
            os.replace(tmp, p)
        except OSError:
            pass  # cache write failure is never a request failure

    def get_or_compile(self, kind: str, spec, token_bytes,
                       eos_token: int, tokenizer_id: str = "bytes",
                       max_states: int = DEFAULT_MAX_STATES,
                       ) -> tuple[CompiledGrammar, str]:
        key = grammar_key(kind, spec, tokenizer_id, eos_token,
                          len(token_bytes))
        with self._lock:
            cg = self._mem.get(key)
            if cg is not None:
                self._mem.move_to_end(key)
                return cg, "hit"
        cg = self._load_disk(key)
        result = "hit"
        if cg is None:
            result = "miss"
            if kind == "regex":
                cg = compile_regex(spec, token_bytes, eos_token,
                                   max_states, key=key)
            elif kind == "json_schema":
                cg = compile_json_schema(spec, token_bytes, eos_token,
                                         max_states, key=key)
            else:
                raise GrammarError(f"unknown grammar kind {kind!r}")
            self._store_disk(cg)
        with self._lock:
            self._mem[key] = cg
            self._mem.move_to_end(key)
            while len(self._mem) > self._cap:
                self._mem.popitem(last=False)
        return cg, result


# -- engine-side combined table ---------------------------------------------


class GrammarTable:
    """Fixed-capacity combined mask/transition table over every
    grammar currently seated in an engine. Row 0 is the unconstrained
    sentinel (all-permitted mask, identity-ish transitions) — the
    masked step folds it out with ``where(state > 0)``, so the row
    contents never reach an unconstrained stream. Each grammar is
    seated at a base offset with a refcount; retiring the last request
    drops the refcount to 0, and seat-time pressure evicts refcount-0
    grammars LRU-first. Live slots hold ABSOLUTE state indices into
    this table, so a seated grammar's rows NEVER move — freed rows go
    to an extent free-list (first-fit) instead of compacting.
    ``version`` bumps on every host-table mutation so the engine
    refreshes its device copies exactly when needed."""

    def __init__(self, capacity: int, vocab_size: int):
        self.capacity = int(capacity)
        self.vocab_size = int(vocab_size)
        W = (self.vocab_size + 31) // 32
        self.mask_words = np.zeros((self.capacity, W), np.uint32)
        self.trans = np.zeros((self.capacity, self.vocab_size), np.int32)
        # sentinel row 0: every token permitted, state stays 0
        self.mask_words[0] = np.uint32(0xFFFFFFFF)
        self.version = 1
        self._seated: dict[str, dict] = {}  # key -> {base, n, refs, lru}
        self._free: list[tuple[int, int]] = [(1, self.capacity - 1)]
        self._lru = 0

    @property
    def rows_used(self) -> int:
        return 1 + sum(e["n"] for e in self._seated.values())

    def _alloc(self, n: int) -> int | None:
        for i, (s, ln) in enumerate(self._free):
            if ln >= n:
                if ln == n:
                    del self._free[i]
                else:
                    self._free[i] = (s + n, ln - n)
                return s
        return None

    def _release_rows(self, start: int, n: int) -> None:
        self._free.append((start, n))
        self._free.sort()
        merged: list[tuple[int, int]] = []
        for s, ln in self._free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((s, ln))
        self._free = merged

    def _evict(self, key: str) -> None:
        e = self._seated.pop(key)
        self.mask_words[e["base"]:e["base"] + e["n"]] = 0
        self.trans[e["base"]:e["base"] + e["n"]] = 0
        self._release_rows(e["base"], e["n"])
        self.version += 1

    def seat(self, cg: CompiledGrammar) -> int:
        """Seat (or re-reference) a compiled grammar; returns the
        ABSOLUTE start state (base + cg.start). Raises
        :class:`GrammarBudgetError` when even eviction cannot fit
        it."""
        if cg.vocab_size != self.vocab_size:
            raise GrammarError(
                f"grammar compiled for V={cg.vocab_size}, table is "
                f"V={self.vocab_size}"
            )
        self._lru += 1
        e = self._seated.get(cg.key)
        if e is not None:
            e["refs"] += 1
            e["lru"] = self._lru
            return e["base"] + cg.start
        n = cg.n_states
        if n > self.capacity - 1:
            raise GrammarBudgetError(
                f"grammar needs {n} states, table capacity is "
                f"{self.capacity - 1}"
            )
        base = self._alloc(n)
        if base is None:
            idle = sorted(
                (k for k, e in self._seated.items() if e["refs"] == 0),
                key=lambda k: self._seated[k]["lru"],
            )
            for k in idle:
                self._evict(k)
                base = self._alloc(n)
                if base is not None:
                    break
        if base is None:
            raise GrammarBudgetError(
                f"grammar table full ({self.rows_used}/{self.capacity} "
                f"rows pinned by live requests)"
            )
        self.mask_words[base:base + n] = cg.mask_words
        t = cg.trans.astype(np.int64)
        self.trans[base:base + n] = np.where(
            t >= 0, t + base, 0
        ).astype(np.int32)
        self._seated[cg.key] = {
            "base": base, "n": n, "refs": 1, "lru": self._lru,
        }
        self.version += 1
        return base + cg.start

    def base_of(self, key: str) -> int | None:
        e = self._seated.get(key)
        return None if e is None else e["base"]

    def release(self, key: str) -> None:
        e = self._seated.get(key)
        if e is not None and e["refs"] > 0:
            e["refs"] -= 1

    def advance(self, state: int, token: int) -> int:
        """Host-mirror transition (absolute states; 0 stays 0)."""
        if state <= 0:
            return 0
        return int(self.trans[state, token])

    def allows(self, state: int, token: int) -> bool:
        if state <= 0:
            return True
        return bool(
            (self.mask_words[state, token >> 5] >> (token & 31)) & 1
        )


# -- stop sequences ---------------------------------------------------------


class StopMatcher:
    """Rolling suffix matcher for stop sequences over a token stream.

    Emission is hold-back buffered: a token is released only once it
    can no longer be part of a completed stop sequence, so an SSE
    stream never leaks a partial stop string. ``push`` returns
    ``(emitted, stripped)`` — ``stripped`` is the matched stop
    sequence's length (0 while no stop fired); on a match the held
    tokens ARE the stop sequence and are dropped, and the caller
    truncates the last ``stripped`` tokens from its record. ``flush``
    releases the hold-back when the stream ends for any other reason
    (EOS / budget)."""

    __slots__ = ("stops", "held")

    def __init__(self, stops):
        self.stops = [tuple(int(t) for t in s) for s in stops]
        if not self.stops or any(not s for s in self.stops):
            raise ValueError("stop sequences must be non-empty")
        self.held: list[int] = []

    def _longest_suffix_prefix(self) -> int:
        best = 0
        h = self.held
        for s in self.stops:
            top = min(len(s) - 1, len(h))
            for k in range(top, 0, -1):
                if k > best and tuple(h[-k:]) == s[:k]:
                    best = k
                    break
        return best

    def push(self, tok: int) -> tuple[list[int], int]:
        self.held.append(int(tok))
        for s in self.stops:
            if (len(self.held) >= len(s)
                    and tuple(self.held[-len(s):]) == s):
                emitted = self.held[:-len(s)]
                self.held = []
                return emitted, len(s)
        k = self._longest_suffix_prefix()
        if k == 0:
            emitted, self.held = self.held, []
            return emitted, 0
        emitted = self.held[:-k]
        self.held = self.held[-k:]
        return emitted, 0

    def flush(self) -> list[int]:
        emitted, self.held = self.held, []
        return emitted
