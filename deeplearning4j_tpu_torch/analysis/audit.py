"""graftaudit for the port: an op-level auditor over the program-surface
registry (``analysis.programs``), the port's version of
``deeplearning4j_tpu/analysis/audit.py``.

Where graftlint stops at the Python AST, this auditor runs every program
family the serving engine can dispatch — on ``meta`` tensors, so nothing
is computed and no device is touched — under a ``TorchDispatchMode``
recorder and ``torch.utils.flop_counter.FlopCounterMode``, and checks
properties of the programs themselves. The hand-written kernels (flash
forward #1, decode #3, paged decode #4, the threefry draw) are seen as one
op each (their dispatchers hand the call to ``ops/_leaf.HOOK``), at the
flops and bytes of their bound: the arithmetic of their plain versions is
not counted. The six checks, with their PyTorch meanings:

1.  **dtype promotion** — the count of ops that take a bf16/f16 tensor and
    produce an f32 one (an explicit ``.float()`` or a promotion inside an
    op: a Python scalar, an f32 operand) per program is recorded in the
    reviewed baseline; drift is a finding. Any f64 output is always one.
2.  **in-place update** — each family declares the arguments it updates
    in place (``PROGRAM_INPLACE``: the pooled cache, the region, the slot
    state). Every declared leaf must be written in place by the program,
    and no output may be a fresh tensor of a declared leaf's shape and
    dtype: a cache copied every step is the PyTorch form of "donation not
    used".
3.  **collective signature** — the gathers and psums each TP program makes
    at the port's ``parallel/mesh.py`` collectives must equal the declared
    contract (``tp_collective_contract``); single-device programs make
    none.
4.  **host syncs** — a readback inside a family (``.item()``,
    ``bool()``/``int()`` of a tensor, ``nonzero``, boolean-mask indexing,
    a copy to the CPU) is a finding: it would stall the decode loop.
5.  **surface** — the enumerated registry must equal ``expected_surface``
    (``CompileCountGuard``'s bounds).
6.  **flop/byte budgets** — each family's envelope program records its
    flops (FlopCounterMode's products plus the kernels' bounds) and its
    peak temporary bytes (fresh allocations alive at once) in the baseline
    (``analysis/audit_baseline.json``); a >10% regression fails.
    Argument and output bytes are shape math and must match exactly.

Exit codes mirror ``analysis.lint``: 0 clean, 1 findings (or stale
baseline entries under ``--strict``), 2 trace errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import weakref

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)
from torch.utils.flop_counter import FlopCounterMode

from deeplearning4j_tpu_torch.ops import _leaf

#: budget tolerance: flops / temp bytes may grow this factor over the
#: reviewed baseline before the audit fails
BUDGET_TOLERANCE = 1.10

_aten = torch.ops.aten
#: aten ops that hand values to the host (a sync on the card) or size
#: their output from the data
_SYNC_OPS = {
    _aten._local_scalar_dense.default: ".item()/bool()/int()/float()",
    _aten.nonzero.default: "nonzero()",
    _aten.masked_select.default: "masked_select()",
    _aten._unique2.default: "unique()",
    _aten.unique_consecutive.default: "unique_consecutive()",
    _aten.bincount.default: "bincount()",
}
_LOW = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    """One audit violation: which check, on which program, and why."""

    check: str
    program: str
    message: str

    def render(self) -> str:
        return f"{self.program}: [{self.check}] {self.message}"


# ------------------------------------------------------------------ #
# the kernels' costs (PERF.md's bound of each)                        #
# ------------------------------------------------------------------ #


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kernel_cost(name: str, args: tuple) -> tuple[int, int]:
    """(flops, bytes) of one kernel call, the terms of its bound: each
    input read once, each output written once, and the products it must do.
    The decode kernels' visible rows depend on the positions, which a
    ``meta`` run does not have: the envelope is every row of the cache."""
    if name == "flash_attn_fwd":
        q, _, _, causal = args
        bh, t, d = q.shape
        pairs = t * (t + 1) // 2 if causal else t * t
        return 4 * bh * pairs * d, 4 * _nbytes(q) + bh * t * 4
    if name in ("flash_decode", "flash_decode_paged"):
        q, store = args[0], args[1]
        b, g, hk = q.shape
        if name == "flash_decode":
            tpad = store.shape[3]
            scales = args[6]
            table = 0
        else:
            tpad = args[2].shape[1] * store.shape[3]
            scales = args[7]
            table = _nbytes(args[2])
        rows = b * tpad
        kv = 2 * rows * hk * store.element_size()
        if scales is not None:
            kv += 2 * rows * 4
        return 4 * rows * hk * g, kv + 2 * _nbytes(q) + 4 * b + table
    if name == "threefry_draw":
        logits, keys, pos = args
        r, v = logits.shape
        #: the draw's operations a logit (the threefry rounds, the Gumbel
        #: transform and the argmax), as the card's bound counts them
        draw_ops = 86
        return draw_ops * r * v, (_nbytes(logits) + _nbytes(keys)
                                  + (_nbytes(pos) if pos is not None else 0)
                                  + 8 * r)
    raise ValueError(f"no cost model for kernel {name!r}")


# ------------------------------------------------------------------ #
# the recorder                                                        #
# ------------------------------------------------------------------ #


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _written_leaves(arg) -> list:
    """The leaves of an in-place argument that the program writes: a
    paged caches operand's blocks (its tables are read)."""
    if isinstance(arg, dict) and "tables" in arg:
        return _leaves(arg["blocks"])
    return _leaves(arg)


def _sid(t: torch.Tensor) -> int:
    """The identity of a tensor's storage (meta tensors have one too)."""
    return t.untyped_storage()._cdata


class _Recorder(TorchDispatchMode):
    """Counts what one program does, op by op: dtype upcasts, f64
    outputs, host syncs, the storages written in place, fresh allocations
    (and the peak of them alive at once), and the kernels' leaf ops."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.f32_upcasts = 0
        self.f64_ops = 0
        self.syncs: list[str] = []
        self.written: set[int] = set()
        self.kernels: dict[str, int] = {}
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.live = 0
        self.peak = 0

    def _fresh(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(n=n):
            self.live -= n

        weakref.finalize(t, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        # a program's tensors are on the meta device; a CPU tensor is a
        # host value (a Python scalar rounded through a tensor), not a
        # readback
        if func in _SYNC_OPS and args[0].device.type == "meta":
            self.syncs.append(_SYNC_OPS[func])
            if func is _aten._local_scalar_dense.default:
                x = args[0]
                return False if x.dtype == torch.bool else (
                    0 if not x.is_floating_point() else 0.0)
            if func is _aten.nonzero.default:
                return torch.empty((0, args[0].dim()), dtype=torch.int64,
                                   device=args[0].device)
        if (func is _aten.index.Tensor and args[0].device.type == "meta"
                and any(i is not None and i.dtype in (torch.bool, torch.uint8)
                        for i in args[1])):
            # boolean-mask indexing sizes its output from the mask
            self.syncs.append("boolean-mask indexing")
            mask = next(i for i in args[1] if i is not None)
            return torch.empty((0,) + tuple(args[0].shape[mask.dim():]),
                               dtype=args[0].dtype, device=args[0].device)
        if (func is _aten._to_copy.default and args[0].device.type == "meta"
                and str(kwargs.get("device", "")).startswith("cpu")):
            self.syncs.append("copy to the host")
            kwargs = dict(kwargs, device=args[0].device)
        out = func(*args, **kwargs)
        ins = [a for a in _leaves((args, kwargs))]
        outs = _leaves(out)
        returns = func._schema.returns
        for i, o in enumerate(outs):
            alias = returns[i].alias_info if i < len(returns) else None
            if alias is not None and alias.is_write:
                self.written.add(_sid(o))
            elif alias is None:
                self._fresh(o)
            if o.dtype == torch.float64:
                self.f64_ops += 1
            elif o.dtype == torch.float32 and any(
                    a.dtype in _LOW for a in ins):
                self.f32_upcasts += 1
        return out

    def leaf(self, name: str, plain, *args):
        """``ops/_leaf.HOOK``: one kernel call as one op — its outputs from
        the plain version with every mode off, its cost from its bound."""
        flops, nbytes = _kernel_cost(name, args)
        with _disable_current_modes():
            out = plain(*args)
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        for o in _leaves(out):
            self._fresh(o)
        return out


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _leaves(tree))


def measure_spec(spec) -> dict:
    """Run one :class:`~.programs.ProgramSpec` on its ``meta`` arguments
    and collect every property the checks consume."""
    fn, args, mesh = spec.build()
    inplace = [t for i in spec.inplace for t in _written_leaves(args[i])]
    before = (mesh.gathers, mesh.psums) if mesh is not None else (0, 0)
    rec = _Recorder()
    _leaf.HOOK = rec.leaf
    try:
        with torch.no_grad(), rec, FlopCounterMode(display=False) as fc:
            out = fn(*args)
    finally:
        _leaf.HOOK = None
    collectives = {}
    if mesh is not None:
        for name, n in (("gather", mesh.gathers - before[0]),
                        ("psum", mesh.psums - before[1])):
            if n:
                collectives[name] = n
    out_leaves = _leaves(out)
    declared = {(tuple(t.shape), t.dtype): _sid(t) for t in inplace}
    copied = sorted({
        f"{str(o.dtype).replace('torch.', '')}{list(o.shape)}"
        for o in out_leaves
        if (tuple(o.shape), o.dtype) in declared
        and _sid(o) not in {_sid(t) for t in inplace}})
    unwritten = sorted({
        f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
        for t in inplace if _sid(t) not in rec.written})
    return {
        "family": spec.family,
        "tp": spec.tp,
        "collectives": collectives,
        "host_syncs": sorted(set(rec.syncs)),
        "f32_upcasts": rec.f32_upcasts,
        "f64_ops": rec.f64_ops,
        "arg_bytes": _tree_bytes(args),
        "out_bytes": sum(_nbytes(o) for o in out_leaves),
        "inplace_unwritten": unwritten,
        "inplace_copied": copied,
        "kernels": dict(sorted(rec.kernels.items())),
        "flops": int(fc.get_total_flops()) + rec.kernel_flops,
        "kernel_bytes": rec.kernel_bytes,
        "temp_bytes": int(rec.peak),
        "ops": rec.ops,
    }


# ------------------------------------------------------------------ #
# checks                                                             #
# ------------------------------------------------------------------ #


def check_dtype(spec, record, base_entry) -> list[AuditFinding]:
    f = []
    if record["f64_ops"]:
        f.append(AuditFinding(
            "dtype", spec.name, f"{record['f64_ops']} op(s) produce "
            f"float64"))
    if base_entry is not None:
        want = base_entry.get("f32_upcasts")
        if want is not None and record["f32_upcasts"] != want:
            f.append(AuditFinding(
                "dtype", spec.name,
                f"f32 upcast count drifted: {record['f32_upcasts']} vs "
                f"baseline {want} (an accidental upcast or a Python scalar "
                f"promoting a bf16 tensor; re-review and --write-baseline "
                f"if intended)"))
    return f


def check_inplace(spec, record) -> list[AuditFinding]:
    f = [AuditFinding("inplace", spec.name,
                      f"declared in-place argument {leaf} is never written "
                      f"in place") for leaf in record["inplace_unwritten"]]
    f += [AuditFinding("inplace", spec.name,
                       f"output {leaf} is a fresh copy of a declared "
                       f"in-place argument (the cache is copied every call)")
          for leaf in record["inplace_copied"]]
    return f


def check_collectives(spec, record) -> list[AuditFinding]:
    got, want = record["collectives"], spec.collectives
    if got == want:
        return []
    if not spec.tp:
        return [AuditFinding(
            "collectives", spec.name,
            f"single-device program makes collectives {got}")]
    return [AuditFinding(
        "collectives", spec.name,
        f"signature {got} != declared contract {want} — drift here "
        f"breaks the byte-exact TP parity layout")]


def check_host_syncs(spec, record) -> list[AuditFinding]:
    if not record["host_syncs"]:
        return []
    return [AuditFinding(
        "host-sync", spec.name,
        f"host sync(s) inside the program: "
        f"{', '.join(record['host_syncs'])}")]


def check_budgets(spec, record, base_entry) -> list[AuditFinding]:
    f = []
    if base_entry is None:
        return f
    for key in ("arg_bytes", "out_bytes"):
        want = base_entry.get(key)
        if want is not None and record[key] != want:
            f.append(AuditFinding(
                "budget", spec.name,
                f"{key} changed: {record[key]} vs baseline {want} (the "
                f"argument surface moved; re-review and --write-baseline "
                f"if intended)"))
    for key in ("flops", "temp_bytes"):
        want, got = base_entry.get(key), record.get(key)
        if want and got and got > want * BUDGET_TOLERANCE:
            f.append(AuditFinding(
                "budget", spec.name,
                f"{key} regression: {got:.0f} > baseline {want:.0f} "
                f"(+{100 * (got / want - 1):.0f}%, tolerance "
                f"{100 * (BUDGET_TOLERANCE - 1):.0f}%)"))
    return f


def check_surface(cfg, geom, specs) -> list[AuditFinding]:
    """Registry enumeration must equal the surface contract
    (``expected_surface`` — CompileCountGuard's bounds)."""
    from deeplearning4j_tpu_torch.analysis.programs import expected_surface

    exp = expected_surface(cfg, geom)
    f = []
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        f.append(AuditFinding("surface", "<registry>",
                              f"duplicate program names {dupes}"))
    base = [s for s in specs
            if "[tp=" not in s.name and "[lora]" not in s.name]

    def keyed(pattern):
        out = set()
        for s in base:
            m = re.fullmatch(pattern, s.name)
            if m:
                out.add(tuple(int(g) for g in m.groups()))
        return out

    for fam in ("step", "paged_step", "masked_step", "paged_masked_step"):
        got = {k for (k,) in keyed(fam + r"\[K=(\d+)\]")}
        if got != exp[fam]:
            f.append(AuditFinding(
                "surface", fam,
                f"horizons {sorted(got)} != expected {sorted(exp[fam])}"))
    for fam in ("prefill", "chunk", "paged_prefill"):
        got = {b for (b,) in keyed(fam + r"\[b=(\d+)\]")}
        if got != exp[fam]:
            f.append(AuditFinding(
                "surface", fam,
                f"buckets {sorted(got)} != expected {sorted(exp[fam])}"))
        if len(got) > exp["log_bound"]:
            f.append(AuditFinding(
                "surface", fam,
                f"{len(got)} programs exceed the O(log max_len) bound "
                f"{exp['log_bound']}"))
    for fam in ("batch_prefill", "batch_hit"):
        got = keyed(fam + r"\[b=(\d+),n=(\d+)\]")
        if got != exp[fam]:
            f.append(AuditFinding(
                "surface", fam,
                f"(bucket, group) grid {sorted(got)} != expected "
                f"{sorted(exp[fam])}"))
    singles = {s.name for s in base if s.name in exp["singletons"]}
    missing = exp["singletons"] - singles
    if missing:
        f.append(AuditFinding(
            "surface", "<registry>",
            f"missing singleton families {sorted(missing)}"))
    return f


# ------------------------------------------------------------------ #
# baseline (analysis/audit_baseline.json — the same reviewed-file     #
# machinery as graftlint's baseline)                                  #
# ------------------------------------------------------------------ #

#: record keys persisted per program in the baseline
_BASELINE_KEYS = ("f32_upcasts", "collectives", "arg_bytes", "out_bytes",
                  "flops", "temp_bytes", "kernels")


def default_baseline_path() -> str:
    """``audit_baseline.json`` in this package (``analysis/``; the
    ``.graftaudit.json`` at the repository root belongs to the JAX
    package)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "audit_baseline.json")


def load_baseline(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        data = json.load(fh)
    if data.get("version") != 1:
        raise ValueError(
            f"{path}: unsupported baseline version {data.get('version')!r}")
    return data


def baseline_payload(cfg, geom, records: dict[str, dict],
                     reps: set[str]) -> dict:
    """The baseline: every program's surface numbers, and the budgets
    (flops, temp bytes) of the family envelopes only."""
    progs = {}
    for name in sorted(records):
        rec = records[name]
        entry = {k: rec[k] for k in _BASELINE_KEYS if rec.get(k) is not None}
        if name not in reps:
            entry.pop("flops", None)
            entry.pop("temp_bytes", None)
        progs[name] = entry
    return {
        "version": 1,
        "cfg": json.loads(cfg.to_json()),
        "geometry": geom.to_json_dict(),
        "programs": progs,
    }


# ------------------------------------------------------------------ #
# the audit run                                                      #
# ------------------------------------------------------------------ #


def budget_representatives(specs) -> set[str]:
    """One envelope program per (family, variant): enumeration order is
    ascending in K / bucket / group size, so the last member of each group
    is the largest — the family's budget envelope."""
    last: dict[tuple, str] = {}
    for s in specs:
        variant = ("tp" if "[tp=" in s.name
                   else "lora" if "[lora]" in s.name else "")
        last[(s.family, variant)] = s.name
    return set(last.values())


def run_audit(cfg, geom, *, baseline: dict | None = None,
              budgets: str = "representative"):
    """Audit the whole surface of ``(cfg, geom)``.

    Returns ``(records, findings, stale, errors, reps)`` — per-program
    measurement records, findings, baseline entries no program claims any
    more, programs that failed to run, and the budgeted programs.
    ``budgets`` is ``"representative"`` (each family's envelope carries
    budgets) or ``"full"`` (every program does)."""
    from deeplearning4j_tpu_torch.analysis.programs import enumerate_programs

    specs = enumerate_programs(cfg, geom)
    reps = (budget_representatives(specs) if budgets == "representative"
            else {s.name for s in specs})
    base_progs = (baseline or {}).get("programs", {})
    records: dict[str, dict] = {}
    findings: list[AuditFinding] = []
    errors: list[str] = []
    for spec in specs:
        try:
            rec = measure_spec(spec)
        except Exception as e:
            errors.append(f"{spec.name}: {type(e).__name__}: {e}")
            continue
        if spec.name not in reps:
            rec["flops"] = rec["temp_bytes"] = None
        records[spec.name] = rec
        entry = base_progs.get(spec.name) if baseline else None
        findings += check_dtype(spec, rec, entry)
        findings += check_inplace(spec, rec)
        findings += check_collectives(spec, rec)
        findings += check_host_syncs(spec, rec)
        findings += check_budgets(spec, rec, entry)
        if baseline is not None and entry is None:
            findings.append(AuditFinding(
                "baseline", spec.name,
                "program not in baseline (accept with --write-baseline)"))
    findings += check_surface(cfg, geom, specs)
    stale = sorted(set(base_progs) - set(records)) if baseline else []
    return records, findings, stale, errors, reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch audit",
        description=("audit every program family the serving engine can "
                     "dispatch, on meta tensors (no device, nothing "
                     "computed)"))
    ap.add_argument("--baseline", default=None,
                    help="baseline path (default: analysis/"
                    "audit_baseline.json in the package)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip baseline comparison entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="(re)write the baseline from this run and exit 0")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("--full-budgets", action="store_true",
                    help="record budgets for EVERY program, not just each "
                    "family's envelope")
    ap.add_argument("--json-out", default=None,
                    help="write the full report (records + findings) as "
                    "JSON")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.analysis.programs import (
        default_audit_config,
        default_audit_geometry,
    )

    cfg = default_audit_config()
    geom = default_audit_geometry()
    bl_path = args.baseline or default_baseline_path()
    baseline = None if args.no_baseline else load_baseline(bl_path)
    if baseline is None and not (args.no_baseline or args.write_baseline):
        print(f"graftaudit: no baseline at {bl_path} "
              f"(--write-baseline to create it)")

    t0 = time.perf_counter()
    records, findings, stale, errors, reps = run_audit(
        cfg, geom, baseline=baseline,
        budgets="full" if args.full_budgets else "representative")
    wall = time.perf_counter() - t0

    if args.write_baseline:
        if errors:
            for e in errors:
                print(f"error: {e}")
            return 2
        payload = baseline_payload(cfg, geom, records, reps)
        with open(bl_path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"graftaudit: wrote {len(records)} program budget(s) to "
              f"{bl_path} — review and commit it")
        return 0

    for f in findings:
        print(f.render())
    for name in stale:
        print(f"{name}: [baseline] stale entry (no such program; "
              f"--write-baseline to drop)")
    if args.json_out:
        report = {
            "version": 1,
            "geometry": geom.to_json_dict(),
            "wall_s": round(wall, 2),
            "programs": records,
            "findings": [dataclasses.asdict(f) for f in findings],
            "stale": stale,
            "errors": errors,
        }
        with open(args.json_out, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
    status = (2 if errors
              else 1 if findings or (args.strict and stale)
              else 0)
    n_kernels = sum(sum(r["kernels"].values()) for r in records.values())
    print(f"graftaudit: {len(records)} programs audited in {wall:.1f}s — "
          f"{n_kernels} kernel calls, {len(findings)} finding(s), "
          f"{len(stale)} stale, {len(errors)} error(s)")
    for e in errors:
        print(f"error: {e}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
