"""Program-surface registry of the port's serving engine: every program
family it can dispatch, with ``meta`` arguments — no devices, no weights,
nothing executed (the port's version of
``deeplearning4j_tpu/analysis/programs.py``).

The engine builds its programs with the module-level ``build_*_program``
factories in ``serving.engine`` over its own closures; this module calls
the SAME factories with closures built from a :class:`TransformerConfig`
plus a :class:`ServingGeometry`, and makes every argument a ``meta``
tensor of the engine's shape and dtype. A registry entry is therefore the
live program by construction: the auditor (``analysis.audit``) runs these
specs on ``meta`` tensors and checks dtype promotion, the in-place cache
update, the collective signature, host syncs and the surface bounds
without ever running the engine.

Family keys mirror the engine's ``program_keys`` (step programs per
horizon, prefill/chunk per pow2 bucket, batched admission per (bucket,
pow2 group)), so a test can diff the registry against a live engine's
``CompileCountGuard``. The reference fuses a piggyback chunk into its
decode program; the port runs the chunk program itself, so it has no
``piggyback_step`` families. Its paged copies are the pool's operations
on the block pool (``paged_slot_scatter``, ``paged_slot_gather``,
``paged_block_copy``), under the reference's family names.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _cache_rows,
    _chunk_builder,
    _decode_builder,
    init_lora_bank,
    init_params,
    paged_block_copy,
    paged_scatter,
    paged_slot_gather,
    paged_slot_scatter,
    params_to,
    place_serving_tp_params,
    tp_collective_contract,
)
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, smap
from deeplearning4j_tpu_torch.serving.engine import (
    SurfaceUse,
    _max_bucket,
    build_batch_hit_program,
    build_batch_prefill_program,
    build_chunk_program,
    build_deact_program,
    build_gstate_set_program,
    build_hit_insert_program,
    build_insert_program,
    build_logit_row_program,
    build_masked_step_program,
    build_prefill_program,
    build_replay_program,
    build_seg_fetch_program,
    build_seg_import_program,
    build_seg_store_program,
    build_step_program,
)
from deeplearning4j_tpu_torch.serving.grammar import (
    MAX_LOGIT_BIAS,
    MAX_TOP_LOGPROBS,
)

META = torch.device("meta")

#: the arguments each family updates in place (the port's programs write
#: the pooled cache, the prefix region and the slot state where they lie:
#: the PyTorch form of the reference's donation)
PROGRAM_INPLACE: dict[str, tuple[int, ...]] = {
    "step": (1,), "masked_step": (1,), "replay": (1,),
    "paged_step": (1,), "paged_masked_step": (1,), "paged_replay": (1,),
    "prefill": (1,), "paged_prefill": (1,), "chunk": (1,),
    "batch_prefill": (1, 2, 3, 4, 5, 6), "batch_hit": (1, 2, 3, 4, 5, 6),
    "insert": (1, 2, 3, 4, 5), "hit_insert": (0, 1, 2, 3, 4, 5),
    "paged_insert": (0, 1, 2, 3, 4, 5),
    "seg_store": (0,), "seg_import": (0,), "paged_seg_import": (0,),
    "block_copy": (0,), "gstate_set": (0,), "deactivate": (0,),
    "seg_fetch": (), "paged_seg_fetch": (), "logit_row": (),
}


def _i32(*shape):
    return torch.empty(shape, dtype=torch.int32, device=META)


def _i64(*shape):
    return torch.empty(shape, dtype=torch.int64, device=META)


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32, device=META)


def _pow2_up_to(limit: int) -> list[int]:
    out, b = [], 1
    while b <= limit:
        out.append(b)
        b *= 2
    return out


@dataclasses.dataclass(frozen=True)
class ServingGeometry:
    """The serving-side knobs that determine the program surface — the
    registry analogue of ``ServingEngine.__init__``'s geometry arguments.
    Defaults give a small surface that traces in seconds on the CPU (the
    audit geometry)."""

    n_slots: int = 4
    max_total: int = 64
    temperature: float = 0.0
    top_k: int | None = None
    approx_top_k: bool = False
    decode_horizon: int = 2
    adaptive_horizon: bool = True
    prefill_max_bucket: int = 32
    tp: int = 1
    n_adapters: int = 0
    lora_rank: int = 4
    prefix_segments: int = 2
    # block-paged KV surface (``ServingEngine(paged=True)``): the paged
    # families ride ALONGSIDE the slab ones — a paged engine still runs
    # the chunk/scratch-slab programs (suffix path, probes)
    paged: bool = False
    block_size: int = 8
    # sampling surface (``ServingEngine(sampling_surface=True)``): masked
    # step variants replace the plain ones at dispatch time, plus the
    # single-row grammar-state seat program
    sampling_surface: bool = False
    grammar_states: int = 64
    n_bias: int = MAX_LOGIT_BIAS
    n_logprobs: int = MAX_TOP_LOGPROBS

    def tpad(self, cfg: TransformerConfig) -> int:
        """Pooled slab row count — mirrors ``init_caches``."""
        return _cache_rows(min(self.max_total, cfg.max_len))

    def blocks_per_slot(self, cfg: TransformerConfig) -> int:
        """Table width — mirrors ``PagedKVPool``'s Tpad/block split."""
        return self.tpad(cfg) // self.block_size

    def n_blocks(self, cfg: TransformerConfig) -> int:
        """Default pool capacity: slab-equivalent + the zero sentinel."""
        return self.n_slots * self.blocks_per_slot(cfg) + 1

    def buckets(self, cfg: TransformerConfig) -> list[int]:
        """The pow2 prompt-bucket grid — mirrors the engine's
        ``_min_bucket``/``_max_bucket``."""
        mb = _max_bucket(self.prefill_max_bucket, cfg.max_len,
                         self.tpad(cfg))
        lo = min(8, mb)
        return [b for b in _pow2_up_to(mb) if b >= lo]

    def horizons(self) -> list[int]:
        """Step horizons the engine can key programs on: {K}, or {1, K}
        under the adaptive horizon."""
        k = max(1, self.decode_horizon)
        return sorted({1, k}) if self.adaptive_horizon else [k]

    def group_sizes(self) -> list[int]:
        """Batched-admission group sizes (pow2, padded up)."""
        return _pow2_up_to(self.n_slots)

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProgramSpec:
    """One enumerable program: a build() thunk returning the (python
    callable, ``meta`` argument tuple) pair the auditor runs, plus the
    family's DECLARED contracts — the arguments it updates in place
    (``PROGRAM_INPLACE``) and the collective signature ({} for
    single-device families: any collective is drift)."""

    name: str
    family: str
    inplace: tuple[int, ...]
    tp: bool
    collectives: dict[str, int]
    build: object  # () -> (fn, args, mesh or None)


def _meta_tree(tree):
    """A params tree on the meta device (shapes and dtypes only)."""
    return params_to(tree, META)


class _FamilyArgs:
    """``meta`` arguments for one (cfg, geometry, tp mesh) tuple: params
    after the serving weight cast, pooled caches, scratch slabs, the
    prefix region and the per-slot device state. Each accessor makes fresh
    tensors (the programs write their arguments in place)."""

    def __init__(self, cfg: TransformerConfig, geom: ServingGeometry,
                 tp_mesh: Mesh | None = None, lora: bool = False):
        self.cfg, self.geom, self.mesh = cfg, geom, tp_mesh
        self.lora = lora
        fwd1, ic, do_prefill, cast = _decode_builder(cfg, tp_mesh)
        self.fwd1, self.init_caches, self.do_prefill = fwd1, ic, do_prefill
        self.fwd_chunk = _chunk_builder(cfg, tp_mesh)
        # the float weights drawn on the host at the audit's small size,
        # then shapes only
        host = init_params(cfg, 0, device="cpu")
        if lora:
            host["lora"] = init_lora_bank(
                threefry.key(1), cfg, n_adapters=max(2, geom.n_adapters),
                rank=geom.lora_rank, device="cpu")
        params = _meta_tree(host)
        if tp_mesh is not None:
            params = place_serving_tp_params(tp_mesh, params, cfg)
        self.params = cast(params)

    def caches(self, n: int | None = None):
        return self.init_caches(self.geom.n_slots if n is None else n,
                                self.geom.max_total, META)

    def state(self):
        n, v = self.geom.n_slots, self.cfg.vocab_size
        return (self.caches(), _f32(n, v), _i32(n),
                torch.empty((n,), dtype=torch.bool, device=META), _i32(n),
                _i32(n))

    def blocks(self):
        """The paged pool's leaves: the slab leaf's (slot, Tpad) plane
        becomes (n_blocks, block_size) — mirrors ``PagedKVPool``."""
        g, cfg = self.geom, self.cfg
        nb = g.n_blocks(cfg)
        return smap(lambda s: torch.empty(
            (s.shape[0], s.shape[1], nb, g.block_size, s.shape[4]),
            dtype=s.dtype, device=META), self.caches(1))

    def tables(self):
        return _i32(self.geom.n_slots, self.geom.blocks_per_slot(self.cfg))

    def paged_state(self):
        st = self.state()
        return ({"blocks": self.blocks(), "tables": self.tables()},) + st[1:]

    def surface_tail(self):
        """The masked step's trailing arguments after the slot state, in
        ``mstep`` order: gstate, keys, temps, top_ks, top_ps, bias_idx,
        bias_val, mask_words, trans_tab, use (every stage on), adapters."""
        g, v = self.geom, self.cfg.vocab_size
        n = g.n_slots
        return (_i32(n), _i64(n, 2), _f32(n), _i32(n), _f32(n),
                _i32(n, g.n_bias), _f32(n, g.n_bias),
                _i32(g.grammar_states, -(-v // 32)),
                _i32(g.grammar_states, v), SurfaceUse(), None)

    def keys(self):
        return (None if self.geom.temperature == 0
                else _i64(self.geom.n_slots, 2))

    def adapters(self, n: int | None = None):
        """The slots' LoRA rows (bank variants only: the engine passes
        None while every live slot holds adapter 0)."""
        return _i32(self.geom.n_slots if n is None else n) if (
            self.lora) else None


def _paged_insert_program():
    """The paged admission's landing (``PagedKVPool.land``) and seat: the
    prefilled scratch slab scattered into the blocks its table row names,
    then ``insert``'s slot state."""
    insert = build_insert_program()

    def paged_insert(blocks, logits, pos, active, budget, eos, table_row,
                     slab, lg, slot: int, pos0: int, max_new: int,
                     eos_tok: int):
        paged_scatter(blocks, smap(lambda t: t[None], table_row), slab)
        insert(None, logits, pos, active, budget, eos, lg, slot, pos0,
               max_new, eos_tok)

    return paged_insert


def _specs_for(av: _FamilyArgs, geom: ServingGeometry, *,
               tp: bool = False, suffix: str = "",
               families: set[str] | None = None) -> list[ProgramSpec]:
    """ProgramSpecs for every family under one argument set. ``families``
    restricts the emitted set (TP/LoRA variants re-enumerate only the
    forward-pass families — the copy programs contain no model code, so
    their sharded variants add tracing time, not coverage)."""
    cfg = av.cfg
    out: list[ProgramSpec] = []

    def want(f):
        return families is None or f in families

    def add(name, family, build, n_substeps=0):
        contract = (tp_collective_contract(cfg, n_substeps)
                    if tp and n_substeps else {})
        out.append(ProgramSpec(
            name=name + suffix, family=family,
            inplace=PROGRAM_INPLACE[family], tp=tp,
            collectives=contract, build=lambda: (*build(), av.mesh)))

    dev_temp = geom.temperature
    nl = min(geom.n_logprobs, cfg.vocab_size)
    for k in geom.horizons():
        if want("step"):
            add(f"step[K={k}]", "step", lambda k=k: (
                build_step_program(av.fwd1, k, dev_temp, geom.top_k, META),
                (av.params, *av.state(), av.keys(), av.adapters())),
                n_substeps=k)
        if geom.sampling_surface and want("masked_step"):
            add(f"masked_step[K={k}]", "masked_step", lambda k=k: (
                build_masked_step_program(av.fwd1, k, nl),
                (av.params, *av.state(), *av.surface_tail())),
                n_substeps=k)
        if geom.paged and want("paged_step"):
            add(f"paged_step[K={k}]", "paged_step", lambda k=k: (
                build_step_program(av.fwd1, k, dev_temp, geom.top_k, META),
                (av.params, *av.paged_state(), av.keys(), av.adapters())),
                n_substeps=k)
        if geom.paged and geom.sampling_surface and want(
                "paged_masked_step"):
            add(f"paged_masked_step[K={k}]", "paged_masked_step",
                lambda k=k: (
                    build_masked_step_program(av.fwd1, k, nl),
                    (av.params, *av.paged_state(), *av.surface_tail())),
                n_substeps=k)
    n = geom.n_slots
    if want("replay"):
        add("replay", "replay", lambda: (
            build_replay_program(av.fwd1),
            (av.params, av.caches(), _f32(n, cfg.vocab_size), _i32(n),
             _i32(n), torch.empty((n,), dtype=torch.bool, device=META),
             av.adapters())), n_substeps=1)
    if geom.paged and want("paged_replay"):
        add("paged_replay", "paged_replay", lambda: (
            build_replay_program(av.fwd1),
            (av.params, av.paged_state()[0], _f32(n, cfg.vocab_size),
             _i32(n), _i32(n),
             torch.empty((n,), dtype=torch.bool, device=META),
             av.adapters())), n_substeps=1)
    for b in geom.buckets(cfg):
        if want("prefill"):
            add(f"prefill[b={b}]", "prefill", lambda b=b: (
                build_prefill_program(av.do_prefill),
                (av.params, av.caches(1), _i64(1, b), b - 1,
                 av.adapters(1))), n_substeps=1)
        if geom.paged and want("paged_prefill"):
            # the paged engine prefills a fresh scratch slab (then lands
            # it: ``paged_insert``)
            add(f"paged_prefill[b={b}]", "paged_prefill", lambda b=b: (
                build_prefill_program(av.do_prefill),
                (av.params, av.caches(1), _i64(1, b), b - 1,
                 av.adapters(1))), n_substeps=1)
        if want("chunk"):
            add(f"chunk[b={b}]", "chunk", lambda b=b: (
                build_chunk_program(av.fwd_chunk),
                (av.params, av.caches(1), _i64(1, b), 0, b - 1,
                 av.adapters(1))), n_substeps=1)
        for nb in geom.group_sizes():
            if want("batch_prefill"):
                add(f"batch_prefill[b={b},n={nb}]", "batch_prefill",
                    lambda b=b, nb=nb: (
                        build_batch_prefill_program(
                            av.do_prefill, av.init_caches, geom.max_total),
                        (av.params, *av.state(), _i64(nb, b), _i64(nb),
                         _i64(nb), _i32(nb), _i32(nb), _i32(nb),
                         av.adapters(nb))), n_substeps=1)
            if want("batch_hit"):
                add(f"batch_hit[b={b},n={nb}]", "batch_hit",
                    lambda b=b, nb=nb: (
                        build_batch_hit_program(av.fwd_chunk),
                        (av.params, *av.state(),
                         av.caches(geom.prefix_segments), _i64(nb),
                         _i64(nb, b), 0, _i64(nb), _i64(nb), _i32(nb),
                         _i32(nb), _i32(nb), av.adapters(nb))),
                    n_substeps=1)
    v = cfg.vocab_size
    if want("deactivate"):
        add("deactivate", "deactivate", lambda: (
            build_deact_program(),
            (torch.empty((n,), dtype=torch.bool, device=META), 0)))
    if want("insert"):
        add("insert", "insert", lambda: (
            build_insert_program(),
            (*av.state(), _f32(1, v), 0, 1, 1, -1)))
    if want("hit_insert"):
        add("hit_insert", "hit_insert", lambda: (
            build_hit_insert_program(),
            (*av.state(), av.caches(geom.prefix_segments), _f32(1, v), 0,
             0, 1, 1, -1)))
    if want("seg_fetch"):
        add("seg_fetch", "seg_fetch", lambda: (
            build_seg_fetch_program(),
            (av.caches(geom.prefix_segments), 0)))
    if want("seg_store"):
        add("seg_store", "seg_store", lambda: (
            build_seg_store_program(),
            (av.caches(geom.prefix_segments), av.caches(), 0, 0)))
    if want("seg_import"):
        add("seg_import", "seg_import", lambda: (
            build_seg_import_program(),
            (av.caches(geom.prefix_segments), av.caches(1), 0)))
    if want("logit_row"):
        add("logit_row", "logit_row", lambda: (
            build_logit_row_program(), (_f32(n, v), 0)))
    if geom.sampling_surface and want("gstate_set"):
        add("gstate_set", "gstate_set", lambda: (
            build_gstate_set_program(), (_i32(n), 0, 1)))
    if geom.paged:
        bps = geom.blocks_per_slot(cfg)
        if want("paged_insert"):
            add("paged_insert", "paged_insert", lambda: (
                _paged_insert_program(),
                (av.blocks(), *av.state()[1:], _i32(bps), av.caches(1),
                 _f32(1, v), 0, 1, 1, -1)))
        if want("paged_seg_fetch"):
            add("paged_seg_fetch", "paged_seg_fetch", lambda: (
                paged_slot_gather, (av.blocks(), _i32(bps))))
        if want("paged_seg_import"):
            add("paged_seg_import", "paged_seg_import", lambda: (
                paged_slot_scatter, (av.blocks(), _i32(bps),
                                     av.caches(1))))
        if want("block_copy"):
            add("block_copy", "block_copy", lambda: (
                paged_block_copy, (av.blocks(), 1, 2)))
    return out


#: forward-pass families — the ones whose TP variants carry the
#: collective contract (the copy programs contain no model code)
_FORWARD_FAMILIES = {"step", "replay", "prefill", "chunk", "masked_step",
                     "batch_prefill", "batch_hit"}


def enumerate_programs(cfg: TransformerConfig,
                       geom: ServingGeometry) -> list[ProgramSpec]:
    """Every program family the engine can dispatch under ``(cfg, geom)``:
    the full single-device surface, plus TP-sharded variants of the
    forward families when ``geom.tp > 1`` (over a mesh of ``meta``
    devices: the engine's TP programs run no kernel, the dense config),
    plus the LoRA-bank step variant when ``geom.n_adapters > 0``."""
    specs = _specs_for(_FamilyArgs(cfg, geom), geom)
    if geom.tp > 1:
        # mirrors the engine: a TP engine runs the dense decode and
        # prefill (``ServingEngine._init_tp``)
        cfg_tp = dataclasses.replace(cfg, decode_kernel=False,
                                     use_flash=False)
        mesh = Mesh([META] * geom.tp)
        specs += _specs_for(
            _FamilyArgs(cfg_tp, geom, tp_mesh=mesh), geom, tp=True,
            suffix=f"[tp={geom.tp}]", families=set(_FORWARD_FAMILIES))
    if geom.n_adapters > 0:
        # the bank rides inside params; the adapter-index vector is
        # already an argument of every step program, so the only new
        # family is the bank-carrying step itself
        specs += _specs_for(_FamilyArgs(cfg, geom, lora=True), geom,
                            suffix="[lora]", families={"step"})
    return specs


def expected_surface(cfg: TransformerConfig,
                     geom: ServingGeometry) -> dict[str, object]:
    """The surface contract in ``CompileCountGuard``'s vocabulary:
    allowed keys per keyed family and the O(log max_len) count bound. The
    audit's surface check asserts the registry's enumeration equals this;
    ``CompileCountGuard.allowed`` of an engine of the same geometry gives
    the same key sets."""
    buckets = set(geom.buckets(cfg))
    groups = set(geom.group_sizes())
    horizons = set(geom.horizons())
    paged, surf = geom.paged, geom.sampling_surface
    singletons = {"replay", "deactivate", "insert", "hit_insert",
                  "seg_fetch", "seg_store", "seg_import", "logit_row"}
    if paged:
        singletons |= {"paged_replay", "paged_insert", "paged_seg_fetch",
                       "paged_seg_import", "block_copy"}
    if surf:
        singletons |= {"gstate_set"}
    return {
        "step": set(horizons),
        "masked_step": set(horizons) if surf else set(),
        "paged_step": set(horizons) if paged else set(),
        "paged_masked_step": set(horizons) if paged and surf else set(),
        "prefill": set(buckets),
        "paged_prefill": set(buckets) if paged else set(),
        "chunk": set(buckets),
        "batch_prefill": {(b, n) for b in buckets for n in groups},
        "batch_hit": {(b, n) for b in buckets for n in groups},
        "singletons": singletons,
        "log_bound": int(math.log2(max(buckets))) + 1,
    }


def default_audit_config() -> TransformerConfig:
    """The audit's model config: small enough that the whole surface runs
    on ``meta`` tensors in seconds, bf16 compute so the dtype-promotion
    check has teeth, GQA + RoPE so the audited forward is the
    feature-bearing one, and the kernels on (``use_flash``,
    ``decode_kernel``), so the audited programs are the ones the card
    runs, each kernel one op."""
    return TransformerConfig(
        vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=128, max_len=64, rope=True, compute_dtype=torch.bfloat16,
        use_flash=True, decode_kernel=True)


def default_audit_geometry() -> ServingGeometry:
    """The audit geometry (see ``analysis/audit_baseline.json``): every
    family class is populated — adaptive horizon (two step programs),
    three buckets, batched groups to 4, TP=2 forward variants, one LoRA
    step variant, the block-paged families and the sampling surface."""
    return ServingGeometry(
        n_slots=4, max_total=64, temperature=0.8, top_k=None,
        decode_horizon=2, adaptive_horizon=True, prefill_max_bucket=32,
        tp=2, n_adapters=2, lora_rank=4, prefix_segments=2, paged=True,
        block_size=8, sampling_surface=True, grammar_states=64)


def family_budgets(path: str | None = None) -> dict[str, dict]:
    """Per-family static flop/byte budgets from the committed audit
    baseline: ``{family: {"flops": int, "bytes": int}}``, the
    denominators of the live MFU/MBU gauges.

    Only each family's ENVELOPE program (the largest geometry variant)
    carries ``flops`` in the baseline, so exactly those entries are picked
    up; the family name is the program name with its ``[...]`` suffixes
    stripped, and base variants win over ``[tp=...]``/``[lora]`` ones
    (the live single-device engine dispatches base programs). ``bytes`` is
    the argument+output bytes of the envelope.

    The budgets are EXACT for the audit geometry and a scale reference
    otherwise — the gauge docs on ``/metrics`` say so. Returns ``{}`` when
    no baseline is found, so callers degrade to seconds-only attribution.
    """
    from deeplearning4j_tpu_torch.analysis.audit import (
        default_baseline_path,
        load_baseline,
    )

    data = load_baseline(path or default_baseline_path())
    if not data:
        return {}
    out: dict[str, dict] = {}
    for name, rec in data.get("programs", {}).items():
        flops = rec.get("flops")
        if flops is None:
            continue  # not the family envelope
        family = name.split("[", 1)[0]
        variant = "[tp=" in name or "[lora" in name
        prev = out.get(family)
        if prev is not None and not prev["_variant"] and variant:
            continue  # a base-variant envelope already won
        if prev is not None and variant == prev["_variant"] and int(
                flops) <= prev["flops"]:
            continue  # keep the larger envelope
        out[family] = {
            "flops": int(flops),
            "bytes": int(rec.get("arg_bytes", 0))
            + int(rec.get("out_bytes", 0)),
            "_variant": variant,
        }
    for rec in out.values():
        del rec["_variant"]
    return out
