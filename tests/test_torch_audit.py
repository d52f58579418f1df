"""graftaudit of the PyTorch port: the program-surface registry and the
op-level auditor (``deeplearning4j_tpu_torch/analysis/{programs,audit}.py``),
the cases of the JAX package's ``tests/test_audit.py`` with their PyTorch
meanings.

Each check is fed a seeded violation of its bug class (a bf16->f32 upcast,
a cache that stops updating in place or comes back copied, a tampered
collective contract, a host sync inside a family, a blown flop/byte
budget, a hole in the surface) and must flag it while staying quiet on
the blessed form beside it. The load-bearing cases: the registry audits
clean against the committed ``analysis/audit_baseline.json`` (its budgets
reproduce exactly), the surface equals what ``CompileCountGuard`` allows,
a live CPU engine's program keys lie inside it, the kernels are one op at
their bound, and the ``serve_mfu``/``serve_mbu`` gauges divide the
budgets by the measured seconds.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.analysis import audit as audit_mod
from deeplearning4j_tpu_torch.analysis import programs as programs_mod
from deeplearning4j_tpu_torch.analysis.audit import (
    budget_representatives,
    check_budgets,
    check_collectives,
    check_dtype,
    check_host_syncs,
    check_inplace,
    check_surface,
    default_baseline_path,
    load_baseline,
    main as audit_main,
    measure_spec,
    run_audit,
)
from deeplearning4j_tpu_torch.analysis.programs import (
    ProgramSpec,
    ServingGeometry,
    default_audit_config,
    default_audit_geometry,
    enumerate_programs,
    expected_surface,
    family_budgets,
)
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.ops import _leaf

torch.set_num_threads(1)

META = torch.device("meta")


def _spec(name, fn, args, inplace=(), tp=False, collectives=None,
          mesh=None):
    """A minimal hand-rolled ProgramSpec for single-check tests."""
    return ProgramSpec(name=name, family="synthetic", inplace=tuple(inplace),
                       tp=tp, collectives=dict(collectives or {}),
                       build=lambda: (fn, args, mesh))


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# -- check: dtype promotion -----------------------------------------------


def test_dtype_counts_injected_f32_upcast():
    def leaky(p):
        # the seeded bug: a bf16 intermediate silently promoted to f32
        return (p.float() * 2.0).bfloat16()

    spec = _spec("leaky", leaky, (_t(8, dtype=torch.bfloat16),))
    rec = measure_spec(spec)
    assert rec["f32_upcasts"] == 1
    fs = check_dtype(spec, rec, {"f32_upcasts": 0})
    assert [f.check for f in fs] == ["dtype"] and "drifted" in fs[0].message
    assert check_dtype(spec, rec, {"f32_upcasts": 1}) == []


def test_dtype_counts_promotion_inside_an_op():
    # a bf16 tensor times an f32 one: no cast op, but an f32 result
    spec = _spec("mixed", lambda a, b: a * b,
                 (_t(8, dtype=torch.bfloat16), _t(8)))
    assert measure_spec(spec)["f32_upcasts"] == 1


def test_dtype_flags_f64_unconditionally():
    spec = _spec("wide", lambda p: p.double(), (_t(4),))
    rec = measure_spec(spec)
    assert rec["f64_ops"] == 1
    fs = check_dtype(spec, rec, None)  # no baseline needed
    assert [f.check for f in fs] == ["dtype"] and "float64" in fs[0].message


def test_dtype_pure_bf16_program_is_clean():
    spec = _spec("pure", lambda p: p * 2, (_t(8, dtype=torch.bfloat16),))
    rec = measure_spec(spec)
    assert rec["f32_upcasts"] == 0
    assert check_dtype(spec, rec, {"f32_upcasts": 0}) == []


# -- check: the in-place update -------------------------------------------


def test_inplace_flags_a_cache_never_written():
    # the seeded bug: a cache arg declared in place, but the program
    # stopped writing it
    spec = _spec("drop", lambda c: c.sum(), (_t(4, 4),), inplace=(0,))
    fs = check_inplace(spec, measure_spec(spec))
    assert [f.check for f in fs] == ["inplace"]
    assert "never written" in fs[0].message


def test_inplace_flags_a_cache_copied_every_call():
    def copied(c, x):
        c = c.clone()  # the seeded bug: a fresh cache every call
        c[0] = x
        return c

    spec = _spec("copy", copied, (_t(4, 4), _t(4)), inplace=(0,))
    fs = check_inplace(spec, measure_spec(spec))
    assert any("fresh copy" in f.message for f in fs)


def test_inplace_write_through_a_view_is_clean():
    def update(c, x):
        c[:, 1].copy_(x)
        c[0].fill_(0)
        return c

    spec = _spec("ok", update, ({"k": _t(4, 4), "v": _t(4, 4)}["k"],
                                _t(4)), inplace=(0,))
    assert check_inplace(spec, measure_spec(spec)) == []


def test_inplace_matches_tree_leaves():
    def update(c, x):
        c["k"].add_(x)
        c["v"].mul_(x)
        return c, x.sum()

    spec = _spec("tree", update, ({"k": _t(2, 8), "v": _t(2, 8)}, _t(2, 8)),
                 inplace=(0,))
    assert check_inplace(spec, measure_spec(spec)) == []


# -- check: collective signature ------------------------------------------


@pytest.fixture(scope="module")
def tp_replay():
    geom = dataclasses.replace(default_audit_geometry(), tp=2, n_adapters=0)
    specs = enumerate_programs(default_audit_config(), geom)
    (spec,) = [s for s in specs if s.name == "replay[tp=2]"]
    return spec, measure_spec(spec)


def test_collectives_match_declared_contract(tp_replay):
    spec, rec = tp_replay
    assert rec["collectives"] == {"gather": 2 * 2 + 1}  # 2L + 1 a substep
    assert check_collectives(spec, rec) == []


def test_collectives_flag_contract_drift(tp_replay):
    spec, rec = tp_replay
    tampered = dataclasses.replace(spec, collectives={"gather": 3})
    fs = check_collectives(tampered, rec)
    assert [f.check for f in fs] == ["collectives"]
    assert "TP parity" in fs[0].message


def test_collectives_flag_stray_collective_in_single_device(tp_replay):
    spec, rec = tp_replay
    stray = dataclasses.replace(spec, tp=False, collectives={})
    fs = check_collectives(stray, rec)
    assert [f.check for f in fs] == ["collectives"]
    assert "single-device" in fs[0].message


def test_collectives_single_device_clean_program():
    spec = _spec("plain", lambda p: p + 1, (_t(4),))
    rec = measure_spec(spec)
    assert rec["collectives"] == {}
    assert check_collectives(spec, rec) == []


# -- check: host syncs ----------------------------------------------------


@pytest.mark.parametrize("body", [
    lambda p: p + p.sum().item(),
    lambda p: p * float(p[0]),
    lambda p: p[p > 0].sum() + p,
    lambda p: p + p.nonzero().shape[0],
    lambda p: p.cpu().sum() + 1,
])
def test_host_syncs_flag_a_readback_in_a_family(body):
    spec = _spec("chatty", body, (_t(4),))
    rec = measure_spec(spec)
    assert rec["host_syncs"]
    fs = check_host_syncs(spec, rec)
    assert [f.check for f in fs] == ["host-sync"]


def test_host_syncs_host_scalars_are_clean():
    # a Python scalar rounded through a host tensor is no readback
    def scaled(p):
        s = torch.tensor(3.0, dtype=torch.bfloat16).item()
        return p * s

    spec = _spec("quiet", scaled, (_t(4),))
    assert check_host_syncs(spec, measure_spec(spec)) == []


# -- the kernels as leaf ops ----------------------------------------------


def test_kernels_are_one_op_at_their_bound():
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
    )

    bh, t, d = 6, 32, 64
    spec = _spec("flash", lambda q, k, v: flash_attention_fwd(q, k, v, True),
                 tuple(_t(bh, t, d, dtype=torch.bfloat16) for _ in range(3)))
    rec = measure_spec(spec)
    assert rec["kernels"] == {"flash_attn_fwd": 1}
    # the plain version's matmuls are not counted: exactly the bound's
    # causal products
    assert rec["flops"] == 4 * bh * (t * (t + 1) // 2) * d
    assert rec["ops"] == 0
    assert _leaf.HOOK is None  # the seam is off again


def test_step_family_sees_decode_and_draw_kernels():
    specs = enumerate_programs(default_audit_config(),
                               dataclasses.replace(default_audit_geometry(),
                                                   tp=1, n_adapters=0))
    by = {s.name: s for s in specs}
    rec = measure_spec(by["step[K=2]"])
    n_layers = default_audit_config().n_layers
    assert rec["kernels"] == {"flash_decode": 2 * n_layers,
                              "threefry_draw": 2}
    rec = measure_spec(by["paged_masked_step[K=1]"])
    assert rec["kernels"] == {"flash_decode_paged": n_layers,
                              "threefry_draw": 1}
    rec = measure_spec(by["prefill[b=32]"])
    assert rec["kernels"] == {"flash_attn_fwd": n_layers}


# -- check: flop/byte budgets ---------------------------------------------


def test_budget_measurement_populates_flops_and_bytes():
    spec = _spec("mm", lambda a, b: a @ b, (_t(16, 16), _t(16, 16)))
    rec = measure_spec(spec)
    assert rec["flops"] == 2 * 16 * 16 * 16
    assert rec["temp_bytes"] == 16 * 16 * 4
    assert rec["arg_bytes"] == 2 * 16 * 16 * 4
    assert rec["out_bytes"] == 16 * 16 * 4


def test_budget_flags_blown_flop_and_temp_budget():
    spec = _spec("hog", lambda p: p, (_t(4),))
    rec = {"arg_bytes": 100, "out_bytes": 50, "flops": 1000,
           "temp_bytes": 4096}
    base = {"arg_bytes": 100, "out_bytes": 50, "flops": 500,
            "temp_bytes": 2048}
    fs = check_budgets(spec, rec, base)
    assert sorted(f.check for f in fs) == ["budget", "budget"]
    assert any("flops regression" in f.message for f in fs)
    assert any("temp_bytes regression" in f.message for f in fs)


def test_budget_within_tolerance_is_clean():
    spec = _spec("ok", lambda p: p, (_t(4),))
    rec = {"arg_bytes": 100, "out_bytes": 50, "flops": 1040,
           "temp_bytes": 2048}
    base = {"arg_bytes": 100, "out_bytes": 50, "flops": 1000,
            "temp_bytes": 2048}
    assert check_budgets(spec, rec, base) == []


def test_budget_flags_argument_surface_move():
    spec = _spec("grew", lambda p: p, (_t(4),))
    rec = {"arg_bytes": 128, "out_bytes": 50, "flops": None,
           "temp_bytes": None}
    fs = check_budgets(spec, rec, {"arg_bytes": 100, "out_bytes": 50})
    assert [f.check for f in fs] == ["budget"]
    assert "arg_bytes changed" in fs[0].message


def test_budget_representatives_pick_family_envelopes():
    geom = dataclasses.replace(default_audit_geometry(), tp=1, n_adapters=0)
    reps = budget_representatives(
        enumerate_programs(default_audit_config(), geom))
    assert "step[K=2]" in reps and "step[K=1]" not in reps
    assert "prefill[b=32]" in reps and "prefill[b=8]" not in reps
    assert "batch_prefill[b=32,n=4]" in reps
    assert "replay" in reps  # singletons are their own envelope


# -- check: the surface ---------------------------------------------------


def test_surface_clean_on_full_enumeration():
    cfg = default_audit_config()
    geom = ServingGeometry()
    assert check_surface(cfg, geom, enumerate_programs(cfg, geom)) == []


def test_surface_flags_missing_bucket_and_singleton():
    cfg = default_audit_config()
    geom = ServingGeometry()
    holey = [s for s in enumerate_programs(cfg, geom)
             if s.name not in ("prefill[b=16]", "seg_store")]
    fs = check_surface(cfg, geom, holey)
    assert any(f.program == "prefill" and "buckets" in f.message for f in fs)
    assert any("seg_store" in f.message for f in fs)


def test_surface_flags_duplicate_and_off_grid_programs():
    cfg = default_audit_config()
    geom = ServingGeometry()
    specs = enumerate_programs(cfg, geom)
    fs = check_surface(cfg, geom, specs + [specs[0]])
    assert any("duplicate" in f.message for f in fs)
    rogue = dataclasses.replace(specs[0], name="prefill[b=13]")
    fs = check_surface(cfg, geom, specs + [rogue])
    assert any(f.program == "prefill" for f in fs)


# -- the committed baseline -----------------------------------------------


@pytest.fixture(scope="module")
def committed_audit():
    baseline = load_baseline(default_baseline_path())
    assert baseline is not None, "commit analysis/audit_baseline.json"
    return baseline, run_audit(default_audit_config(),
                               default_audit_geometry(), baseline=baseline)


def test_port_audits_clean_against_committed_baseline(committed_audit):
    """Load-bearing: the registry, audited against the committed
    baseline, has zero findings (``audit --strict`` runs the same
    check)."""
    baseline, (records, findings, stale, errors, reps) = committed_audit
    assert errors == []
    assert [f.render() for f in findings] == []
    assert stale == []
    assert set(records) == set(baseline["programs"])


def test_committed_budgets_reproduce(committed_audit):
    """Every envelope's flops and temporary bytes, and every program's
    argument/output bytes, upcasts and collectives, equal the committed
    numbers exactly (the audit is shape math on meta tensors)."""
    baseline, (records, _, _, _, reps) = committed_audit
    for name, entry in baseline["programs"].items():
        rec = records[name]
        for key in ("arg_bytes", "out_bytes", "f32_upcasts", "collectives",
                    "kernels"):
            assert rec[key] == entry[key], (name, key)
        if name in reps:
            assert rec["flops"] == entry["flops"], name
            assert rec["temp_bytes"] == entry["temp_bytes"], name
        else:
            assert "flops" not in entry


def test_registry_surface_matches_committed_geometry():
    baseline = load_baseline(default_baseline_path())
    cfg = TransformerConfig.from_json(json.dumps(baseline["cfg"]))
    geom = ServingGeometry(**baseline["geometry"])
    assert cfg == default_audit_config() and geom == default_audit_geometry()
    names = {s.name for s in enumerate_programs(cfg, geom)}
    assert names == set(baseline["programs"])


# -- registry vs live engine ----------------------------------------------


@pytest.fixture(scope="module")
def tiny_engine():
    from deeplearning4j_tpu_torch.analysis.sanitizers import (
        CompileCountGuard,
    )
    from deeplearning4j_tpu_torch.models.transformer import init_params
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1,
                            d_ff=64, max_len=32)
    eng = ServingEngine(cfg, init_params(cfg, 0, device="cpu"), n_slots=2,
                        temperature=0.0, decode_horizon=2,
                        adaptive_horizon=True, prefill_max_bucket=16,
                        device="cpu")
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(Request(id=f"r{i}", prompt=rng.integers(
            1, 60, (3 + 6 * i,)).astype(np.int32), max_new=4))
    assert len(eng.run()) == 4
    CompileCountGuard(eng).assert_ok()
    geom = ServingGeometry(n_slots=2, max_total=cfg.max_len, decode_horizon=2,
                           adaptive_horizon=True, prefill_max_bucket=16)
    return eng, cfg, geom, CompileCountGuard(eng)


def test_live_engine_keys_inside_registry_surface(tiny_engine):
    """Every program key a live engine dispatched is one the registry
    enumerates for the same geometry: the auditor audits the programs the
    engine runs."""
    eng, cfg, geom, _ = tiny_engine
    exp = expected_surface(cfg, geom)
    names = {s.name for s in enumerate_programs(cfg, geom)}
    got = eng.program_keys
    assert got["step"] and got["prefill"] and got["chunk"]
    for fam in ("step", "prefill", "chunk", "batch_prefill", "batch_hit"):
        assert set(got[fam]) <= exp[fam], fam
    for k in got["step"]:
        assert f"step[K={k}]" in names
    for b in got["prefill"] | got["chunk"]:
        assert f"prefill[b={b}]" in names and f"chunk[b={b}]" in names
    for b, n in got["batch_prefill"]:
        assert f"batch_prefill[b={b},n={n}]" in names


def test_expected_surface_is_what_the_guard_allows(tiny_engine):
    eng, cfg, geom, guard = tiny_engine
    exp = expected_surface(cfg, geom)
    allowed = guard.allowed()
    for fam in ("step", "prefill", "chunk", "batch_prefill", "batch_hit"):
        assert allowed[fam] == exp[fam], fam


# -- the audit CLI --------------------------------------------------------


def _tiny_audit_surface(monkeypatch):
    """Shrink the CLI's default surface to a small grid (the machinery
    is the same)."""
    monkeypatch.setattr(
        programs_mod, "default_audit_config",
        lambda: TransformerConfig(
            vocab_size=64, d_model=32, n_heads=2, n_kv_heads=2, n_layers=1,
            d_ff=64, max_len=16, compute_dtype=torch.bfloat16,
            use_flash=True))
    monkeypatch.setattr(
        programs_mod, "default_audit_geometry",
        lambda: ServingGeometry(n_slots=2, max_total=16, decode_horizon=1,
                                adaptive_horizon=False, prefill_max_bucket=8,
                                prefix_segments=1))


def test_audit_cli_exit_codes(tmp_path, monkeypatch):
    _tiny_audit_surface(monkeypatch)
    bl = tmp_path / "audit_baseline.json"
    report = tmp_path / "report.json"
    assert audit_main(["--baseline", str(bl), "--write-baseline"]) == 0
    assert audit_main(["--baseline", str(bl), "--strict",
                       "--json-out", str(report)]) == 0
    out = json.loads(report.read_text())
    assert out["findings"] == [] and out["programs"]
    data = json.loads(bl.read_text())
    assert data["version"] == 1
    # a program missing from the baseline is a finding outright
    dropped = dict(data, programs=dict(data["programs"]))
    del dropped["programs"]["logit_row"]
    bl.write_text(json.dumps(dropped))
    assert audit_main(["--baseline", str(bl)]) == 1
    # a stale entry only fails under --strict (mirrors graftlint)
    ghost = dict(data, programs=dict(data["programs"]))
    ghost["programs"]["ghost[b=99]"] = {"collectives": {}}
    bl.write_text(json.dumps(ghost))
    assert audit_main(["--baseline", str(bl)]) == 0
    assert audit_main(["--baseline", str(bl), "--strict"]) == 1
    assert audit_main(["--no-baseline"]) == 0


def test_audit_cli_rejects_unknown_baseline_version(tmp_path, monkeypatch):
    _tiny_audit_surface(monkeypatch)
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 99, "programs": {}}))
    with pytest.raises(ValueError, match="unsupported baseline"):
        audit_main(["--baseline", str(bl)])


def test_audit_strict_exits_0_on_the_committed_baseline(capsys):
    assert audit_main(["--strict"]) == 0
    assert "0 finding(s), 0 stale, 0 error(s)" in capsys.readouterr().out


@pytest.mark.parametrize("seed", ["upcast", "host_sync"])
def test_audit_cli_catches_a_seeded_fault_in_a_family(monkeypatch, capsys,
                                                      seed):
    """Against the committed baseline, a family with a planted bf16->f32
    upcast or a planted host sync makes ``audit`` exit 1."""
    def seg_fetch():
        def fetch(region, seg: int, out=None):
            x = region[:, :, seg:seg + 1]
            if seed == "upcast":
                return x.float().to(region.dtype)
            return x.clone() * int(x.sum().item() == 0)
        return fetch

    monkeypatch.setattr(programs_mod, "build_seg_fetch_program", seg_fetch)
    assert audit_main([]) == 1
    out = capsys.readouterr().out
    check = "dtype" if seed == "upcast" else "host-sync"
    assert f"seg_fetch: [{check}]" in out


# -- the MFU/MBU gauges ---------------------------------------------------


def test_family_budgets_from_the_committed_baseline():
    budgets = family_budgets()
    for fam in ("step", "masked_step", "paged_step", "paged_masked_step",
                "prefill", "paged_prefill", "chunk", "batch_prefill",
                "batch_hit"):
        assert budgets[fam]["flops"] > 0 and budgets[fam]["bytes"] > 0, fam
    data = load_baseline(default_baseline_path())["programs"]
    env = data["step[K=2]"]
    assert budgets["step"] == {"flops": env["flops"],
                               "bytes": env["arg_bytes"] + env["out_bytes"]}


def test_gauges_need_budgets_and_the_cards_peaks(monkeypatch):
    from deeplearning4j_tpu_torch.serving import metrics as metrics_mod
    from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics

    m = ServingMetrics()
    m.device = torch.device("cpu")
    m.record_program("step", 0.5)
    m.record_program("step", 0.5)
    text = m.render_prometheus()
    assert 'serve_mfu{family="step"}' not in text  # seconds only
    assert 'serve_program_dispatches_total{family="step"} 2' in text
    assert metrics_mod.device_peaks(torch.device("cpu")) is None

    m = ServingMetrics()
    monkeypatch.setattr(metrics_mod, "device_peaks", lambda dev: (1e9, 1e8))
    m.record_program("step", 0.5)
    m.record_program("step", 0.5)
    text = m.render_prometheus()
    b = family_budgets()["step"]
    mfu = float(next(x for x in text.splitlines()
                     if x.startswith('serve_mfu{family="step"}')).split()[-1])
    mbu = float(next(x for x in text.splitlines()
                     if x.startswith('serve_mbu{family="step"}')).split()[-1])
    assert mfu == pytest.approx(min(1.0, b["flops"] * 2 / 1.0 / 1e9))
    assert mbu == pytest.approx(min(1.0, b["bytes"] * 2 / 1.0 / 1e8))


def test_device_peaks_know_the_h100_by_name(monkeypatch):
    from deeplearning4j_tpu_torch.serving import metrics as metrics_mod

    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
                       ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev, name=name: name)
        assert metrics_mod.device_peaks(torch.device("cuda")) == want
