"""BENCHMARK.json and the files it names: the contract's naming rules, and
that the harness finds a cell's files by name alone."""

import importlib.util
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from benchmarks.harness import core, model, serve
from benchmarks.traffic import generator

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmarks"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


@pytest.mark.parametrize("item", [c["name"] for c in MAN["configs"]]
                         + [w["name"] for w in MAN["workloads"]]
                         + [m["name"] for m in _metrics()]
                         + [w["traffic"] for w in MAN["workloads"]])
def test_names(item):
    assert NAME.match(item), item


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], _metrics()):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", _metrics(), ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def _reports(cell: str, metric: str) -> bool:
    m = next(x for x in MAN["end_to_end"] if x["name"] == metric)
    return cell in m.get("workloads", [cell])


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_they_move(m):
    assert any(e["name"] == m["moves"] for e in MAN["end_to_end"])
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for cell in cells:
        assert _reports(cell, m["moves"]), (m["name"], cell)


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(w):
    e2e = [m["name"] for m in MAN["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]])
               for m in MAN["per_layer"])
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_layer_names_one_spelling():
    # one layer, one name, letter for letter
    by_key = {}
    for m in MAN["per_layer"]:
        by_key.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_key.values())


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = core.find_cell(w["name"])
    assert cell["cell"]["config"] == w["config"]
    assert cell["cell"]["traffic"] == w["traffic"]
    assert cell["cell"]["chips"] == w["chips"]
    mode = cell["cell"]["mode"]
    assert callable(importlib.import_module(f"benchmarks.harness.{mode}").run)


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_every_setting_written_is_applied(w):
    cell = core.find_cell(w["name"])
    mode = importlib.import_module("benchmarks.harness."
                                   + cell["cell"]["mode"])
    core.refuse_unknown(w["name"], cell["cell"], mode.CELL_KEYS)
    core.refuse_unknown(w["traffic"], cell["traffic"],
                        generator.MIX_KEYS[cell["traffic"]["kind"]])
    with pytest.raises(ValueError, match="cache"):
        core.refuse_unknown(w["name"], dict(cell["cell"], cache="paged"),
                            mode.CELL_KEYS)


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in MAN["workloads"]}))
def test_traffic_pieces_found_by_name(mix):
    data = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    if data["kind"] != "requests":
        return
    proc = generator.piece("arrivals", data["arrivals"]["process"])
    u = np.array([0.25, 0.75])
    gaps = proc.gaps(data["arrivals"], u)
    assert (gaps is None) == (proc.rate(data["arrivals"]) is None)
    for side in ("prompt", "output"):
        spec = data[side]
        q = generator.piece("lengths", spec["dist"]).quantiles(spec, u)
        assert q[0] <= q[1]


def test_unknown_traffic_piece_is_refused():
    with pytest.raises(ValueError, match="no traffic/arrivals/no_such.py"):
        generator.piece("arrivals", "no_such")


@pytest.mark.parametrize("key", model.KERNEL_SWITCHES)
def test_a_cell_cannot_switch_a_kernel_off(key):
    cfg = json.loads((BENCH / "configs" / "gpt2-medium.json").read_text())
    assert model.transformer_config(cfg, {"compute_dtype": "bfloat16"}
                                    ).use_flash
    with pytest.raises(ValueError, match=key):
        model.transformer_config(cfg, {key: False})


@pytest.mark.parametrize("key", sorted(serve.HARNESS_SET))
def test_the_harness_sets_sampling_and_plumbing(key):
    cell = core.find_cell("serve-gpt2-medium-bulk")
    cell["cell"]["engine"][key] = 0.5
    with pytest.raises(ValueError, match=key):
        serve.build_engine(cell, 1, None, trace=False)


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    f = ROOT / c["file"]
    assert f.is_relative_to(BENCH)
    data = json.loads(f.read_text())
    assert data["reduced"] == c["reduced"]
    for key in ("n_embd", "n_layer", "n_head", "n_inner", "vocab_size",
                "n_positions", "departures", "assumed"):
        assert key in data
    assert len(c["source"]) <= 200 and len(data["source"]) <= 200


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_every_reader_loads(m):
    path = BENCH / "metrics" / f"{m['name']}.py"
    spec = importlib.util.spec_from_file_location("r", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = {"kind": "x", "trace": None, "work": {}, "config": {},
           "cell": {}, "window": {"seconds": 1.0}}
    assert mod.read(rec) is None  # nothing to read: no number, never 0


def test_a_new_cell_is_found_without_an_edit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = dict(man["workloads"][1], name="serve-gpt2-medium-short")
    man["workloads"].append(w)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    src = tmp_path / "benchmarks" / "workloads"
    shutil.copy(src / f"{man['workloads'][1]['name']}.json",
                src / "serve-gpt2-medium-short.json")
    cell = core.find_cell("serve-gpt2-medium-short", root=tmp_path)
    assert cell["entry"]["name"] == "serve-gpt2-medium-short"
    assert cell["config"]["name"] == "gpt2-medium"
    with pytest.raises(KeyError):
        core.find_cell("no-such-cell", root=tmp_path)


def test_manifest_small():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
