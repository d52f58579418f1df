"""The committed cells cut to a size a CPU test run holds: the cell's own
settings, traffic and limits, a two-layer model of GPT-2's block.

The program runs in float32 here: at this width bf16 rounding is not
averaged down as it is at the cells' (a 64-wide loss moves by ~1e-4 of
itself, GPT-2-XL's by ~1e-5), so these cells test the harness's plumbing
and its faults against the committed limits, not the program's
precision, which the cell-size readings in PERF.md do."""

import copy

import torch

from benchmarks.harness import core

TINY = {"name": "tiny", "n_embd": 64, "n_layer": 2, "n_head": 4,
        "n_inner": 256, "vocab_size": 256, "n_positions": 128}


def cell(name: str, traffic: str | None = None) -> dict:
    """The cell ``name`` at the tiny size; ``traffic`` serves another mix
    of ``traffic/`` in its place."""
    c = copy.deepcopy(core.find_cell(name))
    if traffic is not None:
        c["traffic"] = core.load_json(core.BENCH / "traffic"
                                      / f"{traffic}.json")
    c["config"] = dict(TINY)
    c["cell"]["model"]["compute_dtype"] = "float32"
    if c["cell"]["mode"] == "train":
        c["traffic"]["seq"] = 64
        c["cell"]["trainer"]["batch"] = 4
        c["cell"]["check"]["ref_rows"] = 2
        return c
    c["cell"]["engine"].update(n_slots=8, max_total=128,
                               prefill_max_bucket=128)
    c["cell"]["scheduler"]["max_queue_depth"] = 4
    tr = c["traffic"]
    tr["prompt"].update(median=40, min=20, max=100)
    tr["output"].update(min=6, max=12)
    if "rate" in tr["arrivals"]:
        tr["arrivals"]["rate"] = 20.0
        c["cell"]["warmup_s"] = 0.3
        c["cell"]["drain_s"] = 60.0
    c["cell"]["trace_steps"] = 4
    c["cell"]["check"]["sample"] = 6
    return c


def run(c: dict, seed: int = 12345678901, seconds: float = 1.0,
        trace: bool = False) -> dict:
    """One run of the cell on the CPU, as ``run.py`` would make it, and
    its result line."""
    import time

    from benchmarks import run as bench_run

    torch.set_num_threads(2)
    dev = torch.device("cpu")
    res = bench_run.run_cell(c, seed, seconds, trace, dev,
                             time.perf_counter())
    return bench_run.result_line(c, res, trace, dev)
