"""A training cell: ``transformer_train_step`` with its AdamW, on batches
from the traffic mix, and the check against the plain reference.

Set-up builds the one step object and its state, drives it through its
first three steps with the window's own call and feed, and reads from it
the three losses, each leaf's first gradient (from AdamW's first moment
after one step: mu = (1 - b1) g) and each leaf's change after the third
step (each leaf made again from the seed). The window then runs the same
object on. After the window, with the program's state freed, the
reference runs the same three steps in float32 from the same weights and
batches, and three numbers are compared, each against its limit in the
cell file:

- ``loss_rel``: the largest relative gap of the three losses;
- ``grad_gap``: over the leaves, the largest gap between the program's
  first-gradient norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for each leaf's change after three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

from benchmarks.harness import weights
from benchmarks.harness.core import Spans, log, refuse_unknown
from benchmarks.harness.devtrace import WINDOW_SPAN, read_profile
from benchmarks.reference import gpt2_plain
from benchmarks.traffic.generator import MIX_KEYS, lm_batch

ADAM_B1 = 0.9
CHECK_STEPS = 3
#: what a training cell's file holds; ``trainer.optimizer`` goes to
#: ``lm_optimizer`` as keyword arguments, ``model`` to
#: ``transformer_config``
CELL_KEYS = frozenset({"mode", "config", "traffic", "chips", "model",
                       "trainer", "trace_steps", "check"})
TRAINER_KEYS = frozenset({"batch", "optimizer"})


def gap(prog: dict, ref: dict, names) -> float:
    """The largest |prog - ref| over ``names``, each over the larger of
    the reference's value and the median of the reference's values."""
    med = statistics.median(ref.values())
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def judge(prog: dict, ref: dict, limits: dict) -> dict:
    """name -> (value, limit) of the three numbers compared."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                      ref["losses"]))
    if not all(math.isfinite(x) for x in prog["losses"]):
        loss_rel = math.inf
    med = statistics.median(ref["grad"].values())
    counted = [n for n, g in ref["grad"].items() if g >= 1e-3 * med]
    return {
        "loss_rel": (loss_rel, limits["loss_rel"]),
        "grad_gap": (gap(prog["grad"], ref["grad"], ref["grad"]),
                     limits["grad_gap"]),
        "change_gap": (gap(prog["change"], ref["change"], counted),
                       limits["change_gap"]),
    }


def reference_readings(cell: dict, seed: int, device, prec: str = "f32",
                       half_batch: bool = False) -> dict:
    """The reference's three steps from the seed's weights and batches."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import param_shapes

    from benchmarks.harness.model import transformer_config

    cfg, tr, mix = cell["config"], cell["cell"]["trainer"], cell["traffic"]
    tcfg = transformer_config(cfg, cell["cell"]["model"])
    p0 = weights.make_params(param_shapes(tcfg), seed, cfg["n_embd"],
                             cfg["n_inner"], device, torch.float32)
    batches = [lm_batch(mix, seed, i, tr["batch"], cfg["vocab_size"], device)
               for i in range(CHECK_STEPS)]
    losses, first, change = gpt2_plain.train_steps(
        p0, batches, cfg["n_head"], tr["optimizer"], prec,
        rows=cell["cell"]["check"]["ref_rows"], half_batch=half_batch)
    return {"losses": losses, "grad": first, "change": change}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer,
        param_shapes,
        transformer_train_step,
    )

    from benchmarks.harness.model import transformer_config

    cfg, c, mix = cell["config"], cell["cell"], cell["traffic"]
    tr = c["trainer"]
    refuse_unknown("trainer", tr, TRAINER_KEYS)
    refuse_unknown("traffic", mix, MIX_KEYS["lm_batches"])
    tcfg = transformer_config(cfg, c["model"])
    opt = lm_optimizer(**tr["optimizer"])
    step, _, _ = transformer_train_step(None, tcfg, optimizer=opt,
                                        device=device)
    shapes = param_shapes(tcfg)
    d, f, vocab, b, seq = (cfg["n_embd"], cfg["n_inner"], cfg["vocab_size"],
                           tr["batch"], mix["seq"])
    params = weights.make_params(shapes, seed, d, f, device, torch.float32)
    state = opt.init(params)
    spans = Spans()
    log("weights and optimizer state made")

    def one(i):
        nonlocal params, state
        with spans("bench.batch"):
            tok = lm_batch(mix, seed, i, b, vocab, device)
        with spans("bench.train_step"):
            params, state, loss = step(params, state, tok)
        return loss

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the first steps: the window's own call and feed, read for the check
    losses, grad = [], None
    for i in range(CHECK_STEPS):
        losses.append(one(i).detach().clone())
        if i == 0:
            grad = {n: torch.linalg.vector_norm(m.float()) / (1 - ADAM_B1)
                    for n, m in gpt2_plain.leaves(state["mu"])}
    change = {}
    with torch.no_grad():
        for n, p in gpt2_plain.leaves(params):
            p0 = weights.remake_leaf(shapes, n, seed, d, f, device)
            change[n] = torch.linalg.vector_norm((p - p0).float())
            del p0
    prog = {"losses": [float(x) for x in losses],
            "grad": {n: float(v) for n, v in grad.items()},
            "change": {n: float(v) for n, v in change.items()}}
    del grad, change
    sync()
    log(f"first {CHECK_STEPS} steps read; window starts")
    gc.collect()
    gc.freeze()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i, loss = CHECK_STEPS, losses[-1]
    while time.perf_counter() - t0 < seconds:
        loss = one(i)
        i += 1
    sync()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    steps = i - CHECK_STEPS
    last_loss = float(loss)
    log(f"window done ({steps} steps)")

    dtrace, traced_steps = None, 0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        traced_steps = int(c["trace_steps"])
        spans.profiling = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                sync()
                for _ in range(traced_steps):
                    one(i)
                    i += 1
                sync()
        spans.profiling = False
        dtrace = read_profile(prof)
        log("traced steps read")

    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    del params, state, step, loss
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    log("program state freed; reference check starts")
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device)
    check = judge(prog, ref, c["check"])
    if not math.isfinite(last_loss):
        check["last_loss"] = (math.inf, 0.0)
    tokens = steps * b * seq
    return {
        "setup_s": setup_s,
        "e2e": {"train_tokens_per_s": tokens / window_s if steps else None},
        "record": {
            "kind": "train", "config": cfg, "cell": c,
            "window": {"seconds": window_s, "steps": steps,
                       "tokens": tokens,
                       "train_tokens_per_s": (tokens / window_s if steps
                                              else None)},
            "trace": dtrace,
            "work": {"steps": traced_steps, "bh": b * cfg["n_head"],
                     "t": seq, "d": d // cfg["n_head"]},
        },
        "check": check,
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": peak,
        "reference_s": time.perf_counter() - t_ref,
        "readings": {"program": prog, "reference": ref},
    }
