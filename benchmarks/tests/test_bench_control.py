"""The control must come out not correct: the plain reference put in the
program's place and computed with fp8 operands, the next precision below
the cells' bf16, judged against the float32 reference under each cell's
committed limits. At a size a CPU test run holds; the cell-size readings
the limits were set from are in PERF.md."""

import math

import numpy as np
import pytest
import torch

from benchmarks.harness import train, weights
from benchmarks.reference import gpt2_plain
from benchmarks.tests import tiny_cells

torch.set_num_threads(2)
SEEDS = [11, 22, 33]


@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails_a_limit(seed):
    cell = tiny_cells.cell("train-gpt2-xl-t1024")
    dev = torch.device("cpu")
    ref = train.reference_readings(cell, seed, dev)
    low = train.reference_readings(cell, seed, dev, prec="fp8")
    nums = train.judge(low, ref, cell["cell"]["check"])
    assert any(v > lim for v, lim in nums.values()), nums


@pytest.mark.parametrize("name", ["serve-gpt2-medium-bulk",
                                  "serve-gpt2-xl-code"])
def test_serving_control_fails_the_gap_limit(name):
    from deeplearning4j_tpu_torch.models.transformer import param_shapes

    from benchmarks.harness.model import transformer_config

    cell = tiny_cells.cell(name)
    cfg = cell["config"]
    tcfg = transformer_config(cfg, cell["cell"]["model"])
    worst = []
    for seed in SEEDS:
        params = weights.make_params(param_shapes(tcfg), seed, cfg["n_embd"],
                                     cfg["n_inner"], torch.device("cpu"),
                                     torch.bfloat16)
        rng = np.random.default_rng(seed)
        gap = 0.0
        for _ in range(4):
            prompt = torch.as_tensor(rng.integers(0, cfg["vocab_size"], 60))
            seq = prompt
            for _ in range(12):  # the reference's own greedy tokens
                nxt = gpt2_plain.logits(params, seq, cfg["n_head"])[-1]
                seq = torch.cat([seq, nxt.argmax()[None]])
            _, ctl = gpt2_plain.served_gaps(params, prompt, seq[60:],
                                            cfg["n_head"], "fp8")
            gap = max(gap, float(ctl.max()))
        worst.append(gap)
    limit = cell["cell"]["check"]["max_gap"]
    assert min(worst) > limit or math.isinf(min(worst)), (worst, limit)
