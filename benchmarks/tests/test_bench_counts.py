"""The operation and byte counts against hand counts at the cells' shapes."""

import json
from pathlib import Path

import pytest

from benchmarks import counts

BENCH = Path(__file__).resolve().parents[1]


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_gpt2_xl_train_flops_per_token():
    # 48 x (4 x 1600^2 + 2 x 1600 x 6400) + 1600 x 50257 matmul weights,
    # x 6, plus 6 x 1024 x 1600 x 48 for causal attention
    xl = _cfg("gpt2-xl")
    assert counts.matmul_params(xl) == 1_554_971_200
    assert counts.train_flops_per_token(xl, 1024) == 9_801_686_400


def test_gpt2_medium_matmul_params():
    # 24 x (4 x 1024^2 + 2 x 1024 x 4096) + 1024 x 50257
    assert counts.matmul_params(_cfg("gpt2-medium")) == 353_453_056


def test_flash_decode_at_the_bulk_cells_batch():
    # B 512 slots, each at position 699 (700 visible rows), d 1024, bf16:
    # K and V rows, q in and the output, int32 positions
    rows = 512 * 700
    ops, nbytes = counts.flash_decode(rows, 512, 1024)
    assert ops == 4 * 358_400 * 1024
    assert nbytes == 1_468_006_400 + 2_097_152 + 2_048


def test_flash_fwd_and_bwd_at_the_training_shape():
    # BH 250 (batch 10 x 25 heads), T 1,024, D 64: 524,800 causal pairs
    ops, nbytes = counts.flash_fwd(250, 1024, 64)
    assert ops == 33_587_200_000
    assert nbytes == 132_096_000
    ops, nbytes = counts.flash_bwd(250, 1024, 64)
    assert ops == 83_968_000_000
    assert nbytes == 263_168_000


@pytest.mark.parametrize("t", [1, 7, 64, 130])
def test_causal_pairs_match_a_loop(t):
    pairs = sum(1 for i in range(t) for j in range(t) if j <= i)
    ops, _ = counts.flash_fwd(1, t, 1)
    assert ops == 4 * pairs


def test_prefill_and_decode_flops_add_up_to_a_forward():
    # a prompt of n then one decoded token costs what a forward over n + 1
    # tokens does, but for the head, which prefill takes once
    xl = _cfg("gpt2-xl")
    d, v = xl["n_embd"], xl["vocab_size"]
    n = 700
    whole = counts.prefill_flops(xl, n + 1)
    split = counts.prefill_flops(xl, n) + counts.decode_flops(xl, n + 1)
    assert split - whole == pytest.approx(2.0 * d * v)


def test_bound_takes_the_larger_side():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
