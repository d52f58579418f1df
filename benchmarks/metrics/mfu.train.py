"""The training step's share of the card's bf16 peak: analytic model FLOPs
a token (counts.train_flops_per_token) x the window's tokens/s."""

from benchmarks import counts


def read(rec):
    w = rec["window"]
    if rec["kind"] != "train" or not w.get("train_tokens_per_s"):
        return None
    flops = counts.train_flops_per_token(rec["config"], rec["work"]["t"])
    return 100.0 * flops * w["train_tokens_per_s"] / counts.PEAKS["bf16_flops"]
