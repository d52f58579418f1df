"""The model's share of the card's bf16 peak in the window: the FLOPs of
every prompt admitted and every token generated in it
(counts.prefill_flops, counts.decode_flops) over the window."""

from benchmarks.harness.readers import mfu_serve


def read(rec):
    return mfu_serve(rec)
