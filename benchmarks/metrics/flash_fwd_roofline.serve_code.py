"""#1 (csrc/flash_attn_fwd.cu) at prefill in the traced serving steps: the
sum of its launches' bounds over their device time."""

from benchmarks.harness.readers import flash_fwd_roofline


def read(rec):
    return flash_fwd_roofline(rec)
