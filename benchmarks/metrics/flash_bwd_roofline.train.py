"""#2 (csrc/flash_attn_bwd.cu) in the traced training steps: one launch
(its dK/dV and dQ kernels) a layer a step at the cell's (B H, T, D), its
bound over the device time of both kernels."""

from benchmarks import counts


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    ks = tr.kernels("flash_bwd")
    launches = len(tr.kernels("flash_bwd_dq"))
    secs = sum(dur for _, _, dur, _ in ks) / 1e6
    if not launches or secs <= 0:
        return None
    w = rec["work"]
    ops, nbytes = counts.flash_bwd(w["bh"], w["t"], w["d"])
    return 100.0 * launches * counts.bound_s(ops, nbytes) / secs
