"""#3 (csrc/flash_decode.cu) in the traced decode horizons: for every token
they generated, a layer reads the token's visible cache rows (its position
+ 1), q and the output (counts.flash_decode); their bound over #3's device
time. A slot that finished inside a horizon still runs to its end; its
rows are not counted, so the share errs low."""

from benchmarks import counts


def read(rec):
    tr, w = rec["trace"], rec["work"]
    if tr is None or not w.get("decode_tokens"):
        return None
    secs = sum(dur for _, _, dur, _ in tr.kernels("flash_decode")) / 1e6
    if secs <= 0:
        return None
    ops, nbytes = counts.flash_decode(w["decode_rows"], w["decode_tokens"],
                                      w["d"])
    return 100.0 * w["n_layer"] * counts.bound_s(ops, nbytes) / secs
