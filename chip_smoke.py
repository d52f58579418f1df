#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without printing a result:

1. build every CUDA kernel of ``deeplearning4j_tpu_torch/csrc`` with nvcc
   (all sources at once) and print the build time and the card;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving, training and decode-variant paths give it (phases
   3-7 record the shape of every launch of #1-#4 and fail on one not held
   here; #5 is held at phase 6's first full-width batch), and time
   kernel, plain
   version, bound and one library call (a yardstick the port never calls;
   none computes int8 or paged decode). The decode kernel runs in bf16 and
   int8 mode, also at positions on either side of its split edges, in int8
   at the reference's default tile (one 640-row tile) and at 64 rows, with
   a tile too long for its scores to stay in shared memory (they go to the
   wrapper's scratch tensor), and each row of a B 8 launch again alone
   (B 1), bitwise; the decode kernels are timed eagerly (``ms``, as every
   kernel) and on the device alone (``graph_ms``: a CUDA graph of
   launches, since one call's host path outlasts the kernel), with the
   grid and cluster of their launch; the paged decode kernel in both modes
   at block sizes 8 and
   64 over shuffled tables with an aliased block, also held BITWISE against
   the slab kernel over the gathered slab; the fused embedding dot (#5)
   in its dense mode (the reference's function and the range flag) at
   Word2Vec's batch (4,096 pairs, D 100) for L 16 and for phase 6's
   longest Huffman path, and with masked rows and dots planted at 6 -+
   1e-3 (no library call computes it: the time of ``torch.bmm`` for the
   dot alone is printed beside it); and in its fused mode (the HS step's
   gathers, dots, g, grad_in and delta rows, written at the scatter
   plan's positions) at the same batch for L 16, for the longest path with
   planted dots and masked rows, and on phase 6's first batch, each also
   timed on the device alone (``graph_ms``) and run twice, bitwise;
3. serve the GPT-2-small configuration (random weights from a seed) through
   ``ServingEngine``: about eight greedy requests, some past the 128-token
   prefill bucket, with every kernel's launch count set to 0 just before and
   read just after; two streams are held against the port's
   ``transformer_generate``;
3b. the same with int8 weights and the int8 KV cache (``decode_int8``,
   ``quantize_decode_params``): the int8 mode of the decode kernel must
   launch, two streams are held against ``transformer_generate`` on the
   quantized model;
3c. the runs of 3 and 3b again with the KV cache block-paged (block size
   8): the engine must come up paged, the paged kernel must launch and the
   slab decode kernel not, every stream must be byte-identical to its slab
   run's, and every block must come back;
4. answer three ``POST /v1/generate`` and a ``GET /healthz`` through
   ``ServingServer`` on an ephemeral port, then stop it;
5. train the reference bench's "transformer" preset (GPT-2-small widths,
   seq 1024, batch 24, flash, remat ``dots_no_batch``, bf16 compute, f32
   params; random weights and one fixed batch from seed 0) through
   ``transformer_train_step`` with ``lm_optimizer``: 2 warm-up steps, then 6
   timed ones with the flash launch counts set to 0 just before and read just
   after; the loss must be finite and fall. Then, on a 2-layer model of the
   same widths at T 1024, B 2: flash vs dense attention (loss within 1e-2
   relative, every gradient leaf at cosine >= 0.99) and remat on vs off
   (bitwise equal: every kernel of the path is deterministic);
6. word2vec: Word2Vec.fit at full width (word2vec.c's size 100 and window
   5, batches of 4,096 pairs, HS) on a synthetic corpus of text8's shape
   (4,000 sentences of 1,000 tokens, Zipf(1.0) over 71,290 word types,
   seed 0); the same model with ``negative=5`` on the first 500 sentences
   (the per-batch HS+NS path); a small fit (the reference tests' topic
   corpus, D 32, 4 epochs) on the card and on the CPU from the same tables
   (within the CPU tests' tolerance) and twice on the card (bitwise equal,
   the first with TF32 allowed); the reference's topic-similarity check on
   the card; ParagraphVectors.fit_labeled with HS, and with HS+NS. Kernel
   #5's launch count is set to 0 before every run and must be > 0 after;
   the full-width tables must be finite with max |syn0| under 1,000;
7. decode variants and checkpoints, at full width: ``cli.main(["train",
   "--preset", "gpt2s", ..., "--checkpoint-dir", D, "--save-every",
   "2"])`` for 4 steps (both checkpoints there, step 4 and the preset's
   config in the meta, the restored params bitwise the npz arrays, each
   write and the restore timed), then ``generate --beam 4`` and ``generate
   --int8 full --temperature 0`` from D (the reference's printed lines;
   flash prefill and the decode kernel, int8 mode in the second, must
   launch); beam search (B 1, W 4, prompt 128, 32 new) on phase 3's model
   in bf16 and int8 full: W 1 bitwise greedy generate, scores sorted and
   equal bitwise to the beams' own tokens teacher-forced through the same
   decode program (a planted stale cache must fail this check), and each
   within a stated tolerance of its sequence's log-likelihood by f32
   ``transformer_apply``, ms a beam step; speculative decoding at the
   reference bench's spec row (GQA 6/2 heads, rope, prompt 512, 64 new, k
   4, the int8-weight self-draft): greedy held against generate (at the
   first divergence generate's top-2 gap must be at most twice the largest
   logit difference between the two programs there), sampled runs equal
   per generator seed, exactly one host sync a round (PyTorch's sync debug
   mode), rounds and acceptance, and tokens/s of speculative vs plain
   generate, 5 runs a side in turns. Phase 2 holds every shape these
   runs launch #1, #2 and #3 at, among them the draft steps' (B 1, G 3,
   Hkv 2, K 128, Tpad 584).

The last lines are the kernel table as one JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import random
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

#: H100 SXM published dense int8 tensor rate (operations/s)
INT8_OPS = 1979e12

#: H100 SXM published f32 rate outside the tensor cores (FLOP/s)
F32_FLOPS = 67e12

#: stated tolerances, kernel vs plain version on the same bf16 inputs: the
#: kernel's online softmax rounds its probabilities to bf16 against the
#: running max of each tile (the flash kernels) or of each 32-row stage of
#: a T split (the decode kernel), the plain version against the row max
ATTN_TOL = 2e-2
LSE_TOL = 1e-3
#: int8 decode kernels vs their plain versions, in bf16 steps of the
#: output: the same integer products, divisions and roundings in the same
#: order; only l, the sum of a tile's softmax weights, is added up in
#: another order, which can move the output's bf16 rounding by one step
INT8_STEPS = 1
#: flash backward vs its plain version, per gradient: the reference's own
#: on-device gate for its flash backward (bench.py:392); bf16 gradients,
#: summed in other orders
GRAD_REL, GRAD_ABS = 0.02, 0.01
#: a greedy mismatch between engine and generate is reported as a near-tie
#: (cuBLAS reduces an M=1 and an M=8 product in different orders) when the
#: generate side's top-2 logit gap at that position is below this
NEAR_TIE = 0.1
#: kernel #5 vs its plain version (f32): the dot is summed in another order
#: (the reference's own test holds its kernel to XLA at 1e-5)
EMB_TOL = 1e-5
#: word2vec fit on the card vs on the CPU from the same tables: the CPU
#: tests' bar for the port against the JAX package (last-bit differences of
#: the sums carried through every later batch, in a configuration that does
#: not amplify them)
W2V_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    launch path (the Python wrapper, ctypes) is left out. For calls that
    the host, not the card, bounds when launched one by one."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(nbytes: float, flops: float,
          peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 -----------------------------------------------------------------

def phase_build() -> float:
    from deeplearning4j_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"build: {', '.join(built) or 'cached'} in {secs:.2f} s "
        f"({', '.join(_build.sources())})")
    for stem, text in sorted(_build.build_logs.items()):
        for name, used, frame in _ptxas_entries(text):
            log(f"  ptxas[{stem}] {name}: {used}; {frame}")
    return secs


def _ptxas_entries(text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, stack and spill line) of every entry
    function in a ``ptxas -v`` log, the names demangled where the toolkit's
    ``cu++filt`` is found."""
    import re
    import shutil

    from deeplearning4j_tpu_torch.ops import _build

    rows, cur, frame = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur, frame = m.group(1), ""
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and cur:
            rows.append([cur, line.split(":", 1)[-1].strip(), frame])
            cur = None
    filt = (shutil.which("cu++filt", path=str(Path(_build.nvcc()).parent))
            or shutil.which("c++filt"))
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                n = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", n)
                n = n.replace("(bool)0", "false").replace("(bool)1", "true")
                n = re.sub(r"\(int\)(-?\d+)", r"\1", n)
                r[0] = n.removeprefix("void ").split("(", 1)[0]
    return [tuple(r) for r in rows]


# -- phase 2 -----------------------------------------------------------------

#: (kernel, shape) of every case phase 2 held against a plain version;
#: the run fails on a launch of #1-#4 in phases 3-7 at a shape that is not
#: among them
CHECKED_SHAPES: set[tuple] = set()


def _attn_key(name: str, q, causal: bool) -> tuple:
    return (name, tuple(q.shape), str(q.dtype), bool(causal))


def _decode_key(q, kvcache, n_kv_heads: int, block_t, kv_scales) -> tuple:
    """A decode launch's kernel mode, q and cache shapes, dtype, KV heads
    and tile (``_tile``: the int8 tile; 0 for the bf16/f32 mode)."""
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    int8 = kv_scales is not None
    return ("flash_decode_int8" if int8 else "flash_decode", tuple(q.shape),
            tuple(kvcache.shape), str(q.dtype), int(n_kv_heads),
            fd._tile(block_t, kvcache, kvcache.shape[3], int8))


def _paged_key(q, blocks, tables, n_kv_heads: int, block_t,
               block_scales) -> tuple:
    """A paged decode launch's mode, q and table shapes, block size,
    layers, row width, dtype, KV heads and tile; the pool's block count
    only sizes the allocation the tables index."""
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    int8 = block_scales is not None
    t = tables.shape[1] * blocks.shape[3]
    return ("flash_decode_paged", tuple(q.shape), tuple(tables.shape),
            blocks.shape[3], blocks.shape[0], blocks.shape[4], str(q.dtype),
            int(n_kv_heads), int8, fd._tile(block_t, blocks, t, int8))


@contextlib.contextmanager
def launched_shapes():
    """Yields a set that gathers the key (``_attn_key``, ``_decode_key``,
    ``_paged_key``) of every launch of kernels #1-#4 (both decode modes)
    made inside the block: the wrappers' launch functions are wrapped, the
    launches and their counts left as they are."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    seen: set[tuple] = set()
    fwd, bwd, dec = fa._launch, fa._launch_bwd, fd._launch
    paged = fd._launch_paged

    def on_fwd(q, k, v, causal):
        seen.add(_attn_key("flash_attn_fwd", q, causal))
        return fwd(q, k, v, causal)

    def on_bwd(q, k, v, o, lse, do, causal):
        seen.add(_attn_key("flash_attn_bwd", q, causal))
        return bwd(q, k, v, o, lse, do, causal)

    def on_dec(q, kvcache, pos, n_kv_heads, layer, block_t=None,
               kv_scales=None):
        seen.add(_decode_key(q, kvcache, n_kv_heads, block_t, kv_scales))
        return dec(q, kvcache, pos, n_kv_heads, layer, block_t, kv_scales)

    def on_paged(q, blocks, tables, pos, n_kv_heads, layer, block_t=None,
                 block_scales=None):
        seen.add(_paged_key(q, blocks, tables, n_kv_heads, block_t,
                            block_scales))
        return paged(q, blocks, tables, pos, n_kv_heads, layer, block_t,
                     block_scales)

    fa._launch, fa._launch_bwd, fd._launch = on_fwd, on_bwd, on_dec
    fd._launch_paged = on_paged
    try:
        yield seen
    finally:
        fa._launch, fa._launch_bwd, fd._launch = fwd, bwd, dec
        fd._launch_paged = paged


def check_launched(tag: str, seen: set[tuple]) -> None:
    """Fails unless phase 2 held every key in ``seen`` against the plain
    version."""
    unchecked = sorted(seen - CHECKED_SHAPES)
    log(f"{tag}: kernels #1-#4 launched at {len(seen)} (kernel, shape) "
        f"keys, {len(seen) - len(unchecked)} of them held against the plain "
        f"version in phase 2")
    if unchecked:
        raise SystemExit(f"{tag}: launches at shapes phase 2 never held "
                         f"against the plain version: {unchecked}")


def _attn_case(t: int, causal: bool, bh: int = 6, d: int = 128,
               iters: int = 50) -> dict:
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1000 + t)
    q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    CHECKED_SHAPES.add(_attn_key("flash_attn_fwd", q, causal))
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    finite = bool(torch.isfinite(o.float()).all())
    ok = finite and err <= ATTN_TOL and lse_err <= LSE_TOL
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), iters)
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal),
                       iters)
    q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), iters)
    pairs = t * (t + 1) // 2 if causal else t * t
    b_ms, b_by = bound(4 * bh * t * d * 2 + bh * t * 4, 4 * bh * pairs * d)
    log(f"kernel flash_attn_fwd BH={bh} T={t} D={d} causal={causal}: "
        f"max_abs_err {err:.3e} (tol {ATTN_TOL}), lse err {lse_err:.3e} "
        f"(tol {LSE_TOL}), ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
        f"bound_ms {b_ms:.6f} ({b_by}), library_ms {lib_ms:.4f} "
        f"-> {'ok' if ok else 'FAIL'}")
    _log_rate("flash_attn_fwd", fa.fwd_body(q.dtype, d),
              4 * bh * pairs * d, ms, b_ms, lib_ms)
    return dict(ok=ok, max_abs_err=max(err, lse_err), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def _log_rate(name: str, body: str, flops: float, ms: float, b_ms: float,
              lib_ms: float) -> None:
    """The body a flash call took, its rate on the work the function needs,
    its share of the bound, and its factor over the library call."""
    log(f"  {name} body {body}: {flops / ms / 1e9:.1f} TFLOP/s of needed "
        f"work, {b_ms / ms:.4f} of the bound, {ms / lib_ms:.3f}x the "
        f"library call")


def _bwd_case(t: int, causal: bool, bh: int = 6, d: int = 128,
              iters: int = 50) -> dict:
    """Kernel #2 against its plain version. Times the wrapper (the delta
    reduction and both passes), the plain version, and the library's
    backward: SDPA forward + backward minus its forward alone."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3000 + t + bh)
    q, k, v, do = (torch.randn((bh, t, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    CHECKED_SHAPES.add(_attn_key("flash_attn_bwd", q, causal))
    torch.cuda.synchronize()
    ok, worst, same = True, 0.0, True
    for x, r, x2 in zip(grads, refs, again):
        err = (x.float() - r.float()).abs().max().item()
        tol = GRAD_REL * r.float().abs().max().item() + GRAD_ABS
        ok = ok and bool(torch.isfinite(x.float()).all()) and err <= tol
        worst = max(worst, err)
        same = same and torch.equal(x, x2)
    ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal),
                 iters)
    plain_ms = time_ms(
        lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal),
        iters)
    q4, k4, v4 = (x.view(1, bh, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.view(1, bh, t, d)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    lib_ms = (time_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do4),
                      iters)
              - time_ms(sdpa, iters))
    pairs = t * (t + 1) // 2 if causal else t * t
    # reads q, k, v, O, dO and lse, writes dQ, dK, dV; the 5 products the
    # backward needs (the kernel recomputes S and dP: 7)
    b_ms, b_by = bound(8 * bh * t * d * 2 + bh * t * 4, 10 * bh * pairs * d)
    log(f"kernel flash_attn_bwd BH={bh} T={t} D={d} causal={causal}: "
        f"max_abs_err {worst:.3e} (tol {GRAD_REL} * max|ref| + {GRAD_ABS} "
        f"per gradient), deterministic {same}, ms {ms:.4f}, plain_ms "
        f"{plain_ms:.4f}, bound_ms {b_ms:.6f} ({b_by}), library_ms "
        f"{lib_ms:.4f} -> {'ok' if ok and same else 'FAIL'}")
    _log_rate("flash_attn_bwd", fa.bwd_body(q.dtype, d),
              10 * bh * pairs * d, ms, b_ms, lib_ms)
    return dict(ok=ok and same, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def _decode_case(b: int, g: int, hkv: int, kd: int, nl: int, tpad: int,
                 layer: int, pos: list[int]) -> dict:
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    hk = hkv * kd
    gen = torch.Generator(device="cuda").manual_seed(2000 + hk)
    q = torch.randn((b, g, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache = torch.randn((nl, 2, b, tpad, hk), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = fd.flash_decode_attention(q, cache, p, hkv, layer)
    grid, cluster = fd.last_launch()
    ref = fd.flash_decode_attention_plain(q, cache, p, hkv, layer)
    CHECKED_SHAPES.add(_decode_key(q, cache, hkv, None, None))
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err <= ATTN_TOL
    run = lambda: fd.flash_decode_attention(q, cache, p, hkv, layer)  # noqa
    ms, dev_ms = time_ms(run), graph_ms(run)
    plain_ms = time_ms(
        lambda: fd.flash_decode_attention_plain(q, cache, p, hkv, layer))
    q4 = q.view(b, g, hkv, kd).permute(0, 2, 1, 3)
    k4 = cache[layer, 0].view(b, tpad, hkv, kd).permute(0, 2, 1, 3)
    v4 = cache[layer, 1].view(b, tpad, hkv, kd).permute(0, 2, 1, 3)
    mask = (torch.arange(tpad, device="cuda")[None, :] <= p[:, None].long())
    mask = mask[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask)
    lib_ms, lib_dev_ms = time_ms(sdpa), graph_ms(sdpa)
    rows = sum(min(x + 1, tpad) for x in pos)
    b_ms, b_by = bound(2 * rows * hk * 2 + 2 * b * g * hk * 2 + 4 * b,
                       4 * rows * hk * g)
    log(f"kernel flash_decode B={b} G={g} Hkv*K={hk} nl={nl} Tpad={tpad} "
        f"layer={layer} pos={pos}: max_abs_err {err:.3e} (tol {ATTN_TOL}), "
        f"ms {ms:.4f} (graph_ms {dev_ms:.4f}; grid {grid}, cluster "
        f"{cluster}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} "
        f"({b_by}), library_ms {lib_ms:.4f} (graph_ms {lib_dev_ms:.4f}) "
        f"-> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                graph_ms=dev_ms, library_graph_ms=lib_dev_ms)


def _int8_err(out, ref) -> tuple[float, float]:
    """max |out - ref|, and max |out - ref| in units of one bf16 step (ulp)
    of ref's binade."""
    import torch

    r = ref.float()
    err = (out.float() - r).abs()
    step = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return err.max().item(), (err / step).max().item()


def _int8_store(gen, shape):
    import torch

    kv = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    scales = torch.rand(shape[:4] + (1,), generator=gen, device="cuda") * 0.02
    return kv, scales


def _int8_bytes(rows: int, hk: int, b: int, g: int) -> int:
    """What int8 decode must move: each visible K and V row once (int8 plus
    a 4-byte scale), q read and out written in bf16, pos."""
    return 2 * rows * (hk + 4) + 2 * b * g * hk * 2 + 4 * b


def _decode_int8_case(b: int, g: int, hkv: int, kd: int, nl: int, tpad: int,
                      layer: int, pos: list[int],
                      block_t: int | None = None) -> dict:
    """Kernel #3 in int8 mode against its plain version, at ``block_t``
    (default: the reference's tile for this cache)."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    hk = hkv * kd
    gen = torch.Generator(device="cuda").manual_seed(4000 + hk + g)
    q = torch.randn((b, g, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache, scales = _int8_store(gen, (nl, 2, b, tpad, hk))
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    bt = block_t or fd.default_block_t(tpad, hk, 1)
    out = fd.flash_decode_attention(q, cache, p, hkv, layer, block_t,
                                    kv_scales=scales)
    grid, cluster = fd.last_launch()
    scores = ("scratch" if fd._needs_scratch(g, hkv, bt, tpad)
              else "shared memory")
    ref = fd.flash_decode_attention_plain(q, cache, p, hkv, layer, block_t,
                                          kv_scales=scales)
    CHECKED_SHAPES.add(_decode_key(q, cache, hkv, block_t, scales))
    torch.cuda.synchronize()
    err, steps = _int8_err(out, ref)
    ok = bool(torch.isfinite(out.float()).all()) and steps <= INT8_STEPS
    run = lambda: fd.flash_decode_attention(  # noqa: E731
        q, cache, p, hkv, layer, block_t, kv_scales=scales)
    ms, dev_ms = time_ms(run), graph_ms(run)
    plain_ms = time_ms(lambda: fd.flash_decode_attention_plain(
        q, cache, p, hkv, layer, block_t, kv_scales=scales), iters=10)
    rows = sum(min(x + 1, tpad) for x in pos)
    b_ms, b_by = bound(_int8_bytes(rows, hk, b, g), 4 * rows * hk * g,
                       INT8_OPS)
    log(f"kernel flash_decode_int8 B={b} G={g} Hkv*K={hk} nl={nl} "
        f"Tpad={tpad} layer={layer} pos={pos} block_t={bt}"
        f"{' (the reference default)' if block_t is None else ''}: "
        f"max_abs_err {err:.3e}, {steps:.3f} bf16 steps (tol {INT8_STEPS}), "
        f"ms {ms:.4f} (graph_ms {dev_ms:.4f}; grid {grid}, cluster "
        f"{cluster}; scores in {scores}), plain_ms {plain_ms:.4f}, bound_ms "
        f"{b_ms:.6f} ({b_by}), library_ms none -> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms)


def _batch_case(int8: bool, pos: list[int], hkv: int = 6, kd: int = 128,
                nl: int = 12, tpad: int = 640, layer: int = 7) -> dict:
    """Every row of a B 8 launch of kernel #3 decoded again alone (B 1):
    bitwise equal, and a second B 8 launch bitwise equal to the first."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    b, hk = len(pos), hkv * kd
    gen = torch.Generator(device="cuda").manual_seed(7000 + int8)
    q = torch.randn((b, 1, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    if int8:
        cache, scales = _int8_store(gen, (nl, 2, b, tpad, hk))
    else:
        cache = torch.randn((nl, 2, b, tpad, hk), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
        scales = None
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = fd.flash_decode_attention(q, cache, p, hkv, layer,
                                    kv_scales=scales)
    again = torch.equal(out, fd.flash_decode_attention(
        q, cache, p, hkv, layer, kv_scales=scales))
    alone = [torch.equal(out[i], fd.flash_decode_attention(
        q[i:i + 1].contiguous(), cache[:, :, i:i + 1].contiguous(),
        p[i:i + 1], hkv, layer,
        kv_scales=None if scales is None
        else scales[:, :, i:i + 1].contiguous())[0]) for i in range(b)]
    ok = again and all(alone)
    log(f"kernel flash_decode{'_int8' if int8 else ''} B 1 vs B 8 pos={pos}: "
        f"rows bitwise equal {sum(alone)}/{b}, run vs run bitwise {again} "
        f"-> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok)


def _paged_case(int8: bool, bs: int, pos: list[int], b: int = 8,
                hkv: int = 6, kd: int = 128, nl: int = 12, tpad: int = 640,
                layer: int = 7) -> dict:
    """Kernel #4 against its plain version and BITWISE against kernel #3
    over the gathered slab: shuffled tables over a pool with spare blocks,
    one block aliased by rows 0 and 1, the sentinel zeroed."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    hk = hkv * kd
    bps = tpad // bs
    gen = torch.Generator(device="cuda").manual_seed(5000 + bs + int8)
    q = torch.randn((b, 1, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    n_blocks = b * bps + 9
    perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * bps].reshape(b, bps).to(torch.int32).contiguous()
    tables[1, 0] = tables[0, 0]
    shape = (nl, 2, n_blocks, bs, hk)
    if int8:
        blocks, scales = _int8_store(gen, shape)
    else:
        blocks = torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
        scales = None
    blocks[:, :, 0] = 0
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")

    def run():
        return fd.flash_decode_attention_paged(q, blocks, tables, p, hkv,
                                               layer, block_scales=scales)

    def plain():
        return fd.flash_decode_attention_paged_plain(
            q, blocks, tables, p, hkv, layer, block_scales=scales)

    out = run()
    grid, cluster = fd.last_launch()
    ref = plain()
    CHECKED_SHAPES.add(_paged_key(q, blocks, tables, hkv, None, scales))
    slab = fd._gather_rows(blocks, tables, layer).contiguous()
    sslab = (None if scales is None
             else fd._gather_rows(scales, tables, layer).contiguous())
    slab_out = fd.flash_decode_attention(q, slab, p, hkv, 0,
                                         kv_scales=sslab)
    torch.cuda.synchronize()
    bitwise = torch.equal(out, slab_out)
    finite = bool(torch.isfinite(out.float()).all())
    if int8:
        err, steps = _int8_err(out, ref)
        ok = finite and steps <= INT8_STEPS
        tol = f"{steps:.3f} bf16 steps, tol {INT8_STEPS}"
    else:
        err = (out.float() - ref.float()).abs().max().item()
        ok = finite and err <= ATTN_TOL
        tol = f"tol {ATTN_TOL}"
    ms, dev_ms = time_ms(run), graph_ms(run)
    plain_ms = time_ms(plain, iters=10)
    rows = sum(min(x + 1, tpad) for x in pos)
    tab = 4 * sum(-(-min(x + 1, tpad) // bs) for x in pos)
    if int8:
        nbytes = _int8_bytes(rows, hk, b, 1) + tab
        b_ms, b_by = bound(nbytes, 4 * rows * hk, INT8_OPS)
    else:
        b_ms, b_by = bound(2 * rows * hk * 2 + 2 * b * hk * 2 + 4 * b + tab,
                           4 * rows * hk)
    ok = ok and bitwise
    log(f"kernel flash_decode_paged {'int8' if int8 else 'bf16'} bs={bs} "
        f"B={b} Hkv*K={hk} nl={nl} Tpad={tpad} layer={layer}: max_abs_err "
        f"{err:.3e} ({tol}), bitwise == slab kernel on the gathered slab "
        f"{bitwise}, ms {ms:.4f} (graph_ms {dev_ms:.4f}; grid {grid}, "
        f"cluster {cluster}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} "
        f"({b_by}), library_ms none -> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms)


def _emb_dot_case(b: int, L: int, d: int, planted: bool = False,
                  iters: int = 50) -> dict:
    """Kernel #5 and its range flag against the plain version: HS-shaped
    inputs (each row's path a random length, the rest masked; dots of a
    few units, some saturated), and with ``planted`` a quarter of the rows
    masked out whole and dots planted at 6 -+ 1e-3."""
    import torch

    from deeplearning4j_tpu_torch.ops import emb_dot

    gen = torch.Generator(device="cuda").manual_seed(6000 + L + planted)
    h = torch.randn((b, d), generator=gen, device="cuda") * 0.5
    w = torch.randn((b, L, d), generator=gen, device="cuda") * 0.5
    lens = torch.randint(1, L + 1, (b, 1), generator=gen, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens).float()
    if planted:
        mask[: b // 4] = 0.0
        sel = torch.randint(0, 4, (b, L), generator=gen, device="cuda")
        target = torch.tensor([6 - 1e-3, -(6 - 1e-3), 6 + 1e-3, -(6 + 1e-3)],
                              dtype=torch.float64, device="cuda")[sel]
        h64 = h.double()
        w = (h64 / (h64 * h64).sum(-1, keepdim=True))[:, None, :] * target[
            ..., None]
        w = w.float().contiguous()
    f, in_range = emb_dot.fused_embedding_dot_range(h, w, mask)
    f_ref, in_ref = emb_dot.fused_embedding_dot_range_plain(h, w, mask)
    torch.cuda.synchronize()
    err = (f - f_ref).abs().max().item()
    flags_equal = torch.equal(in_range, in_ref)
    ok = bool(torch.isfinite(f).all()) and err <= EMB_TOL and flags_equal
    if planted:
        ok = ok and torch.equal(in_range, (target.abs() < 6).float())
    saturated = int((in_range == 0).sum())
    run = lambda: emb_dot.fused_embedding_dot_range(h, w, mask)  # noqa: E731
    ms, dev_ms = time_ms(run, iters), graph_ms(run)
    plain_ms = time_ms(
        lambda: emb_dot.fused_embedding_dot_range_plain(h, w, mask), iters)
    hv = h[:, :, None]
    bmm_ms = time_ms(lambda: torch.bmm(w, hv), iters)
    # reads w, h and mask, writes f and the flag (f32); an FMA per element
    # of w
    b_ms, b_by = bound(4 * (b * L * d + b * d + 3 * b * L), 2 * b * L * d,
                       F32_FLOPS)
    log(f"kernel emb_dot B={b} L={L} D={d}"
        f"{' planted |dot| = 6 -+ 1e-3, masked rows' if planted else ''}: "
        f"max_abs_err {err:.3e} (tol {EMB_TOL}), range flags equal "
        f"{flags_equal} ({saturated} saturated of {b * L}), ms {ms:.4f} "
        f"(graph_ms {dev_ms:.4f}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} ({b_by}), "
        f"library_ms none (torch.bmm of the dot alone: {bmm_ms:.4f}) -> "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms, bmm_dot_ms=bmm_ms)


def _emb_dot_hs_batch(kind: str, model, corpus, gen):
    """A fused-mode batch at phase 6's width (B 4,096, D 100): (S, v,
    inputs, codes, points, mask, planted dots or None). ``L16``: a random
    table of phase 6's size (V + V - 1 rows), random inputs and paths of
    16 entries, each row a random prefix; ``planted``: phase 6's longest
    path, a quarter of the rows masked out whole, every entry its own syn1
    row with its dot planted at 6 -+ 1e-3; ``phase6``: phase 6's first
    batch of pairs (the fit's first chunk) and its Huffman paths over a
    random table of its size."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import native_io

    b, d = W2V_BATCH, W2V_DIM
    nv = len(model.cache)
    L = model.cache.max_code_length
    dev = "cuda"
    t = None
    if kind == "phase6":
        codes, points, mask = model._huffman()
        ids = [np.asarray(model.cache.encode(model.tokenize(s)), np.int32)
               for s in corpus[:1]]
        ins, tgts = native_io.sg_pairs_chunk(ids, model.window, model.seed)
        if len(ins) < b:
            raise SystemExit(f"phase 6's first chunk holds {len(ins)} pairs, "
                             f"fewer than a batch")
        inputs = torch.from_numpy(ins[:b].astype(np.int64)).to(dev)
        tg = torch.from_numpy(tgts[:b].astype(np.int64)).to(dev)
        codes, points, mask = codes[tg], points[tg], mask[tg]
        S = torch.randn((2 * nv - 1, d), generator=gen, device=dev) * 0.5
        return S, nv, inputs, codes, points, mask, t
    if kind == "L16":
        L = 16
        S = torch.randn((2 * nv - 1, d), generator=gen, device=dev) * 0.5
        v = nv
        inputs = torch.randint(0, nv, (b,), generator=gen, device=dev)
        points = torch.randint(0, nv - 1, (b, L), generator=gen, device=dev)
    else:  # planted
        v = b
        S = torch.randn((b + b * L, d), generator=gen, device=dev) * 0.5
        inputs = torch.randperm(b, generator=gen, device=dev)
        points = torch.randperm(b * L, generator=gen, device=dev).view(b, L)
    codes = torch.randint(0, 2, (b, L), generator=gen, device=dev).float()
    lens = torch.randint(1, L + 1, (b, 1), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lens).float()
    if kind == "planted":
        mask[: b // 4] = 0.0
        sel = torch.randint(0, 4, (b, L), generator=gen, device=dev)
        t = torch.tensor([6 - 1e-3, -(6 - 1e-3), 6 + 1e-3, -(6 + 1e-3)],
                         dtype=torch.float64, device=dev)[sel]
        h64 = S[inputs].double()
        unit = h64 / (h64 * h64).sum(-1, keepdim=True)
        S[v + points] = (unit[:, None, :] * t[..., None]).float()
    return S, v, inputs, codes, points, mask, t


def _emb_dot_hs_case(kind: str, model, corpus, iters: int = 50) -> dict:
    """Kernel #5's fused mode as the HS step calls it (``dest`` from the
    scatter plan) against its plain version: every kept entry (grad_in and
    the delta rows of valid path entries) within EMB_TOL, written into a
    NaN-filled buffer; the range flags equal (a kept path entry's delta row
    is exactly zero where its dot is saturated; with planted dots, exactly
    where |t| > 6); the masked entries left unwritten (NaN); a second
    launch bitwise equal. Bound: each distinct row read once, the index
    arrays, and the kept delta rows written once (logged beside it: the
    bound with each row read per use, which the result line leaves out as
    it holds only measured numbers and ``bound_ms``)."""
    import torch

    from deeplearning4j_tpu_torch.models import word2vec as w2v
    from deeplearning4j_tpu_torch.ops import emb_dot

    gen = torch.Generator(device="cuda").manual_seed(
        7000 + ("L16", "planted", "phase6").index(kind))
    S, v, inputs, codes, points, mask, t = _emb_dot_hs_batch(
        kind, model, corpus, gen)
    b, L = points.shape
    d = S.shape[1]
    lr = W2V_LR
    rows = torch.cat([inputs, (v + points).reshape(-1)])
    keep = torch.cat([torch.ones_like(inputs, dtype=torch.bool),
                      mask.reshape(-1) > 0])
    plan = w2v._scatter_plan(rows, keep, S.shape[0], inverse=True)
    dest = plan.dest
    at = dest[keep]
    args = (S, v, inputs, codes, points, mask, lr)
    nan = torch.full((len(rows), d), float("nan"), device="cuda")
    out = emb_dot.fused_hs_rows(*args, dest=dest, out=nan)
    again = emb_dot.fused_hs_rows(*args, dest=dest)
    ref = emb_dot.fused_hs_rows_plain(*args, dest=dest)
    torch.cuda.synchronize()
    err = (out[at] - ref[at]).abs().max().item()
    unwritten = bool(torch.isnan(out[dest[~keep]]).all())
    bitwise = torch.equal(out[at], again[at])
    zero = (out[at][b:] == 0).all(-1)
    flags_equal = torch.equal(zero, (ref[at][b:] == 0).all(-1))
    if t is not None:
        want = (t.abs() > 6).reshape(-1)[mask.reshape(-1) > 0]
        flags_equal = flags_equal and torch.equal(zero, want)
    ok = (bool(torch.isfinite(out[at]).all()) and err <= EMB_TOL
          and unwritten and bitwise and flags_equal)
    run = lambda: emb_dot.fused_hs_rows(*args, dest=dest)  # noqa: E731
    ms, dev_ms = time_ms(run, iters), graph_ms(run)
    plain_ms = time_ms(
        lambda: emb_dot.fused_hs_rows_plain(*args, dest=dest), iters)
    n_valid = int((mask > 0).sum())
    kept = b + n_valid
    distinct = int(torch.unique(rows[keep]).numel())
    # inputs and dest of the inputs; mask of every entry; points, codes and
    # dest of the valid ones; the kept delta rows written
    idx_bytes = 16 * b + 4 * b * L + 20 * n_valid
    out_bytes = 4 * d * kept
    flops = 5 * n_valid * d  # dot, grad_in (FMA each), g * h
    b_ms, b_by = bound(4 * d * distinct + idx_bytes + out_bytes, flops,
                       F32_FLOPS)
    use_ms, use_by = bound(4 * d * kept + idx_bytes + out_bytes, flops,
                           F32_FLOPS)
    saturated = int(zero.sum())
    log(f"kernel emb_dot fused HS rows ({kind}) B={b} L={L} D={d}: "
        f"{n_valid} valid path entries of {b * L}, {distinct} distinct rows; "
        f"max_abs_err {err:.3e} at dest (tol {EMB_TOL}), masked entries "
        f"unwritten {unwritten}, range flags equal {flags_equal} ({saturated} "
        f"saturated), bitwise repeat {bitwise}, ms {ms:.4f} (graph_ms "
        f"{dev_ms:.4f}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} "
        f"({b_by}; per use {use_ms:.6f}, {use_by}), library_ms none -> "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms, mode="fused")


#: decode positions on either side of the kernels' split edges (rows per
#: split a multiple of 8 of (pos + 1) / 16: 8 -> 16 past pos 127, one
#: 32-row stage -> two past pos 511), and the first and last row
SPLIT_EDGE_POS = [0, 7, 8, 127, 128, 511, 512, 639]


def phase_kernels(w2v_model, w2v_corpus) -> dict[str, dict]:
    """Kernel vs plain version at the slices' shapes. Returns, per kernel,
    the numbers of its main-path case (the last one listed: the training
    shape for the flash kernels, GPT-2-small serving for the decode
    kernels, int8 at block size 8 for the paged one, the fused mode on
    phase 6's first batch for the fused embedding dot)."""
    attn = [_attn_case(t, True) for t in (8, 64)]
    attn.append(_attn_case(128, False))
    attn.append(_attn_case(128, True))
    # prefills (6 heads of 128): phase 4's 20-token prompt (bucket 32),
    # phase 3's generate on 40 tokens; phase 7's: the CLI's 16-byte prompt,
    # the speculative prefill's 128-aligned prefix (384 of 511 rows), the
    # spec cell's plain generate (512); phase 5's 2-layer parity at B 2
    # and phase 7's train at batch CKPT_BATCH
    attn += [_attn_case(t, True)
             for t in (32, 40, GEN_PROMPT, 384, SPEC_PROMPT)]
    attn.append(_attn_case(TRAIN_SEQ, True, bh=2 * 6, iters=20))
    attn.append(_attn_case(TRAIN_SEQ, True, bh=CKPT_BATCH * 6, iters=20))
    attn.append(_attn_case(TRAIN_SEQ, True, bh=TRAIN_BATCH * 6, iters=20))
    bwd = [_bwd_case(128, causal) for causal in (True, False)]
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=2 * 6, iters=20))
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=CKPT_BATCH * 6, iters=20))
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=TRAIN_BATCH * 6, iters=20))
    rng = random.Random(0)
    pos = [0, 639] + [rng.randrange(1, 639) for _ in range(6)]
    # phase 7's decode shapes on GPT-2-small (Hkv 6, K 128, 12 layers):
    # Tpad 64 (the CLI's 16-byte prompt and 48 new: train's closing sample
    # and greedy generate at B 1, generate --beam 4 at B 4) and Tpad 160
    # (beam search, prompt 128 + 32 new: W 1 and greedy at B 1, W 4 at
    # B 4; its 1-token timing runs at 136), beam rows all at one position;
    # the spec cell (6 query heads over 2 KV heads of 128): plain generate
    # at Tpad 576 (512 + 64) and the draft steps at 584 (512 + 64 + k + 1,
    # rounded to 8)
    gen_t, beam_t = GEN_PROMPT + GEN_NEW, BEAM_PROMPT + BEAM_NEW
    beam1_t, spec_t = BEAM_PROMPT + 8, SPEC_PROMPT + SPEC_NEW
    # phases 3-3b: the engine's paged-parity probe (B 2, Tpad 32, rows 8
    # to 10) and generate on prompts 1 and 5 (Tpad 72 and 232)
    serve_ts = [PROMPT_LENGTHS[i] + MAX_NEW for i in (1, 5)]
    dec = [
        _decode_case(4, 3, 2, 128, 2, 256, 1, [0, 17, 100, 255]),
        _decode_case(2, 1, 6, 128, 12, 32, 7, [8, 10]),
        *[_decode_case(1, 1, 6, 128, 12, t, 7, [t - 1]) for t in serve_ts],
        _decode_case(1, 1, 6, 128, 12, gen_t, 7, [gen_t - 1]),
        _decode_case(4, 1, 6, 128, 12, gen_t, 7, [GEN_PROMPT] * 4),
        _decode_case(1, 1, 6, 128, 12, beam_t, 7, [beam_t - 1]),
        _decode_case(4, 1, 6, 128, 12, beam_t, 7, [beam_t - 1] * 4),
        _decode_case(4, 1, 6, 128, 12, beam1_t, 7, [BEAM_PROMPT] * 4),
        _decode_case(1, 3, 2, 128, 12, spec_t, 7, [spec_t - 1]),
        _decode_case(1, 3, 2, 128, 12, spec_t + 8, 7, [spec_t - 1]),
        _decode_case(8, 1, 6, 128, 12, 640, 7, SPLIT_EDGE_POS),
        _batch_case(False, pos),
        _decode_case(8, 1, 6, 128, 12, 640, 7, pos),
    ]
    dec8 = [
        _decode_int8_case(4, 3, 2, 128, 2, 256, 1, [0, 17, 100, 255]),
        _decode_int8_case(2, 1, 6, 128, 12, 32, 7, [8, 10]),
        *[_decode_int8_case(1, 1, 6, 128, 12, t, 7, [t - 1])
          for t in serve_ts],
        # phase 7's int8 decode shapes: generate --int8 full (B 1, Tpad 64)
        # and the int8 beam (B 1 and 4, Tpad 160; B 4 at 136 timing one
        # token), each at the reference's tile for its cache
        _decode_int8_case(1, 1, 6, 128, 12, gen_t, 7, [gen_t - 1]),
        _decode_int8_case(1, 1, 6, 128, 12, beam_t, 7, [beam_t - 1]),
        _decode_int8_case(4, 1, 6, 128, 12, beam_t, 7, [BEAM_PROMPT] * 4),
        _decode_int8_case(4, 1, 6, 128, 12, beam1_t, 7, [BEAM_PROMPT] * 4),
        _decode_int8_case(8, 1, 6, 128, 12, 640, 7, SPLIT_EDGE_POS),
        _decode_int8_case(8, 1, 6, 128, 12, 640, 7, pos, block_t=64),
        # one 1,592-row tile (the rule's cap at Hkv*K 768) over 48 lanes:
        # 200 rows a block, whose scores go to the wrapper's scratch tensor
        _decode_int8_case(2, 4, 12, 64, 2, 1592, 1, [1591, 700]),
        _batch_case(True, pos),
        _decode_int8_case(8, 1, 6, 128, 12, 640, 7, pos),
    ]
    # the probe's paged leg (B 2, Tpad 32), then the serve shape
    paged = [_paged_case(int8, 8, [8, 10], b=2, tpad=32)
             for int8 in (False, True)]
    paged += [_paged_case(int8, bs, pos) for bs in (64, 8)
              for int8 in (False, True)]
    code_len = w2v_model.cache.max_code_length
    emb = [_emb_dot_case(W2V_BATCH, 16, W2V_DIM),
           _emb_dot_case(W2V_BATCH, code_len, W2V_DIM, planted=True),
           _emb_dot_case(W2V_BATCH, code_len, W2V_DIM)]
    emb += [_emb_dot_hs_case(kind, w2v_model, w2v_corpus)
            for kind in ("L16", "planted", "phase6")]
    for name, cases in (("flash_attn_fwd", attn), ("flash_attn_bwd", bwd),
                        ("flash_decode", dec), ("flash_decode_int8", dec8),
                        ("flash_decode_paged", paged), ("emb_dot", emb)):
        if not all(c["ok"] for c in cases):
            raise SystemExit(f"kernel {name} disagrees with its plain "
                             f"version")
    return {"flash_attn_fwd": attn[-1], "flash_attn_bwd": bwd[-1],
            "flash_decode": dec[-1], "flash_decode_int8": dec8[-1],
            "flash_decode_paged": paged[-1], "emb_dot": emb[-1]}


# -- phase 3 -----------------------------------------------------------------

#: the kernels of the serving and training paths, for the result line
KERNELS = {
    "flash_attn_fwd": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:125"),
    "flash_attn_bwd": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:213"),
    "flash_decode": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_decode.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:502"),
    "flash_decode_int8": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_decode.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:502"),
    "flash_decode_paged": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_decode.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:783"),
    "emb_dot": dict(
        source="deeplearning4j_tpu_torch/csrc/emb_dot.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:906"),
}


def reset_launches() -> None:
    from deeplearning4j_tpu_torch.ops import emb_dot
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    fa.reset_launches()
    fd.reset_launches()
    emb_dot.reset_launches()


def read_launches() -> dict[str, int]:
    """Every kernel's launch count since its last reset."""
    from deeplearning4j_tpu_torch.ops import emb_dot
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    return {"flash_attn_fwd": fa.launches, "flash_attn_bwd": fa.bwd_launches,
            "flash_decode": fd.launches,
            "flash_decode_int8": fd.int8_launches,
            "flash_decode_paged": fd.paged_launches,
            "emb_dot": emb_dot.launches}


#: prompt lengths of the served requests: bucketed prefill (<= 128, the
#: flash kernel) and chunked prefill past the 128-token bucket
PROMPT_LENGTHS = (16, 40, 77, 128, 130, 200, 257, 300)
MAX_NEW = 32
#: rows per KV block of the paged runs (the reference's default)
BLOCK_SIZE = 8


def gpt2s_config(**kw):
    import torch

    from deeplearning4j_tpu_torch.cli import PRESETS
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    p = dict(PRESETS["gpt2s"])
    p.pop("bf16")
    return TransformerConfig(**p, use_flash=True,
                             compute_dtype=torch.bfloat16, **kw)


def serve_model(int8: bool):
    """GPT-2-small with random weights from seed 0: bf16, or int8 weights
    and the int8 KV cache (the reference's ``--int8 full``)."""
    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
    )

    cfg = gpt2s_config(decode_int8=int8)
    params = init_params(cfg, seed=0)
    return cfg, quantize_decode_params(params, cfg) if int8 else params


def _generate(gen, params, prompt):
    """The port's generate on one prompt alone: tokens and logits."""
    import torch

    toks, logits = gen(params, torch.from_numpy(prompt[None]).long().cuda(),
                       MAX_NEW, temperature=0.0, return_logits=True)
    return toks[0].cpu().numpy(), logits[:, 0]


def _parity(prompt, ref, logits, stream) -> str:
    """Hold one engine stream against generate's; a mismatch passes only
    at a near-tie of generate's logits."""
    import torch

    diff = (ref != stream).nonzero()[0]
    if not diff.size:
        return "identical"
    i = int(diff[0]) - len(prompt)
    top2 = torch.topk(logits[i], 2).values.tolist()
    gap = top2[0] - top2[1]
    msg = (f"first mismatch at generated position {i} (prompt "
           f"{len(prompt)}): top-2 logit gap {gap:.4g}")
    if gap >= NEAR_TIE:
        raise SystemExit(f"engine stream disagrees with generate: {msg}")
    return "near-tie: " + msg


def _serve_run(tag: str, cfg, params, *, must_launch, must_not_launch=(),
               refs=None, paged: bool = False):
    """Drive ``ServingEngine`` once through the 8 requests (every launch
    count set to 0 just before, read just after), check every stream, and
    print the run's numbers. Returns (engine, launches, streams)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, n_slots=8, max_total=640,
                           decode_horizon=4, temperature=0.0, paged=paged,
                           block_size=BLOCK_SIZE)
    if paged and not engine._paged:
        raise SystemExit(f"{tag}: the engine did not come up paged")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=MAX_NEW) for n in PROMPT_LENGTHS]
    torch.cuda.synchronize()
    layout = (f"paged, {engine.pool.n_blocks} blocks x {BLOCK_SIZE} rows"
              if paged else "slab")
    log(f"{tag}: GPT-2-small ({cfg.d_model}d x {cfg.n_layers}L, "
        f"{cfg.n_heads}x{cfg.head_dim} heads, vocab {cfg.vocab_size}, bf16"
        f"{', int8 weights + int8 KV cache' if cfg.decode_int8 else ''}) "
        f"8 slots, max_total 640 (Tpad {engine.pool.tpad}, {layout}), K=4; "
        f"set-up {time.perf_counter() - t0:.1f} s")

    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"{tag}: launches on the main path {launches}")
    for name in must_launch:
        if launches[name] <= 0:
            raise SystemExit(f"{tag}: kernel {name} never launched on the "
                             f"main path")
    for name in must_not_launch:
        if launches[name]:
            raise SystemExit(f"{tag}: kernel {name} launched "
                             f"{launches[name]} times; this path must not "
                             f"run it")
    for r in reqs:
        out = results[r.id]
        if (r.status.value != "finished"
                or out.shape != (len(r.prompt) + MAX_NEW,)
                or not ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise SystemExit(f"request {r.id} ({len(r.prompt)} prompt "
                             f"tokens) came back wrong: {r.status}, "
                             f"{out.shape}")
    for i, (ref, logits) in (refs or {}).items():
        r = reqs[i]
        verdict = _parity(r.prompt, ref, logits, results[r.id])
        log(f"{tag}: parity vs transformer_generate, prompt "
            f"{len(r.prompt)}: {verdict}")
    # decode phase: from the first request's first token to the last
    # request's last token
    first = min(r.arrival_time + r.timing["ttft_s"] for r in reqs)
    last = max(r.arrival_time + r.timing["ttft_s"] + r.timing["decode_s"]
               for r in reqs)
    decode_tok_s = len(reqs) * (MAX_NEW - 1) / (last - first)
    s = engine.metrics.summary()
    log(f"{tag}: {s['n_generated']} tokens for {len(reqs)} requests in "
        f"{wall:.3f} s -> {s['n_generated'] / wall:.1f} generated tok/s, "
        f"decode phase {decode_tok_s:.1f} tok/s; "
        f"TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} ms p99 "
        f"{s['ttft_p99_s'] * 1e3:.2f} ms; TPOT p50 "
        f"{s['tpot_p50_s'] * 1e3:.3f} ms p99 {s['tpot_p99_s'] * 1e3:.3f} ms; "
        f"prefill {s['prefill_s'] * 1e3:.1f} ms total; "
        f"occupancy {s['occupancy_mean']:.2f} slots; "
        f"{s['steps']} horizons")
    return engine, launches, [results[r.id] for r in reqs]


def phase_serve(int8: bool = False):
    """Phases 3 and 3b: GPT-2-small through the slab ``ServingEngine``,
    greedy, two streams held against ``transformer_generate`` on the same
    model (generated first: that also warms the card before the engine is
    timed). Returns the engine (phase 4 reuses the bf16 one), the launch
    counts and the streams."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_generate,
    )

    cfg, params = serve_model(int8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENGTHS]
    gen = transformer_generate(cfg)
    refs = {i: _generate(gen, params, prompts[i]) for i in (1, 5)}
    torch.cuda.synchronize()
    decode = "flash_decode_int8" if int8 else "flash_decode"
    return _serve_run("serve int8" if int8 else "serve", cfg, params,
                      must_launch=("flash_attn_fwd", decode), refs=refs)


def phase_serve_paged(int8: bool, slab_streams) -> dict[str, int]:
    """Phase 3c: the run of phase 3 (or 3b) on a block-paged cache. Every
    stream must be byte-identical to the slab run's, the paged kernel must
    launch and neither slab decode mode may, and every block must come
    back. Returns the launch counts."""
    import numpy as np

    cfg, params = serve_model(int8)
    tag = "serve paged int8" if int8 else "serve paged"
    engine, launches, streams = _serve_run(
        tag, cfg, params, paged=True,
        must_launch=("flash_attn_fwd", "flash_decode_paged"),
        must_not_launch=("flash_decode", "flash_decode_int8"))
    same = [np.array_equal(a, b) for a, b in zip(streams, slab_streams)]
    log(f"{tag}: streams byte-identical to the slab run: {sum(same)}/"
        f"{len(same)}; blocks in use after the run "
        f"{engine.pool.n_blocks_in_use}")
    if not all(same):
        raise SystemExit(f"{tag}: streams differ from the slab engine's "
                         f"(prompts {[n for n, ok in zip(PROMPT_LENGTHS, same) if not ok]})")
    if engine.pool.n_blocks_in_use:
        raise SystemExit(f"{tag}: {engine.pool.n_blocks_in_use} blocks "
                         f"still in use after every request finished")
    return launches


# -- phase 4 -----------------------------------------------------------------

def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise SystemExit(f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read())


def phase_server(engine) -> None:
    import numpy as np

    from deeplearning4j_tpu_torch.serving import ServingServer

    server = ServingServer(engine, port=0).start()
    try:
        host, port = server.address
        base = f"http://{host}:{port}"
        rng = np.random.default_rng(1)
        for n in (20, 60, 150):
            prompt = rng.integers(0, engine.cfg.vocab_size, n).tolist()
            t0 = time.perf_counter()
            body = _post(base + "/v1/generate",
                         {"prompt": prompt, "max_new": 16})
            if body["tokens"][:n] != prompt or len(body["tokens"]) != n + 16:
                raise SystemExit(f"/v1/generate returned a bad stream for "
                                 f"a {n}-token prompt")
            log(f"server: /v1/generate prompt {n} -> 16 tokens in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
                f"(engine ttft {body['timing']['ttft_s'] * 1e3:.2f} ms)")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
            if resp.status != 200 or not health["ok"]:
                raise SystemExit(f"/healthz not ok: {health}")
        log(f"server: /healthz {health}")
    finally:
        server.stop(drain_s=10.0)


# -- phase 5 -----------------------------------------------------------------

#: the reference bench's "transformer" preset (bench.py:207): GPT-2-small
#: widths with 6 heads of 128, seq 1024, batch 24
TRAIN_SEQ, TRAIN_BATCH = 1024, 24
TRAIN_STEPS, TRAIN_WARMUP = 8, 2
#: flash vs dense attention on the 2-layer model (both bf16)
PARITY_LOSS_RTOL, PARITY_COSINE = 1e-2, 0.99


def lm_flops_per_token(d: int, n_layers: int, d_ff: int, vocab: int,
                       seq: int) -> float:
    """Training FLOPs per token of a dense decoder-only LM, as the reference
    bench counts them (bench.py:192): 6 x matmul params + causal attention
    6 T d per layer."""
    per_layer = 4 * d * d + 2 * d * d_ff
    return 6.0 * (n_layers * per_layer + d * vocab) + 6.0 * seq * d * n_layers


def bench_config(n_layers: int = 12, remat: bool = True):
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=50304, d_model=768, n_heads=6, n_layers=n_layers,
        d_ff=3072, max_len=TRAIN_SEQ + 1, use_flash=True, remat=remat,
        remat_policy="dots_no_batch", compute_dtype=torch.bfloat16)


def phase_train(card: str) -> dict[str, int]:
    """The training path: 8 steps of the bench preset. Returns each
    kernel's launches in the 6 timed steps."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer,
        transformer_train_step,
    )

    cfg = bench_config()
    t0 = time.perf_counter()
    step, init_state, shard_tokens = transformer_train_step(
        None, cfg, optimizer=lm_optimizer(total_steps=TRAIN_STEPS))
    params, opt_state = init_state(0)
    toks = shard_tokens(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)))
    losses = []
    for _ in range(TRAIN_WARMUP):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    torch.cuda.synchronize()
    log(f"train: bench 'transformer' preset ({cfg.d_model}d x "
        f"{cfg.n_layers}L, {cfg.n_heads}x{cfg.head_dim} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, seq {TRAIN_SEQ}, batch "
        f"{TRAIN_BATCH}, flash, remat {cfg.remat_policy}, bf16 compute, f32 "
        f"params), lm_optimizer(total_steps={TRAIN_STEPS}); set-up and "
        f"{TRAIN_WARMUP} warm-up steps {time.perf_counter() - t0:.1f} s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - TRAIN_WARMUP):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    n = TRAIN_STEPS - TRAIN_WARMUP
    ms_step = wall / n * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (wall / n)
    share = lm_flops_per_token(cfg.d_model, cfg.n_layers, cfg.d_ff,
                               cfg.vocab_size, TRAIN_SEQ) * tok_s / BF16_FLOPS
    log(f"train: launches in the {n} timed steps {launches}")
    log(f"train: losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"train: {ms_step:.2f} ms/step, {tok_s:.1f} tokens/s, "
        f"{share:.4f} of {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, peak memory "
        f"{peak_gib:.2f} GiB ({card})")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} never launched in training")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"training loss not finite or not falling: {losses}")
    del params, opt_state
    torch.cuda.empty_cache()
    return launches


def phase_train_parity() -> None:
    """Flash vs dense attention, and remat on vs off, on 2 layers."""
    import dataclasses

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        _leaves,
        _tree,
        init_params,
        transformer_loss,
        value_and_grad,
    )

    cfg = bench_config(n_layers=2, remat=False)
    params = init_params(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, TRAIN_SEQ + 1))).cuda()

    def run(c):
        fresh = _tree((path, p.detach().clone())
                      for path, p in _leaves(params))
        loss, grads = value_and_grad(transformer_loss(c), fresh, toks)
        return float(loss), dict(_leaves(grads))

    flash = run(cfg)
    dense = run(dataclasses.replace(cfg, use_flash=False))
    rel = abs(flash[0] - dense[0]) / abs(dense[0])
    cos = {}
    for path, g in flash[1].items():
        a, b = g.double().flatten(), dense[1][path].double().flatten()
        cos["/".join(path)] = (a @ b / (a.norm() * b.norm())).item()
    worst = min(cos, key=cos.get)
    log(f"train parity (2 layers, T {TRAIN_SEQ}, B 2): loss flash "
        f"{flash[0]:.6f} dense {dense[0]:.6f} (rel {rel:.2e}, tol "
        f"{PARITY_LOSS_RTOL}); min grad cosine {cos[worst]:.6f} at {worst} "
        f"(tol {PARITY_COSINE})")
    if rel > PARITY_LOSS_RTOL or cos[worst] < PARITY_COSINE:
        raise SystemExit("flash training disagrees with dense attention")
    for policy in ("dots_no_batch", "full"):
        remat = run(dataclasses.replace(cfg, remat=True, remat_policy=policy))
        differ = [p for p, g in flash[1].items()
                  if not torch.equal(g, remat[1][p])]
        log(f"train parity: remat {policy} vs off: loss "
            f"{'identical' if remat[0] == flash[0] else 'DIFFERS'}, "
            f"{len(flash[1]) - len(differ)}/{len(flash[1])} grad leaves "
            f"identical {differ or ''}")
        if remat[0] != flash[0] or differ:
            raise SystemExit(f"remat {policy} changed the loss or grads")


# -- phase 6 -----------------------------------------------------------------

#: the full-width corpus has text8's shape: word2vec.c cuts text8 into
#: 1,000-word sentences, and text8 has 71,290 word types at min-count 5;
#: 4,000 sentences (4 M of its 17 M tokens) keep the smoke's time
W2V_SENTENCES, W2V_SENT_LEN, W2V_TYPES = 4000, 1000, 71290
#: word2vec.c's size and window; Word2Vec's own batch and learning rate
W2V_DIM, W2V_WINDOW, W2V_BATCH, W2V_LR = 100, 5, 4096, 0.025
#: sentences of the HS+NS run (the per-batch path)
W2V_NS_SENTENCES = 500
#: ceiling on max |syn0| after a full-width fit. Batched HS on this corpus
#: is chaotic (a 1e-6 change of syn0 moves over a thousand rows by more
#: than 1e-3 within 30 sentences), so the value is not reproducible, but it
#: stays in the tens (the JAX package reaches 66.3 on the CPU from
#: numpy-seeded tables); clipping saturated dots instead of skipping them
#: reaches 1e14 within 30 sentences (scripts/torch_w2v_reference.py)
W2V_SYN0_CEILING = 1000.0


def zipf_corpus(n_sent: int, n_tok: int, n_types: int,
                seed: int = 0) -> list[str]:
    """``n_sent`` sentences of ``n_tok`` words ``w<rank>``, the ranks drawn
    from Zipf(1.0) over ``n_types`` types."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_types + 1)
    ranks = rng.choice(n_types, size=(n_sent, n_tok), p=p / p.sum())
    names = np.array([f"w{r}" for r in range(n_types)])
    return [" ".join(names[row]) for row in ranks]


def topic_corpus(n: int, seed: int = 0) -> list[str]:
    """The reference tests' two-topic corpus (tests/test_nlp.py:28):
    day/sun/light/... vs night/moon/dark/... with filler words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    day = ["day", "sun", "light", "morning", "bright", "noon"]
    night = ["night", "moon", "dark", "evening", "stars", "midnight"]
    fillers = ["the", "a", "was", "very", "and", "it", "sky", "time"]
    sents = []
    for _ in range(n):
        topic = day if rng.random() < 0.5 else night
        words = list(rng.choice(topic, size=4)) + list(
            rng.choice(fillers, size=3))
        rng.shuffle(words)
        sents.append(" ".join(words))
    return sents


def w2v_full_model():
    """The full-width Word2Vec (HS) with its vocabulary built, and its
    corpus. Phase 2 needs the vocabulary's longest Huffman path."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )

    t0 = time.perf_counter()
    corpus = zipf_corpus(W2V_SENTENCES, W2V_SENT_LEN, W2V_TYPES)
    t1 = time.perf_counter()
    model = Word2Vec(layer_size=W2V_DIM, window=W2V_WINDOW,
                     batch_pairs=W2V_BATCH, lr=W2V_LR, min_word_frequency=1,
                     epochs=1)
    model.build_vocab(CollectionSentenceIterator(corpus))
    log(f"word2vec: corpus {W2V_SENTENCES} sentences x {W2V_SENT_LEN} "
        f"tokens, Zipf(1.0) over {W2V_TYPES} types, seed 0, in "
        f"{t1 - t0:.1f} s; build_vocab {time.perf_counter() - t1:.1f} s: "
        f"V {len(model.cache)}, max code length "
        f"{model.cache.max_code_length}")
    return model, corpus


def _w2v_run(tag: str, fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; kernel #5 must have launched. Returns (launches, seconds
    on the host clock, fn's result)."""
    import torch

    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    if launches["emb_dot"] <= 0:
        raise SystemExit(f"{tag}: kernel emb_dot never launched")
    return launches, secs, out


def _counted_fit(model, sentences) -> int:
    """``model.fit(sentences)``; returns the number of skip-gram pairs its
    pair enumerator produced."""
    from deeplearning4j_tpu_torch import native_io

    real = native_io.sg_pairs_chunk
    pairs = 0

    def counted(*a):
        nonlocal pairs
        ins, tgts = real(*a)
        pairs += len(ins)
        return ins, tgts

    native_io.sg_pairs_chunk = counted
    try:
        model.fit(sentences)
    finally:
        native_io.sg_pairs_chunk = real
    return pairs


def _bounded(tag: str, model) -> float:
    """Every table finite and max |syn0| under W2V_SYN0_CEILING (the guard
    against clipping saturated dots instead of skipping them)."""
    import torch

    for name in ("syn0", "syn1", "syn1neg"):
        if not bool(torch.isfinite(getattr(model, name)).all()):
            raise SystemExit(f"{tag}: {name} is not finite")
    top = model.syn0.abs().max().item()
    if not top < W2V_SYN0_CEILING:
        raise SystemExit(f"{tag}: max |syn0| {top} is not < "
                         f"{W2V_SYN0_CEILING}")
    return top


def _w2v_fit_run(tag: str, model, sentences, card: str) -> dict[str, int]:
    launches, secs, pairs = _w2v_run(tag, lambda: _counted_fit(model,
                                                              sentences))
    top = _bounded(tag, model)
    log(f"{tag}: V {len(model.cache)}, max code length "
        f"{model.cache.max_code_length}, {pairs} pairs, "
        f"{launches['emb_dot']} HS batches of {model.batch_pairs}; fit "
        f"{secs:.2f} s -> {pairs / secs:.1f} pairs/s (host clock, "
        f"tokenizing and pair enumeration included; {card}); max |syn0| "
        f"{top:.4f}; launches {launches}")
    return launches


def phase_word2vec(model, corpus, card: str) -> dict[str, dict[str, int]]:
    """Phase 6. Returns each run's launch counts."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.paragraph_vectors import (
        ParagraphVectors,
    )
    from deeplearning4j_tpu_torch.models.word2vec import (
        Word2Vec,
        word2vec_state_from_jax,
    )
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )

    runs = {"w2v_full": _w2v_fit_run(
        "w2v full width (HS)", model, CollectionSentenceIterator(corpus),
        card)}

    ns = Word2Vec(layer_size=W2V_DIM, window=W2V_WINDOW,
                  batch_pairs=W2V_BATCH, lr=W2V_LR, min_word_frequency=1,
                  epochs=1, negative=5)
    sub = CollectionSentenceIterator(corpus[:W2V_NS_SENTENCES])
    ns.build_vocab(sub)
    runs["w2v_hs_ns"] = _w2v_fit_run(
        f"w2v HS+NS ({W2V_NS_SENTENCES} sentences, negative 5)", ns, sub,
        card)
    del ns

    # card vs CPU from the same tables, and the card twice. Batches of 256:
    # at 1,024 pairs every one of the 20 words recurs ~50 times a batch, the
    # fit is chaotic and the card and CPU fits ended 2.5 apart; at 256 the
    # same fit holds the CPU tests' bar against the JAX package
    # (tests/test_torch_word2vec.py, case "smoke_topic")
    topic = topic_corpus(300)
    cfg = dict(layer_size=32, window=5, epochs=4, lr=0.05, seed=1,
               batch_pairs=256)
    probe = Word2Vec(device="cpu", **cfg)
    probe.build_vocab(CollectionSentenceIterator(topic))
    v, d = len(probe.cache), cfg["layer_size"]
    rng = np.random.default_rng(0)
    tables = (((rng.random((v, d)) - 0.5) / d).astype(np.float32),
              np.zeros((v - 1, d), np.float32), np.zeros((v, d), np.float32))

    def fit_on(device):
        m = Word2Vec(device=device, **cfg)
        m.build_vocab(CollectionSentenceIterator(topic))
        st = word2vec_state_from_jax(*tables, device=device)
        m.syn0, m.syn1, m.syn1neg = st["syn0"], st["syn1"], st["syn1neg"]
        m.fit(CollectionSentenceIterator(topic))
        return m

    host = fit_on("cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the step must not care
    try:
        runs["w2v_card_tf32"], _, first = _w2v_run("w2v card vs cpu",
                                                   lambda: fit_on("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    runs["w2v_card_repeat"], _, again = _w2v_run("w2v card repeat",
                                                 lambda: fit_on("cuda"))
    errs = {n: (getattr(first, n).cpu() - getattr(host, n)).abs().max().item()
            for n in ("syn0", "syn1")}
    bitwise = all(torch.equal(getattr(first, n), getattr(again, n))
                  for n in ("syn0", "syn1", "syn1neg"))
    log(f"w2v card vs cpu (topic corpus, V {v}, D {d}, 4 epochs, batches "
        f"of {cfg['batch_pairs']}, same tables): max |card - cpu| syn0 "
        f"{errs['syn0']:.3e}, syn1 {errs['syn1']:.3e} (tol {W2V_TOL}); "
        f"card repeat (TF32 allowed in the first run, not in the second) "
        f"bitwise equal: {bitwise}; launches per card run "
        f"{runs['w2v_card_repeat']['emb_dot']}")
    if max(errs.values()) > W2V_TOL or not bitwise:
        raise SystemExit("word2vec on the card disagrees with the CPU or "
                         "with itself")

    q = Word2Vec(layer_size=32, window=5, epochs=24, lr=0.05, seed=1)
    runs["w2v_quality"], secs, _ = _w2v_run(
        "w2v quality", lambda: q.fit(CollectionSentenceIterator(
            topic_corpus(400))))
    same, cross = q.similarity("day", "sun"), q.similarity("day", "moon")
    log(f"w2v quality (the reference test's fit: 400 sentences, D 32, 24 "
        f"epochs, {secs:.2f} s): similarity(day, sun) {same:.4f} > "
        f"similarity(day, moon) {cross:.4f}: {same > cross}; nearest to "
        f"night {q.words_nearest('night', top=5)}")
    if not same > cross:
        raise SystemExit("word2vec on the card did not learn the topics")

    gen = np.random.default_rng(5)
    docs = []
    for _ in range(100):
        docs.append(("daytime", " ".join(gen.choice(
            ["day", "sun", "light", "bright"], 5))))
        docs.append(("nighttime", " ".join(gen.choice(
            ["night", "moon", "dark", "stars"], 5))))
    for tag, kw in (("pv_hs", dict(train_words=False)),
                    ("pv_hs_ns", dict(train_words=True, negative=5))):
        pv = ParagraphVectors(layer_size=16, epochs=12, lr=0.05, seed=6,
                              **kw)
        runs[tag], secs, _ = _w2v_run(tag, lambda: pv.fit_labeled(docs))
        finite = bool(torch.isfinite(pv.syn0_labels).all())
        guess = (pv.infer_nearest_label("sun light bright day"),
                 pv.infer_nearest_label("moon stars dark night"))
        log(f"{tag} ({'label pass only' if not pv.train_words else 'words and labels'}"
            f", {secs:.2f} s): kernel #5 launches {runs[tag]['emb_dot']}, "
            f"labels finite {finite}, nearest labels {guess}")
        if not finite:
            raise SystemExit(f"{tag}: label vectors not finite")
        if pv.train_words and guess != ("daytime", "nighttime"):
            raise SystemExit(f"{tag}: documents classified as {guess}")
    return runs


# -- phase 7 -----------------------------------------------------------------

#: phase 7a: the train command that writes the two checkpoints
CKPT_BATCH = 8
CKPT_TRAIN = ["train", "--model", "transformer", "--preset", "gpt2s",
              "--flash", "--remat", "--steps", "4", "--batch",
              str(CKPT_BATCH), "--seq-len", str(TRAIN_SEQ), "--save-every",
              "2"]
#: the CLI's default prompt ("the quick brown ", 16 bytes) and --max-new,
#: as train's closing sample and phase 7b's generate run them
GEN_PROMPT, GEN_NEW = 16, 48
#: beam search on the serve smoke's model: B 1, W 4, prompt 128, 32 new
BEAM_W, BEAM_PROMPT, BEAM_NEW = 4, 128, 32
#: a beam's score (the decode's summed log-probs) vs its sequence's
#: log-likelihood by ``transformer_apply`` in f32 on the weights the decode
#: used, in nats per generated token: bf16 compute, and in int8 mode the
#: int8 KV cache, against f32 (on the H100 the four beams' largest gap is
#: 0.11 nats over 32 tokens in bf16, 0.14 in int8; with the planted stale
#: cache of ``planted_stale_cache`` 0.72 and 2.01)
BEAM_LL_TOL = 0.01
#: speculative decoding at the reference bench's spec row (bench.py:752,
#: _decode_bench_cfg(batch=1, gqa=True)): prompt 512, 64 new, k 4, the
#: int8-weight self-draft; the timed runs sample at temperature 1, top-k 40
SPEC_PROMPT, SPEC_NEW, SPEC_K, SPEC_TOP_K = 512, 64, 4, 40
#: timed runs a side, spec and plain generate in turns
SPEC_RUNS = 5


def _printable(line: str) -> str:
    return "".join(c if c.isprintable() else f"\\x{ord(c):02x}"
                   for c in line)


def _cli(tag: str, argv: list[str]) -> tuple[dict[str, int], str]:
    """``cli.main(argv)`` in this process with every launch count set to 0
    just before and read just after; its standard output is captured and
    logged. Exits unless it returns 0. Returns (launches, output)."""
    import io

    import torch

    from deeplearning4j_tpu_torch import cli

    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    out = buf.getvalue()
    log(f"{tag}: `{' '.join(argv)}` -> exit {rc} in {secs:.2f} s; "
        f"launches {launches}")
    for line in out.splitlines():
        log(f"  | {_printable(line)}")
    if rc != 0:
        raise SystemExit(f"{tag}: exit code {rc}")
    return launches, out


def _expect_output(tag: str, out: str, lines: list[str]) -> None:
    """``out`` must be the printed ``lines``, each a regular expression
    (a decoded byte stream may hold line breaks of its own)."""
    import re

    if not re.fullmatch("\n".join(lines) + "\n", out, re.S):
        raise SystemExit(f"{tag}: printed {out!r}, expected lines matching "
                         f"{lines!r}")


def _must_launch(tag: str, launches: dict[str, int], names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise SystemExit(f"{tag}: kernel {name} never launched")


def phase_checkpoint(workdir: Path, card: str) -> dict[str, dict[str, int]]:
    """Phase 7a-b: ``train --checkpoint-dir`` at full width, the two
    checkpoints read back bitwise, then ``generate`` from them (beam 4, and
    greedy int8 full). Returns the launches of each run."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        param_shapes,
    )
    from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt

    d = workdir / "ckpt"
    argv = CKPT_TRAIN + ["--checkpoint-dir", str(d)]
    # time each checkpoint write inside the train command
    writes, save = [], ckpt.save

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = save(*a, **kw)
        writes.append(time.perf_counter() - t0)
        return out

    ckpt.save = timed_save
    try:
        train, _ = _cli("checkpoint train", argv)
    finally:
        ckpt.save = save
    _must_launch("checkpoint train", train,
                 ("flash_attn_fwd", "flash_attn_bwd"))
    names = sorted(f.name for f in d.iterdir())
    meta = ckpt.CheckpointManager(d).read_meta()
    want = cli._cfg_from_args(cli.build_parser().parse_args(argv))
    got = TransformerConfig.from_json(meta["config"])
    path = d / "ckpt_4.npz"
    log(f"checkpoint: files {names}, {path.stat().st_size / 2**20:.1f} MiB "
        f"each; writes {', '.join(f'{w:.3f}' for w in writes)} s (host "
        f"clock, device-to-host copy included; {card}); meta step "
        f"{meta['step']}, loss {meta['loss']:.4f}, config == the preset's: "
        f"{got == want}")
    if (names != ["ckpt_2.npz", "ckpt_4.npz"] or meta["step"] != 4
            or got != want or len(writes) != 2):
        raise SystemExit("checkpoint: wrong files, step or config")
    t0 = time.perf_counter()
    params, _ = ckpt.restore(path, param_shapes(got))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__manifest__"}
    same = [k for k, leaf in ckpt.flat_leaves(params)
            if torch.equal(leaf.cpu(), torch.from_numpy(flat[k]))]
    log(f"checkpoint: restore {restore_s:.3f} s onto the card; "
        f"{len(same)}/{len(flat)} leaves equal the npz arrays bitwise")
    if len(same) != len(flat):
        raise SystemExit("checkpoint: restored params differ from the file")
    del params, flat

    beam, out = _cli("generate beam", [
        "generate", "--checkpoint-dir", str(d), "--beam", "4",
        "--max-new", "48"])
    _expect_output("generate beam", out, [r"restored step 4 from \S+"] + [
        rf"beam {w} \(logp -?\d+\.\d\d\): the quick brown .*"
        for w in range(4)])
    _must_launch("generate beam", beam, ("flash_attn_fwd", "flash_decode"))
    greedy, out = _cli("generate int8", [
        "generate", "--checkpoint-dir", str(d), "--int8", "full",
        "--temperature", "0"])
    _expect_output("generate int8", out, [
        r"restored step 4 from \S+",
        r"int8 serving mode: full \(weights \+ kv cache\)",
        r"sample: the quick brown .*"])
    _must_launch("generate int8", greedy,
                 ("flash_attn_fwd", "flash_decode_int8"))
    return {"train_ckpt": train,
            "generate_ckpt": {k: beam[k] + greedy[k] for k in beam}}


def _dequantized(params):
    """The f32 weights an int8 tree stands for: every int8 leaf times its
    ``*_scale`` sibling (norm scales such as ``ln1_scale`` have no int8
    leaf beside them and stay)."""
    import torch

    def deq(tree):
        return {n: (a.float() * tree[n + "_scale"]
                    if a.dtype == torch.int8 else a)
                for n, a in tree.items()
                if not (n.endswith("_scale") and n[:-len("_scale")] in tree)}

    out = deq({k: v for k, v in params.items() if k != "blocks"})
    out["blocks"] = deq(params["blocks"])
    return out


def _ll_gap(cfg, params, int8: bool, toks, scores) -> float:
    """max over the beams of |score - its sequence's log-likelihood by
    ``transformer_apply`` in f32 on the weights the decode used|."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.models.transformer import transformer_apply

    ref_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                  use_flash=False, decode_int8=False)
    with torch.no_grad():
        logits, _ = transformer_apply(ref_cfg)(
            _dequantized(params) if int8 else params, toks[0])
    tp = toks.shape[2] - BEAM_NEW
    logp = torch.log_softmax(logits, dim=-1)[:, tp - 1:-1]
    ll = logp.gather(-1, toks[0, :, tp:, None])[..., 0].sum(-1)
    return (scores[0] - ll).abs().max().item()


def _teacher_forced(cfg, params, prompt, toks):
    """Each beam's summed log-probs with its own tokens fed through the
    decode program the beam search runs (the prompt prefilled at B 1, its
    rows tiled to W, then one decode step a token at B W), added in the
    beam's order. A row's logits do not depend on the other rows, so this
    equals the beam's scores bitwise when every cache row and score
    followed its beam's parents."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        _decode_builder,
        kv_map,
    )

    fwd1, init_caches, prefill, cast = _decode_builder(cfg)
    params = cast(params)
    _, w, total = toks.shape
    tp = prompt.shape[1]
    with torch.no_grad():
        caches, logits = prefill(params, init_caches(1, total, prompt.device),
                                 prompt)
        caches = kv_map(lambda a: a.repeat_interleave(w, dim=2), caches)
        logp = torch.log_softmax(logits, dim=-1).expand(w, -1)
        score = torch.zeros(w, device=prompt.device)
        for i in range(tp, total):
            tok = toks[0, :, i]
            score = score + logp.gather(-1, tok[:, None])[:, 0]
            logits, caches = fwd1(params, caches, tok, i)
            logp = torch.log_softmax(logits, dim=-1)
    return score


@contextlib.contextmanager
def planted_stale_cache():
    """A planted fault for phase 7c's checks: inside the block, beam search
    reorders its token history but not its caches (``kv_map``'s calls
    after the first, the W tiling, return the cache unchanged)."""
    from deeplearning4j_tpu_torch.models import transformer as tm

    real, calls = tm.kv_map, []

    def stale(fn, *caches):
        calls.append(fn)
        return real(fn, *caches) if len(calls) == 1 else caches[0]

    tm.kv_map = stale
    try:
        yield
    finally:
        tm.kv_map = real


def phase_beam(int8: bool, card: str) -> dict[str, int]:
    """Phase 7c: beam search, B 1, W 4, prompt 128, 32 new, on the serve
    smoke's model (bf16, or int8 full). W 1 must equal greedy generate
    bitwise; the W 4 scores must be sorted, equal bitwise the beams' own
    tokens teacher-forced through the same decode program, and each lie
    within BEAM_LL_TOL a token of its sequence's log-likelihood. A run
    with a planted stale cache must fail the teacher-forced check; its
    log-likelihood gap is logged beside the sound run's. Returns the W 4
    run's launches."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_beam_search,
        transformer_generate,
    )

    tag = "beam int8" if int8 else "beam"
    cfg, params = serve_model(int8)
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, BEAM_PROMPT))).cuda()
    beam = transformer_beam_search(cfg)
    greedy = transformer_generate(cfg)(params, prompt, BEAM_NEW,
                                       temperature=0.0)
    w1, _ = beam(params, prompt, 1, BEAM_NEW)
    reset_launches()
    toks, scores = beam(params, prompt, BEAM_W, BEAM_NEW)
    torch.cuda.synchronize()
    launches = read_launches()
    times = {}
    for n in (1, BEAM_NEW):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            beam(params, prompt, BEAM_W, n)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        times[n] = float(np.median(runs))
    step_ms = (times[BEAM_NEW] - times[1]) / (BEAM_NEW - 1) * 1e3
    gap = _ll_gap(cfg, params, int8, toks, scores)
    forced = _teacher_forced(cfg, params, prompt, toks)
    forced_same = torch.equal(forced, scores[0])
    with planted_stale_cache():
        bad_toks, bad_scores = beam(params, prompt, BEAM_W, BEAM_NEW)
    bad_forced = _teacher_forced(cfg, params, prompt, bad_toks)
    bad_seen = not torch.equal(bad_forced, bad_scores[0])
    bad_gap = _ll_gap(cfg, params, int8, bad_toks, bad_scores)
    same = torch.equal(w1[:, 0], greedy)
    ordered = bool((scores[0, :-1] >= scores[0, 1:]).all())
    log(f"{tag}: B 1, W {BEAM_W}, prompt {BEAM_PROMPT}, {BEAM_NEW} new; "
        f"W 1 == greedy generate bitwise: {same}; scores "
        f"{[round(x, 4) for x in scores[0].tolist()]} sorted {ordered}; "
        f"== teacher-forced bitwise: {forced_same} (max |diff| "
        f"{(forced - scores[0]).abs().max().item():.3g}); max |score - "
        f"log-likelihood (f32 transformer_apply)| {gap:.4f} (tol "
        f"{BEAM_LL_TOL * BEAM_NEW:.2f} = {BEAM_LL_TOL} a token); planted "
        f"stale cache: teacher-forced check fails {bad_seen} (max |diff| "
        f"{(bad_forced - bad_scores[0]).abs().max().item():.4g}), "
        f"log-likelihood gap {bad_gap:.4f}; {step_ms:.3f} ms a beam step "
        f"((median of 3 at {BEAM_NEW} new - median of 3 at 1) / "
        f"{BEAM_NEW - 1}, host clock; {card}); launches {launches}")
    if (not same or not ordered or not forced_same
            or gap > BEAM_LL_TOL * BEAM_NEW):
        raise SystemExit(f"{tag}: beam search failed its checks")
    if not bad_seen:
        raise SystemExit(f"{tag}: the teacher-forced check passed a beam "
                         f"search with a stale cache")
    _must_launch(tag, launches, ("flash_attn_fwd", "flash_decode_int8"
                                 if int8 else "flash_decode"))
    return launches


def spec_config():
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=50304, d_model=768, n_heads=6, n_layers=12, d_ff=3072,
        max_len=SPEC_PROMPT + SPEC_NEW + 1, use_flash=True, n_kv_heads=2,
        rope=True, compute_dtype=torch.bfloat16)


def _count_syncs(fn):
    """(fn's result, the host syncs it made, where they were made): PyTorch's
    sync debug mode warns at every synchronizing CUDA call; each warning's
    place is the innermost three frames of the Python stack that made it.
    Switching the mode itself warns once; that warning is not fn's."""
    import collections
    import traceback
    import warnings

    import torch

    where = collections.Counter()
    inside = False

    def record(message, category, filename, lineno, file=None, line=None):
        if inside and "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if Path(f.filename).name != "warnings.py"][-3:]
            where[" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                             for f in reversed(frames))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside = True
            out = fn()
            inside = False
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(where.values()), dict(where)


def phase_spec(card: str) -> dict[str, int]:
    """Phase 7d: speculative decoding at the bench's spec geometry with
    the int8-weight self-draft. Greedy: held against generate by the
    logit-difference rule; sampled: repeatable per generator seed; the
    rounds, acceptance, host syncs a round and tokens/s against plain
    generate. Returns the greedy run's launches."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
        transformer_generate,
        transformer_speculative_generate,
    )

    cfg = spec_config()
    params = init_params(cfg, seed=0)
    draft = quantize_decode_params(params, cfg)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, SPEC_PROMPT))).cuda()
    spec = transformer_speculative_generate(cfg)
    gen = transformer_generate(cfg)
    ref, ref_logits = gen(params, prompt, SPEC_NEW, temperature=0.0,
                          return_logits=True)
    torch.cuda.synchronize()
    reset_launches()
    (out, logits, stats), syncs, where = _count_syncs(lambda: spec(
        params, draft, prompt, SPEC_NEW, draft_k=SPEC_K, temperature=0.0,
        return_logits=True, return_stats=True))
    torch.cuda.synchronize()
    launches = read_launches()
    delta = (logits - ref_logits).abs().amax(dim=(1, 2))
    diff = (out[0] != ref[0]).nonzero()
    if diff.numel():
        j = int(diff[0]) - SPEC_PROMPT
        top2 = torch.topk(ref_logits[j, 0], 2).values
        gap = (top2[0] - top2[1]).item()
        ok = gap <= 2 * delta[j].item()
        verdict = (f"first divergence at generated position {j}: generate's "
                   f"top-2 gap {gap:.4g}, max |delta logit| there "
                   f"{delta[j].item():.4g} (bar: gap <= 2 x that); max "
                   f"|delta logit| before it "
                   f"{delta[:j].max().item() if j else 0.0:.4g}")
    else:
        ok = True
        verdict = (f"identical to generate over {SPEC_NEW} tokens; max "
                   f"|delta logit| {delta.max().item():.4g}")
    spec_tokens = out[0, SPEC_PROMPT:]
    taken = bool((logits.argmax(-1)[:, 0] == spec_tokens).all())
    rounds = stats["rounds"]
    log(f"spec: {cfg.d_model}d x {cfg.n_layers}L, vocab {cfg.vocab_size}, "
        f"{cfg.n_heads} heads over {cfg.kv_heads} KV heads of "
        f"{cfg.head_dim}, rope, max_len {cfg.max_len}, bf16, int8-weight "
        f"self-draft, B 1, prompt "
        f"{SPEC_PROMPT}, {SPEC_NEW} new, k {SPEC_K}; greedy: {verdict}; "
        f"each token the argmax of its verify logits {taken}; {rounds} "
        f"rounds, accepted a round {stats['accepted']} (mean "
        f"{np.mean(stats['accepted']):.3f}), host syncs {syncs} "
        f"({syncs / rounds:.3f} a round, at {where}); launches {launches}")
    if not ok or not taken:
        raise SystemExit("spec: the greedy stream left generate's by more "
                         "than the logit difference explains")
    if syncs != rounds:
        raise SystemExit(f"spec: {syncs} host syncs in {rounds} rounds; one "
                         f"a round expected")
    _must_launch("spec", launches, ("flash_attn_fwd", "flash_decode"))

    def sampled(seed, stats=False):
        return spec(params, draft, prompt, SPEC_NEW, draft_k=SPEC_K,
                    temperature=1.0, top_k=SPEC_TOP_K,
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed), return_stats=stats)

    (a, a_stats), a_syncs, a_where = _count_syncs(
        lambda: sampled(1, stats=True))
    b, c = sampled(1), sampled(2)
    same, differ = torch.equal(a, b), not torch.equal(a, c)
    log(f"spec sampled (temperature 1, top-k {SPEC_TOP_K}): seed 1 twice "
        f"equal {same}, seed 2 differs {differ}; {a_stats['rounds']} rounds, "
        f"accepted a round mean {np.mean(a_stats['accepted']):.3f}, host "
        f"syncs {a_syncs / a_stats['rounds']:.3f} a round (at {a_where})")
    if not same or not differ or a_syncs != a_stats["rounds"]:
        raise SystemExit("spec sampled: not repeatable per seed, or more "
                         "than one host sync a round")

    walls = {"spec": [], "generate": []}
    rounds_timed = []
    for i in range(SPEC_RUNS):
        order = ("spec", "generate") if i % 2 == 0 else ("generate", "spec")
        for side in order:
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "spec":
                _, st = spec(params, draft, prompt, SPEC_NEW, draft_k=SPEC_K,
                             temperature=1.0, top_k=SPEC_TOP_K, generator=g,
                             return_stats=True)
                rounds_timed.append(st["rounds"])
            else:
                gen(params, prompt, SPEC_NEW, temperature=1.0,
                    top_k=SPEC_TOP_K, generator=g)
            torch.cuda.synchronize()
            walls[side].append(time.perf_counter() - t0)
    rate = {k: [SPEC_NEW / w for w in v] for k, v in walls.items()}
    log("spec vs generate, B 1, sampled, tokens/s (64 new over the whole "
        f"call, prefill included; host clock, {SPEC_RUNS} runs a side in "
        f"turns; {card}): " + "; ".join(
            f"{k} median {np.median(v):.2f} (range {min(v):.2f}-"
            f"{max(v):.2f})" for k, v in rate.items())
        + f"; spec rounds per timed run {rounds_timed}")
    return launches


def phase_decode_variants(card: str) -> dict[str, dict[str, int]]:
    """Phase 7: checkpoint train and generate, beam search and
    speculative decoding; reports its wall seconds. The checkpoints go to
    an ignored directory of the checkout, removed at the end."""
    import shutil

    import torch

    t0 = time.perf_counter()
    workdir = ROOT / ".scratch" / "chip_smoke_phase7"
    shutil.rmtree(workdir, ignore_errors=True)
    with launched_shapes() as seen:
        try:
            runs = phase_checkpoint(workdir, card)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
        runs["beam"] = phase_beam(False, card)
        runs["beam_int8"] = phase_beam(True, card)
        runs["spec"] = phase_spec(card)
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t0:.1f} s wall")
    check_launched("phase 7", seen)
    return runs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "deeplearning4j_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repo "
              "(deeplearning4j_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}")
    phase_build()
    w2v_model, w2v_corpus = w2v_full_model()
    measured = phase_kernels(w2v_model, w2v_corpus)
    with launched_shapes() as early:
        engine, serve_launches, streams = phase_serve()
        phase_server(engine)
        del engine
        _, int8_launches, int8_streams = phase_serve(int8=True)
        by_phase = {
            "serve": serve_launches,
            "serve_int8": int8_launches,
            "serve_paged": phase_serve_paged(False, streams),
            "serve_paged_int8": phase_serve_paged(True, int8_streams),
        }
        torch.cuda.empty_cache()  # the serving engines' caches go back
        phase_train_parity()
        by_phase["train"] = phase_train(card)
        by_phase.update(phase_word2vec(w2v_model, w2v_corpus, card))
    check_launched("phases 3-6", early)
    del w2v_model
    by_phase.update(phase_decode_variants(card))
    kernels = [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=sum(p[name] for p in by_phase.values()),
             launches_per_phase={ph: p[name] for ph, p in by_phase.items()},
             **{k: v for k, v in measured[name].items() if k != "ok"})
        for name in KERNELS
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
