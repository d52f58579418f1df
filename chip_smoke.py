#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without printing a result:

1. build every CUDA kernel of ``deeplearning4j_tpu_torch/csrc`` with nvcc
   (all sources at once) and print the build time and the card;
2. hold each kernel against its plain PyTorch version on the card, in bf16
   at the shapes the serving and training paths give it, and time kernel,
   plain version, bound and one library call (a yardstick the port never
   calls);
3. serve the GPT-2-small configuration (random weights from a seed) through
   ``ServingEngine``: about eight greedy requests, some past the 128-token
   prefill bucket, with every kernel's launch count set to 0 just before and
   read just after; two streams are held against the port's
   ``transformer_generate``;
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
   (bitwise equal: every kernel of the path is deterministic).

The last lines are the kernel table as one JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

#: stated tolerances, kernel vs plain version on the same bf16 inputs: the
#: kernel's online softmax rounds its probabilities to bf16 against the
#: running max of each 64-row tile, the plain version against the row max
ATTN_TOL = 2e-2
LSE_TOL = 1e-3
#: flash backward vs its plain version, per gradient: the reference's own
#: on-device gate for its flash backward (bench.py:392); bf16 gradients,
#: summed in other orders
GRAD_REL, GRAD_ABS = 0.02, 0.01
#: a greedy mismatch between engine and generate is reported as a near-tie
#: (cuBLAS reduces an M=1 and an M=8 product in different orders) when the
#: generate side's top-2 logit gap at that position is below this
NEAR_TIE = 0.1


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{stem}] {line.strip()}")
    return secs


# -- phase 2 -----------------------------------------------------------------

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
    return dict(ok=ok, max_abs_err=max(err, lse_err), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


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
    ref = fd.flash_decode_attention_plain(q, cache, p, hkv, layer)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err <= ATTN_TOL
    ms = time_ms(lambda: fd.flash_decode_attention(q, cache, p, hkv, layer))
    plain_ms = time_ms(
        lambda: fd.flash_decode_attention_plain(q, cache, p, hkv, layer))
    q4 = q.view(b, g, hkv, kd).permute(0, 2, 1, 3)
    k4 = cache[layer, 0].view(b, tpad, hkv, kd).permute(0, 2, 1, 3)
    v4 = cache[layer, 1].view(b, tpad, hkv, kd).permute(0, 2, 1, 3)
    mask = (torch.arange(tpad, device="cuda")[None, :] <= p[:, None].long())
    mask = mask[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask))
    rows = sum(min(x + 1, tpad) for x in pos)
    b_ms, b_by = bound(2 * rows * hk * 2 + 2 * b * g * hk * 2 + 4 * b,
                       4 * rows * hk * g)
    log(f"kernel flash_decode B={b} G={g} Hkv*K={hk} nl={nl} Tpad={tpad} "
        f"layer={layer} pos={pos}: max_abs_err {err:.3e} (tol {ATTN_TOL}), "
        f"ms {ms:.4f}, plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} "
        f"({b_by}), library_ms {lib_ms:.4f} -> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def phase_kernels() -> dict[str, dict]:
    """Kernel vs plain version at the slices' shapes. Returns, per kernel,
    the numbers of its main-path case (the last one listed: the training
    shape for the flash kernels)."""
    attn = [_attn_case(t, True) for t in (8, 64)]
    attn.append(_attn_case(128, False))
    attn.append(_attn_case(128, True))
    attn.append(_attn_case(TRAIN_SEQ, True, bh=TRAIN_BATCH * 6, iters=20))
    bwd = [_bwd_case(128, causal) for causal in (True, False)]
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=TRAIN_BATCH * 6, iters=20))
    rng = random.Random(0)
    pos = [0, 639] + [rng.randrange(1, 639) for _ in range(6)]
    dec = [
        _decode_case(4, 3, 2, 128, 2, 256, 1, [0, 17, 100, 255]),
        _decode_case(8, 1, 6, 128, 12, 640, 7, pos),
    ]
    for name, cases in (("flash_attn_fwd", attn), ("flash_attn_bwd", bwd),
                        ("flash_decode", dec)):
        if not all(c["ok"] for c in cases):
            raise SystemExit(f"kernel {name} disagrees with its plain "
                             f"version")
    return {"flash_attn_fwd": attn[-1], "flash_attn_bwd": bwd[-1],
            "flash_decode": dec[-1]}


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
}

def read_launches() -> dict[str, int]:
    """Every kernel's launch count since its last reset."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    return {"flash_attn_fwd": fa.launches, "flash_attn_bwd": fa.bwd_launches,
            "flash_decode": fd.launches}


#: prompt lengths of the served requests: bucketed prefill (<= 128, the
#: flash kernel) and chunked prefill past the 128-token bucket
PROMPT_LENGTHS = (16, 40, 77, 128, 130, 200, 257, 300)
MAX_NEW = 32


def gpt2s_config():
    import torch

    from deeplearning4j_tpu_torch.cli import PRESETS
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    p = dict(PRESETS["gpt2s"])
    p.pop("bf16")
    return TransformerConfig(**p, use_flash=True,
                             compute_dtype=torch.bfloat16)


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


def phase_serve():
    """The slice: GPT-2-small through ServingEngine, greedy. Returns the
    engine (reused by the server phase) and each kernel's launch count."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        transformer_generate,
    )
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    cfg = gpt2s_config()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    engine = ServingEngine(cfg, params, n_slots=8, max_total=640,
                           decode_horizon=4, temperature=0.0)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=MAX_NEW) for n in PROMPT_LENGTHS]
    # the reference streams first: generate also warms the card (library
    # handles, allocator, kernel libraries) before the engine is timed
    gen = transformer_generate(cfg)
    refs = {i: _generate(gen, params, reqs[i].prompt) for i in (1, 5)}
    torch.cuda.synchronize()
    log(f"serve: GPT-2-small ({cfg.d_model}d x {cfg.n_layers}L, "
        f"{cfg.n_heads}x{cfg.head_dim} heads, vocab {cfg.vocab_size}, bf16) "
        f"8 slots, max_total 640 (Tpad {engine.pool.tpad}), K=4; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    fa.reset_launches()
    fd.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"serve: launches on the main path {launches}")
    for name in ("flash_attn_fwd", "flash_decode"):
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} never launched on the main path")
    for r in reqs:
        out = results[r.id]
        if (r.status.value != "finished"
                or out.shape != (len(r.prompt) + MAX_NEW,)
                or not ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise SystemExit(f"request {r.id} ({len(r.prompt)} prompt "
                             f"tokens) came back wrong: {r.status}, "
                             f"{out.shape}")
    for i, (ref, logits) in refs.items():
        r = reqs[i]
        verdict = _parity(r.prompt, ref, logits, results[r.id])
        log(f"serve: parity vs transformer_generate, prompt "
            f"{len(r.prompt)}: {verdict}")
    # decode phase: from the first request's first token to the last
    # request's last token
    first = min(r.arrival_time + r.timing["ttft_s"] for r in reqs)
    last = max(r.arrival_time + r.timing["ttft_s"] + r.timing["decode_s"]
               for r in reqs)
    decode_tok_s = len(reqs) * (MAX_NEW - 1) / (last - first)
    s = engine.metrics.summary()
    log(f"serve: {s['n_generated']} tokens for {len(reqs)} requests in "
        f"{wall:.3f} s -> {s['n_generated'] / wall:.1f} generated tok/s, "
        f"decode phase {decode_tok_s:.1f} tok/s; "
        f"TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} ms p99 "
        f"{s['ttft_p99_s'] * 1e3:.2f} ms; TPOT p50 "
        f"{s['tpot_p50_s'] * 1e3:.3f} ms p99 {s['tpot_p99_s'] * 1e3:.3f} ms; "
        f"prefill {s['prefill_s'] * 1e3:.1f} ms total; "
        f"occupancy {s['occupancy_mean']:.2f} slots; "
        f"{s['steps']} horizons")
    return engine, launches


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
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

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

    fa.reset_launches()
    fd.reset_launches()
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
    measured = phase_kernels()
    engine, serve_launches = phase_serve()
    phase_server(engine)
    del engine
    phase_train_parity()
    by_phase = {"serve": serve_launches, "train": phase_train(card)}
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
