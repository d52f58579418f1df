"""Command line of the port: ``python -m deeplearning4j_tpu_torch serve``.

``serve --demo`` serves a random-init transformer (weights from ``--seed``)
through ``ServingEngine`` + ``ServingServer``; the model flags are the JAX
CLI's (``--seq-len``, ``--d-model``, ``--n-layers``, ``--n-heads``,
``--bf16``), plus ``--preset gpt2s`` for the GPT-2-small geometry and
``--flash`` for the flash prefill kernel. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import torch

#: GPT-2-small serving geometry (the JAX bench's "transformer" preset:
#: 6 heads of 128, bf16, 50304-token vocabulary) with GPT-2's 1024 positions
PRESETS = {
    "gpt2s": dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=6,
                  d_ff=3072, max_len=1024, bf16=True),
}


def _cfg_from_args(args):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    if args.preset:
        p = dict(PRESETS[args.preset])
        bf16 = p.pop("bf16") or args.bf16
        return TransformerConfig(
            **p, use_flash=args.flash,
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        )
    # the JAX CLI's flags -> config recipe (byte vocab, d_ff = 4 d_model,
    # max_len = seq_len + 1)
    return TransformerConfig(
        vocab_size=256, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=4 * args.d_model,
        max_len=args.seq_len + 1, n_experts=args.n_experts,
        use_flash=args.flash,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )


def cmd_serve(args) -> int:
    from deeplearning4j_tpu_torch.models.transformer import init_params
    from deeplearning4j_tpu_torch.serving import (
        RequestScheduler,
        ServingEngine,
        ServingServer,
    )

    if not args.demo:
        print("serve needs --demo (checkpoint loading is a later slice)",
              file=sys.stderr)
        return 2
    cfg = _cfg_from_args(args)
    params = init_params(cfg, seed=args.seed, device=args.device)
    engine = ServingEngine(
        cfg, params, n_slots=args.slots, max_total=args.max_total,
        temperature=args.temperature,
        top_k=args.top_k if args.top_k > 0 else None,
        decode_horizon=args.decode_horizon,
        scheduler=RequestScheduler(max_queue_depth=args.max_queue),
        rng_seed=args.seed, device=args.device,
    )
    server = ServingServer(engine, host=args.host, port=args.port,
                           request_timeout_s=args.request_timeout)
    host, port = server.address
    print(f"demo mode: random-init model ({cfg.d_model}d, {cfg.n_layers}L, "
          f"vocab {cfg.vocab_size}, {cfg.compute_dtype}) on {engine.device}")
    print(f"serving on http://{host}:{port}  ({args.slots} slots, "
          f"{engine.max_total} tokens/slot, decode horizon "
          f"{engine.decode_horizon}, queue depth {args.max_queue})",
          flush=True)
    server.serve_forever(drain_s=args.drain_s)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("serve", help="continuous-batching HTTP serving")
    v.add_argument("--demo", action="store_true",
                   help="serve a random-init model (weights from --seed)")
    v.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8080)
    v.add_argument("--slots", type=int, default=8)
    v.add_argument("--max-total", type=int, default=None,
                   help="per-slot token budget (prompt + max_new)")
    v.add_argument("--max-queue", type=int, default=128)
    v.add_argument("--temperature", type=float, default=0.8)
    v.add_argument("--top-k", type=int, default=40, help="0 disables")
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--request-timeout", type=float, default=300.0)
    v.add_argument("--decode-horizon", type=int, default=4)
    v.add_argument("--drain-s", type=float, default=5.0)
    v.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="model geometry preset (overrides the flags below)")
    v.add_argument("--flash", action="store_true",
                   help="bulk prefill through the flash attention kernel")
    v.add_argument("--seq-len", type=int, default=128)
    v.add_argument("--d-model", type=int, default=128)
    v.add_argument("--n-layers", type=int, default=2)
    v.add_argument("--n-heads", type=int, default=4)
    v.add_argument("--n-experts", type=int, default=0,
                   help="MoE experts (a later slice: > 0 raises)")
    v.add_argument("--bf16", action="store_true")
    v.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
