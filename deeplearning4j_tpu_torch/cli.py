"""Command line of the port: ``python -m deeplearning4j_tpu_torch serve`` and
``... train --model transformer``.

``train`` trains the byte-level char LM on ``--text`` (or an offline demo
corpus) with the reference's flags and recipe (``lm_optimizer``, a loss line
every 20 steps, ``final loss``, a sampled continuation), on one device.

``serve --demo`` serves a random-init transformer (weights from ``--seed``)
through ``ServingEngine`` + ``ServingServer``; the model flags are the JAX
CLI's (``--seq-len``, ``--d-model``, ``--n-layers``, ``--n-heads``,
``--bf16``), plus ``--preset gpt2s`` for the GPT-2-small geometry and
``--flash`` for the flash prefill kernel. ``--int8 weights|full`` serves
int8 weights (over a float cache, or with the int8 KV cache too) and
``--paged [--block-size N]`` a block-paged KV pool, as the reference's
flags do. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

#: GPT-2-small serving geometry (the JAX bench's "transformer" preset:
#: 6 heads of 128, bf16, 50304-token vocabulary) with GPT-2's 1024 positions
PRESETS = {
    "gpt2s": dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=6,
                  d_ff=3072, max_len=1024, bf16=True),
}


def _cfg_from_args(args):
    """ONE flags -> config recipe for train and serve, as the reference's
    ``_transformer_cfg_from_args``."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    remat = getattr(args, "remat", False)
    if args.preset:
        p = dict(PRESETS[args.preset])
        bf16 = p.pop("bf16") or args.bf16
        return TransformerConfig(
            **p, use_flash=args.flash, remat=remat,
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        )
    # the JAX CLI's flags -> config recipe (byte vocab, d_ff = 4 d_model,
    # max_len = seq_len + 1)
    return TransformerConfig(
        vocab_size=256, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=4 * args.d_model,
        max_len=args.seq_len + 1, n_experts=args.n_experts,
        use_flash=args.flash, remat=remat,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )


#: flags of the reference's ``train`` that later slices of the port cover
_LATER = {
    "checkpoint_dir": "--checkpoint-dir (checkpointing) comes with the "
                      "checkpoint slice",
    "status_port": "--status-port (the status REST / ClusterService) comes "
                   "with the cluster slice",
    "fsdp": "--fsdp comes with the torch.distributed slice",
    "n_experts": "--n-experts (MoE) comes with a later slice",
    "coordinator": "--coordinator (multi-process training) comes with the "
                   "torch.distributed slice",
}

#: the reference's offline demo corpus (deeplearning4j_tpu/cli.py)
_DEMO_TEXT = (
    b"the quick brown fox jumps over the lazy dog. "
    b"pack my box with five dozen liquor jugs. "
) * 300


def cmd_train(args) -> int:
    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer,
        transformer_generate,
        transformer_train_step,
    )

    if args.model != "transformer":
        print(f"--model {args.model} comes with the DL4J-era slice of the "
              "port; this slice trains --model transformer", file=sys.stderr)
        return 2
    for flag, msg in _LATER.items():
        if getattr(args, flag):
            print(msg, file=sys.stderr)
            return 2
    if args.tp > 1:
        print("--tp (tensor parallelism) comes with the torch.distributed "
              "slice", file=sys.stderr)
        return 2
    if args.d_model % args.n_heads:
        print(f"--d-model ({args.d_model}) must be divisible by --n-heads "
              f"({args.n_heads})", file=sys.stderr)
        return 2
    if args.text:
        try:
            data = open(args.text, "rb").read()
        except OSError as e:
            print(f"cannot read --text corpus: {e}", file=sys.stderr)
            return 2
    else:
        data = _DEMO_TEXT
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    if len(arr) < args.seq_len + 2:
        print("corpus shorter than --seq-len", file=sys.stderr)
        return 2

    cfg = _cfg_from_args(args)
    if args.seq_len > cfg.max_len:
        print(f"--seq-len ({args.seq_len}) exceeds the model's max_len "
              f"({cfg.max_len})", file=sys.stderr)
        return 2
    step, init_state, shard_tokens = transformer_train_step(
        None, cfg, optimizer=lm_optimizer(total_steps=args.steps),
        device=args.device,
    )
    params, opt_state = init_state(0)
    rng = np.random.default_rng(0)
    loss = None
    for i in range(args.steps):
        starts = rng.integers(0, len(arr) - args.seq_len - 1, args.batch)
        toks = np.stack([arr[s:s + args.seq_len + 1] for s in starts])
        params, opt_state, loss = step(params, opt_state, shard_tokens(toks))
        # read the loss (a host sync) only on the print cadence
        if (i + 1) % 20 == 0:
            print(f"step {i + 1}/{args.steps} loss {float(loss):.4f}",
                  flush=True)
    if loss is not None:
        print(f"final loss {float(loss):.4f}")

    if cfg.max_len >= 32:
        gen = transformer_generate(cfg)
        dev = params["embed"].device
        g = torch.Generator(device=dev).manual_seed(1)
        out = gen(params, torch.from_numpy(arr[None, :16]).to(dev),
                  min(cfg.max_len - 16, 48), temperature=0.8, top_k=40,
                  generator=g)
        text = bytes((out[0] % 256).cpu().numpy().astype(np.uint8))
        print("sample:", text.decode("latin-1"))
    return 0


def cmd_serve(args) -> int:
    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
    )
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
    if args.int8 != "off" and cfg.n_experts:
        print("--int8 does not cover MoE experts", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(cfg, decode_int8=(args.int8 == "full"))
    params = init_params(cfg, seed=args.seed, device=args.device)
    if args.int8 != "off":
        params = quantize_decode_params(params, cfg)
        print(f"int8 serving mode: {args.int8} ("
              f"{'weights + kv cache' if args.int8 == 'full' else 'weights over a bf16/f32 cache'})")
    engine = ServingEngine(
        cfg, params, n_slots=args.slots, max_total=args.max_total,
        temperature=args.temperature,
        top_k=args.top_k if args.top_k > 0 else None,
        decode_horizon=args.decode_horizon,
        scheduler=RequestScheduler(max_queue_depth=args.max_queue),
        rng_seed=args.seed, device=args.device,
        paged=args.paged, block_size=args.block_size,
    )
    if args.paged:
        if engine._paged:
            print(f"paged KV: {engine.pool.n_blocks} blocks x "
                  f"{engine.pool.block_size} tokens (shared pool, "
                  f"refcounted block tables)")
        else:
            print("paged KV DISABLED (parity probe failed or block size "
                  "does not divide tokens/slot); slab slots",
                  file=sys.stderr)
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
    t = sub.add_parser("train", help="train the transformer LM (one device)")
    t.add_argument("--model", default="lenet",
                   choices=["lenet", "alexnet", "transformer"],
                   help="only transformer in this slice")
    t.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")
    t.add_argument("--text", default=None, help="path to a byte-level corpus")
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="model geometry preset (overrides the flags below)")
    t.add_argument("--seq-len", type=int, default=128)
    t.add_argument("--d-model", type=int, default=128)
    t.add_argument("--n-layers", type=int, default=2)
    t.add_argument("--n-heads", type=int, default=4)
    t.add_argument("--flash", action="store_true",
                   help="flash attention kernels, forward and backward "
                   "(seq-len a multiple of 8, and <= 128 or a multiple of "
                   "128)")
    t.add_argument("--remat", action="store_true",
                   help="selective rematerialization (dots_no_batch policy)")
    t.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 params)")
    t.add_argument("--n-experts", type=int, default=0,
                   help="MoE experts (a later slice: > 0 exits 2)")
    t.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (a later slice: > 1 exits 2)")
    t.add_argument("--fsdp", action="store_true", help="(a later slice)")
    t.add_argument("--checkpoint-dir", default=None, help="(a later slice)")
    t.add_argument("--status-port", type=int, default=None,
                   help="(a later slice)")
    t.add_argument("--coordinator", default=None, help="(a later slice)")
    t.set_defaults(fn=cmd_train)
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
    v.add_argument("--int8", default="off", choices=["off", "weights", "full"],
                   help="int8 weights over a float cache, or the fully "
                   "quantized path (int8 KV cache and decode kernel too)")
    v.add_argument("--paged", action="store_true",
                   help="block-paged KV: slots hold int32 block tables over "
                   "one shared refcounted pool instead of fixed slabs; "
                   "gated by a one-time bitwise parity probe, falls back "
                   "to slab slots")
    v.add_argument("--block-size", type=int, default=None, metavar="T",
                   help="tokens per KV block with --paged (default 8; must "
                   "divide tokens-per-slot)")
    v.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
