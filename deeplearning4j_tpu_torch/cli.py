"""Command line of the port: ``python -m deeplearning4j_tpu_torch train
--model transformer``, ``... generate`` and ``... serve``.

``train`` trains the byte-level char LM on ``--text`` (or an offline demo
corpus) with the reference's flags and recipe (``lm_optimizer``, a loss line
every 20 steps, ``final loss``, a sampled continuation), on one device;
``--checkpoint-dir`` saves npz checkpoints (``parallel/checkpoint.py``)
every ``--save-every`` steps with the loss and the model config in their
meta, as the reference does.

``generate --checkpoint-dir`` restores the newest checkpoint (its config
from the meta) and samples, or beam-searches with ``--beam W``, a
continuation of the byte-level ``--prompt``.

``serve`` serves a checkpoint (``--checkpoint-dir``) or a random-init
transformer (``--demo``, weights from ``--seed``) through ``ServingEngine``
+ ``ServingServer``; the model flags are the JAX CLI's (``--seq-len``,
``--d-model``, ``--n-layers``, ``--n-heads``, ``--bf16``), plus ``--preset
gpt2s`` (or ``transformer``, the JAX bench's name) for the GPT-2-small
geometry and ``--flash`` for the flash prefill kernel. ``--int8
weights|full`` serves int8 weights (over a float cache, or with the int8
KV cache too) and ``--paged [--block-size N]`` a block-paged KV pool, as
the reference's flags do. Every command runs on ``cuda`` unless ``--device
cpu`` is given.
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
    "status_port": "--status-port (the status REST / ClusterService) comes "
                   "with the cluster slice",
    "fsdp": "--fsdp comes with the torch.distributed slice",
    "n_experts": "--n-experts (MoE) comes with a later slice",
    "coordinator": "--coordinator (multi-process training) comes with the "
                   "torch.distributed slice",
}

#: why ``--checkpoint-backend orbax`` exits 2
_ORBAX = ("--checkpoint-backend orbax is JAX's sharded checkpointer; the "
          "port's sharded format (torch.distributed.checkpoint) comes with "
          "the torch.distributed slice. Use npz.")

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
    from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager

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
    mgr = None
    if args.checkpoint_dir:
        if args.checkpoint_backend == "orbax":
            print(_ORBAX, file=sys.stderr)
            return 2
        mgr = CheckpointManager(args.checkpoint_dir,
                                save_every=args.save_every)
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
        params, opt_state, step_loss = step(params, opt_state,
                                            shard_tokens(toks))
        # read the loss (a host sync) only on the print and save cadence
        on_cadence = (i + 1) % 20 == 0 or (
            mgr is not None and (i + 1) % args.save_every == 0)
        if on_cadence or i + 1 == args.steps:
            loss = float(step_loss)
            if (i + 1) % 20 == 0:
                print(f"step {i + 1}/{args.steps} loss {loss:.4f}",
                      flush=True)
        if mgr is not None:
            # the config rides in the meta, so generate and serve rebuild
            # the model without the training flags
            mgr.maybe_save(i + 1, params,
                           {"loss": loss, "config": cfg.to_json()})
    if loss is not None:
        print(f"final loss {loss:.4f}")

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


def _decode_model(args):
    """The model the decode commands run: the newest checkpoint of
    ``--checkpoint-dir`` (its config from the meta; the model flags for a
    checkpoint without one, as the reference's ``_restore_decode_model``)
    or, with ``serve --demo``, random weights from ``--seed``; then
    ``--int8 off|weights|full``. Returns ``(cfg, params)`` or an exit
    code."""
    from pathlib import Path

    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        param_shapes,
        quantize_decode_params,
    )
    from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager

    if getattr(args, "demo", False):
        cfg = _cfg_from_args(args)

        def load(c):
            return init_params(c, seed=args.seed, device=args.device)
    else:
        if args.checkpoint_backend == "orbax":
            print(_ORBAX, file=sys.stderr)
            return 2
        # a read-only command creates no directory for a mistyped path (the
        # manager makes its directory)
        missing = f"no checkpoint found in {args.checkpoint_dir}"
        if not Path(args.checkpoint_dir).is_dir():
            print(missing, file=sys.stderr)
            return 1
        mgr = CheckpointManager(args.checkpoint_dir)
        meta = mgr.read_meta()
        if meta is None:
            print(missing, file=sys.stderr)
            return 1
        if "config" in meta:
            cfg = TransformerConfig.from_json(meta["config"])
        else:
            # a checkpoint without its config: the model flags must match
            # the training run's (restore raises on a shape that differs)
            cfg = _cfg_from_args(args)

        def load(c):
            params, meta = mgr.restore_latest(param_shapes(c),
                                              device=args.device)
            print(f"restored step {meta.get('step')} from "
                  f"{args.checkpoint_dir}")
            return params
    if args.int8 != "off" and cfg.n_experts:
        print("--int8 does not cover MoE experts", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(cfg, decode_int8=(args.int8 == "full"))
    params = load(cfg)
    if args.int8 != "off":
        params = quantize_decode_params(params, cfg)
        print(f"int8 serving mode: {args.int8} ("
              f"{'weights + kv cache' if args.int8 == 'full' else 'weights over a bf16/f32 cache'})")
    return cfg, params


def cmd_generate(args) -> int:
    """Sample (or beam-search) a continuation of ``--prompt`` from the
    newest checkpoint, byte-level as ``train``, printing the reference's
    lines."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_beam_search,
        transformer_generate,
    )

    model = _decode_model(args)
    if isinstance(model, int):
        return model
    cfg, params = model
    prompt_bytes = args.prompt.encode("latin-1", errors="replace")
    room = cfg.max_len - len(prompt_bytes)
    if room <= 0:
        print(f"--prompt is {len(prompt_bytes)} bytes; max_len "
              f"({cfg.max_len}) leaves no room to decode", file=sys.stderr)
        return 2
    max_new = min(args.max_new, room)
    dev = params["embed"].device
    prompt = torch.tensor(list(prompt_bytes), dtype=torch.long,
                          device=dev)[None]

    def text(toks) -> str:
        return bytes((toks % 256).cpu().numpy().astype(np.uint8)).decode(
            "latin-1")

    if args.beam:
        toks, scores = transformer_beam_search(cfg)(
            params, prompt, beam_width=args.beam, max_new=max_new)
        for w in range(args.beam):
            print(f"beam {w} (logp {float(scores[0, w]):.2f}):",
                  text(toks[0, w]))
    else:
        out = transformer_generate(cfg)(
            params, prompt, max_new, temperature=args.temperature,
            top_k=args.top_k if args.top_k > 0 else None,
            generator=torch.Generator(device=dev).manual_seed(args.seed))
        print("sample:", text(out[0]))
    return 0


def cmd_serve(args) -> int:
    from deeplearning4j_tpu_torch.serving import (
        RequestScheduler,
        ServingEngine,
        ServingServer,
    )

    if not (args.demo or args.checkpoint_dir):
        print("serve needs --checkpoint-dir (or --demo)", file=sys.stderr)
        return 2
    model = _decode_model(args)
    if isinstance(model, int):
        return model
    cfg, params = model
    origin = ("demo mode: random-init model" if args.demo
              else f"checkpoint {args.checkpoint_dir}")
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
    print(f"{origin} ({cfg.d_model}d, {cfg.n_layers}L, "
          f"vocab {cfg.vocab_size}, {cfg.compute_dtype}) on {engine.device}")
    print(f"serving on http://{host}:{port}  ({args.slots} slots, "
          f"{engine.max_total} tokens/slot, decode horizon "
          f"{engine.decode_horizon}, queue depth {args.max_queue})",
          flush=True)
    server.serve_forever(drain_s=args.drain_s)
    return 0


def _add_checkpoint_flags(ap, required: bool) -> None:
    ap.add_argument("--checkpoint-dir", required=required, default=None,
                    help="restore the newest checkpoint of this directory")
    ap.add_argument("--checkpoint-backend", default="npz",
                    choices=["npz", "orbax"],
                    help="orbax (JAX's sharded format) exits 2")


def _add_int8_flag(ap) -> None:
    ap.add_argument("--int8", default="off",
                    choices=["off", "weights", "full"],
                    help="int8 weights over a float cache, or the fully "
                    "quantized path (int8 KV cache and decode kernel too)")


def _add_model_flags(ap) -> None:
    """The decode commands' model flags. With a checkpoint they are read
    only when its meta holds no config, and must then match training's."""
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="model geometry preset (overrides the flags "
                    "below; with a checkpoint, only when it holds no "
                    "config)")
    ap.add_argument("--flash", action="store_true",
                    help="bulk prefill through the flash attention kernel")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-experts", type=int, default=0,
                    help="MoE experts (a later slice: > 0 raises)")
    ap.add_argument("--bf16", action="store_true")


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
    t.add_argument("--checkpoint-dir", default=None,
                   help="save npz checkpoints here (ckpt_<step>.npz, the "
                   "newest 3 kept)")
    t.add_argument("--checkpoint-backend", default="npz",
                   choices=["npz", "orbax"],
                   help="orbax (JAX's sharded format) exits 2")
    t.add_argument("--save-every", type=int, default=50)
    t.add_argument("--status-port", type=int, default=None,
                   help="(a later slice)")
    t.add_argument("--coordinator", default=None, help="(a later slice)")
    t.set_defaults(fn=cmd_train)

    g = sub.add_parser("generate",
                       help="sample from a trained checkpoint (byte-level; "
                       "--beam W for beam search, --int8 for int8 decode)")
    _add_checkpoint_flags(g, required=True)
    g.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")
    g.add_argument("--prompt", default="the quick brown ")
    g.add_argument("--max-new", type=int, default=48)
    g.add_argument("--temperature", type=float, default=0.8)
    g.add_argument("--top-k", type=int, default=40,
                   help="0 disables top-k filtering")
    g.add_argument("--beam", type=int, default=0,
                   help="beam width; 0 = sampled decode")
    g.add_argument("--seed", type=int, default=0)
    _add_int8_flag(g)
    _add_model_flags(g)
    g.set_defaults(fn=cmd_generate)

    v = sub.add_parser("serve", help="continuous-batching HTTP serving")
    v.add_argument("--demo", action="store_true",
                   help="serve a random-init model (weights from --seed)")
    _add_checkpoint_flags(v, required=False)
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
    _add_model_flags(v)
    _add_int8_flag(v)
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
