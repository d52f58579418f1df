"""Command line of the port: ``python -m deeplearning4j_tpu_torch train
--model transformer``, ``... generate`` and ``... serve``.

``train --model lenet`` (the default) and ``--model alexnet`` train the
DL4J-era conv nets (LeNet on MNIST or its synthetic stand-in, AlexNet on
the reference's synthetic CIFAR) with ``DataParallelTrainer`` over every
card's data axis, or across processes with ``--coordinator``.

``train`` trains the byte-level char LM on ``--text`` (or an offline demo
corpus) with the reference's flags and recipe (``lm_optimizer``, a loss line
every 20 steps, ``final loss``, a sampled continuation), on one device or,
with ``--tp N`` (``--n-experts N`` experts, one a model rank; ``--fsdp``),
on a ``(data, model)`` mesh of ``dp = cards // N`` rows, as the reference
does (``--device D`` puts the N ranks on D, ``dp = 1``);
``--checkpoint-dir`` saves npz checkpoints (``parallel/checkpoint.py``)
every ``--save-every`` steps with the loss and the model config in their
meta, as the reference does, or with ``--checkpoint-backend orbax`` (the
reference's flag value) sharded ``torch.distributed.checkpoint``
directories, written off the training thread. ``--coordinator HOST:PORT
--num-processes N --process-id I`` trains across N processes
(``torch.distributed``; npz is refused there, as the reference refuses
it) on the reference's mesh over the global device list
(:func:`train_mesh_layout`): a ``--tp`` within a process's cards puts
the data axis across the processes, a larger one the model axis (two
one-card processes with ``--tp 2``: one model row over both);
``--device D`` keeps every rank of a process on D. ``--status-port P``
serves the trainer's ``/statetracker`` status and control (a POSTed
minibatch or early stop takes effect at the next step), and ``status
--port P`` prints it. The closing sample is drawn straight from the
training layout (gathered whole first where the layout spans the
processes).

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
KV cache too) and ``--paged [--block-size N]`` a block-paged KV pool,
``--prefix-cache [--prefix-cache-tokens N] [--prefix-affinity-tokens K]``
the prefix cache, ``--piggyback [--prefill-budget N]`` the deferred
prefill, ``--chaos-rate P [--chaos-seed S]`` seeded transient faults
(retried, or recovered by replay), and ``--sampling-surface
[--grammar-states N] [--grammar-cache DIR]`` the per-request sampling and
grammar surface, ``--tenants PATH`` the tenant registry (a JSON file) and
``--lora-adapters N [--lora-rank R] [--lora-seed S]`` a batched-LoRA bank
of random demo adapters, and ``--migrate-target HOST:PORT`` (repeatable) the
peers a drain migrates live sessions to, as the reference's flags do. ``--adaptive-horizon``
drops the decode horizon to 1 while requests wait, ``--probe-cache PATH``
persists probe verdicts (``off`` disables), ``--embed-models word2vec``
serves ``POST /v1/embeddings`` over the reference's demo vocabulary, and
``--tp N [--tp-parity auto|trust|off]`` serves tensor-parallel over the
first N cards (exits 2 with fewer; with ``--device``, N ranks on that
device), ``--max-restarts N`` and ``--hang-threshold S`` set the
supervision (crash recoveries before the engine is declared dead, the
heartbeat age ``/healthz`` calls hung), ``--run-seconds N`` serves for N
seconds then drains (``--drain-s``) and exits 0, and the observability
flags are the reference's: ``--trace-out PATH`` [``--trace-capacity N``]
(a Chrome trace written at shutdown), ``--flight-dir DIR`` (postmortem
bundles), ``--log-json`` (JSON log lines), ``--metrics-port P`` (the
scrape sidecar), ``--profile-dir DIR`` and ``--profile-steps N`` (``torch.profiler`` captures, also armed by
``POST /profile?s=N``). ``trace-merge A.json B.json -o OUT`` stitches
``--trace-out`` exports into one Perfetto document. ``router --replica
HOST:PORT ...`` runs the prefix-affinity replica router and ``controller
--replica HOST:PORT=ROLE ...`` the disaggregated fleet controller (the
reference's flags; ``--port-file PATH`` writes the bound address); neither
loads a model or imports ``torch``. ``serve``, ``router`` and ``controller``
take ``--sanitize`` (the runtime sanitizers, reported at shutdown, exit 1 on
a violation); ``lint`` and ``audit`` run graftlint and graftaudit
(``analysis/``) against the port's baselines, and ``provision NAME`` prints
(or with ``--execute`` runs) the gcloud commands of a GPU-VM cluster.
Sampling takes the
reference's threefry key stream: ``generate --seed S`` is ``key(S)``,
``serve --seed S`` the engine's master key. Every command runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

#: GPT-2-small serving geometry (the JAX bench's "transformer" preset:
#: 6 heads of 128, bf16, 50304-token vocabulary) with GPT-2's 1024 positions
PRESETS = {
    "gpt2s": dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=6,
                  d_ff=3072, max_len=1024, bf16=True),
}


def _cfg_from_args(args):
    """ONE flags -> config recipe for train and serve, as the reference's
    ``_transformer_cfg_from_args``."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    remat = getattr(args, "remat", False)
    if args.preset:
        p = dict(PRESETS[args.preset])
        bf16 = p.pop("bf16") or args.bf16
        return TransformerConfig(
            **p, use_flash=args.flash, remat=remat,
            n_experts=args.n_experts,
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


#: the reference's offline demo corpus (deeplearning4j_tpu/cli.py)
_DEMO_TEXT = (
    b"the quick brown fox jumps over the lazy dog. "
    b"pack my box with five dozen liquor jugs. "
) * 300


def _start_status_rest(svc, args) -> None:
    """The status and control REST server when ``--status-port`` is
    given, with a reachable URL printed (a 0.0.0.0 bind shows as
    loopback), as the reference's ``_start_status_rest``."""
    if args.status_port is None:
        return
    port = svc.start_rest_api(args.status_port, host=args.status_host,
                              auth_token=args.status_token)
    shown = "127.0.0.1" if args.status_host == "0.0.0.0" else (
        args.status_host)
    print(f"status REST on http://{shown}:{port}/statetracker", flush=True)
    if svc.auth_token is not None:
        if args.status_token is not None:
            # the operator knows the secret: it is not repeated onto stdout
            print("control POSTs require X-Auth-Token (as passed via "
                  "--status-token)")
        else:
            print(f"control POSTs require X-Auth-Token: "
                  f"{svc.auth_token[:8]}… (full secret in "
                  f"{svc.auth_token_file}, mode 0600)")


def _train_checks(args) -> str | None:
    """The flag checks ``train`` makes before it loads anything, as the
    reference's; the message of the first that fails, or None."""
    if args.status_port is not None and not 0 <= args.status_port <= 65535:
        return f"--status-port ({args.status_port}) must be in [0, 65535]"
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        return "--coordinator needs --num-processes and --process-id"
    if args.model in DL4J_MODELS:
        return None
    tp = max(1, args.tp)
    if args.d_model % args.n_heads:
        return (f"--d-model ({args.d_model}) must be divisible by --n-heads "
                f"({args.n_heads})")
    if args.n_heads % tp:
        return f"--n-heads ({args.n_heads}) must be divisible by --tp ({tp})"
    if args.n_experts and args.n_experts != tp:
        return (f"--n-experts ({args.n_experts}) must equal --tp ({tp}): "
                "experts live one-per-device on the model axis")
    if (args.checkpoint_dir and args.checkpoint_backend == "npz"
            and args.coordinator and args.num_processes > 1):
        # the reference's refusal (its npz backend cannot address a
        # multi-process sharding), made before the processes meet
        return ("npz checkpoints cannot address multi-process shardings; "
                "use --checkpoint-backend orbax for distributed runs")
    return None


def train_mesh_layout(nproc: int, cards: int, tp: int, device=None):
    """``train``'s transformer mesh as ``(ici, dcn, devices)`` for
    ``mesh_lib.hybrid_mesh`` (``dcn`` None in one process), the
    reference's rule (its cli.py:136-138): ``dp = devices // tp`` over the
    global device list, process-major, rank ``(d, m)`` on device ``d * tp
    + m``. ``cards`` is each process's count. ``--device D`` puts every
    rank of a process on D: ``(1, tp)`` a process, the data axis across
    the processes. Without it, ``tp`` within a process's cards keeps the
    model axis inside it (data across the processes); a ``tp`` that spans
    ``tp // cards`` processes puts the model axis across them (two
    one-card processes with ``--tp 2``: one model row over both).
    ``ValueError`` for a ``tp`` the cards cannot lay out so."""
    data, model = "data", "model"
    if device:
        return ({data: 1, model: tp}, {data: nproc} if nproc > 1 else None,
                [device] * tp)
    if nproc == 1 or cards == 0:
        return ({data: max(1, cards // tp), model: tp},
                {data: nproc} if nproc > 1 else None, None)
    if cards % tp == 0:
        return {data: cards // tp, model: tp}, {data: nproc}, None
    if tp % cards == 0 and nproc % (tp // cards) == 0:
        return ({data: 1, model: cards},
                {data: nproc // (tp // cards), model: tp // cards}, None)
    raise ValueError(f"--tp {tp} does not lay out over {nproc} processes of "
                     f"{cards} cards each: it must divide a process's cards "
                     f"or be a multiple of them that divides the "
                     f"{nproc * cards} cards")


#: the DL4J-era nets ``train`` fits with ``DataParallelTrainer``
DL4J_MODELS = ("lenet", "alexnet")


def _dl4j_model(name: str, n: int, device):
    """(net, params, dataset, description) of ``train --model name``: the
    reference's seed-0 init and data."""
    if name == "lenet":
        from deeplearning4j_tpu_torch.datasets import fetchers
        from deeplearning4j_tpu_torch.models.lenet import build_lenet

        net, params = build_lenet(device=device)
        return (net, params, fetchers.mnist(n=n),
                "lenet (conv 6, conv 16, dense 120, dense 84, softmax 10)")
    from deeplearning4j_tpu_torch.models.alexnet import (
        build_alexnet,
        synthetic_cifar,
    )

    net, params = build_alexnet(device=device)
    return (net, params, synthetic_cifar(n),
            "alexnet (conv 64, conv 128, conv 256, dense 512, dense 256, "
            "softmax 10)")


def _train_dl4j(args) -> int:
    """``train --model lenet|alexnet``, as the reference's ``cmd_train``:
    the net from seed 0 on ``fetchers.mnist(n=--examples)`` (the synthetic
    stand-in when no idx files are present) or ``synthetic_cifar
    (--examples)``, ``DataParallelTrainer`` over the data axis (every card,
    or ``--device``) with ``lenet_loss``, ``--epochs`` passes of
    ``--batch``-row steps (the last partial batch dropped), step ``i``'s
    key ``rng.key_for(i)``, ``epoch e step i loss`` every 10 steps and
    ``final loss``; npz checkpoints on ``--checkpoint-dir`` every
    ``--save-every`` steps in the reference's keys and layout;
    ``--status-port`` serves the ClusterService status. With
    ``--coordinator`` the data axis spans ``--num-processes`` processes
    (``hybrid_mesh``): every process reads the same data and keeps its rows
    of each global batch (``shard_global_batch``), and the gradients and
    the loss are averaged over the processes in one bucket a step. Closes
    with the unrounded final loss, the ms a step over steps 2..N (the loss
    read back at each step's end) and the samples a second, and across
    processes the bucket and its all-reduce time."""
    from deeplearning4j_tpu_torch import rng
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.models.lenet import lenet_loss
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.parallel.cluster import (
        ClusterService,
        initialize_distributed,
    )
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        DataParallelTrainer,
    )

    dev = resolve_device(args.device)
    nproc = args.num_processes if args.coordinator else 1
    if args.coordinator:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
    net, params, ds, description = _dl4j_model(args.model, args.examples, dev)
    svc = ClusterService()
    svc.model_description = description
    _start_status_rest(svc, args)
    devices = [dev] if args.device else None
    if nproc > 1:
        import torch

        dp = 1 if args.device else max(1, torch.cuda.device_count())
        mesh = mesh_lib.hybrid_mesh({mesh_lib.DATA_AXIS: dp},
                                    {mesh_lib.DATA_AXIS: nproc}, devices)
        print(f"training on a data axis of {mesh.global_data_size} across "
              f"{nproc} processes (process {args.process_id}: data rows "
              f"{args.process_id * dp}-{(args.process_id + 1) * dp - 1})",
              flush=True)
    else:
        mesh = mesh_lib.data_parallel_mesh(devices=devices)
    trainer = DataParallelTrainer(lenet_loss(net), mesh=mesh)
    state = trainer.init(params)
    # across processes the params are the same everywhere: process 0 saves
    mgr = (CheckpointManager(args.checkpoint_dir, save_every=args.save_every)
           if args.checkpoint_dir and (nproc == 1 or args.process_id == 0)
           else None)

    svc.phase = "train"
    b = min(args.batch, ds.num_examples())
    step_idx, loss, step_s, reduce_s = 0, None, [], []
    for epoch in range(args.epochs):
        for batch in ds.batches(b, drop_last=True):
            t0 = time.perf_counter()
            x, y = trainer.shard_global_batch(batch.features, batch.labels)
            state, loss = trainer.step(state, x, y, rng.key_for(step_idx))
            step_idx += 1
            svc.batches_so_far = step_idx
            # the reference reads every step's loss (its early-stop rule)
            loss = float(loss)
            step_s.append(time.perf_counter() - t0)
            reduce_s.append(trainer.stats["allreduce_s"])
            if step_idx % 10 == 0:
                print(f"epoch {epoch} step {step_idx} loss {loss:.4f}",
                      flush=True)
            stop = svc.report_loss(loss)
            if nproc > 1:
                stop = bool(mesh_lib.broadcast_ints([stop], mesh)[0])
            if stop:
                # ends the epoch, as the reference's loop does
                print("early stop triggered", flush=True)
                break
            if mgr is not None:
                mgr.maybe_save(step_idx, net.checkpoint_tree(state.params),
                               {"loss": loss})
    svc.phase = "done"
    svc.stop_rest_api()
    if loss is None:
        print("no full batch to train on", file=sys.stderr)
        return 2
    print(f"final loss {loss:.4f}", flush=True)
    print(f"final loss unrounded {loss!r}", flush=True)
    first = 2 if len(step_s) > 1 else 1
    n = len(step_s) - first + 1
    ms = 1e3 * sum(step_s[first - 1:]) / n
    print(f"{ms:.3f} ms a step over steps {first}-{len(step_s)} (batch {b}, "
          f"{trainer.dp} data rank(s) on {trainer.device}, host clock, the "
          f"loss read back each step), {1e3 * b / ms:.0f} samples/s",
          flush=True)
    if nproc > 1:
        import torch.distributed as dist

        print(f"data axis across {nproc} processes ({dist.get_backend()}): "
              f"one bucket of {trainer.stats['bucket_bytes']} bytes "
              f"all-reduced a step, {trainer.stats['host_bytes']} bytes "
              f"through the host; "
              f"{1e3 * sum(reduce_s[first - 1:]) / n:.2f} ms a step in "
              f"all_reduce_mean", flush=True)
    if args.coordinator:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def cmd_train(args) -> int:
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.device import synchronize
    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer,
        transformer_generate,
        transformer_train_step,
    )
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        AsyncShardedCheckpointManager,
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.parallel.cluster import (
        ClusterService,
        initialize_distributed,
    )

    msg = _train_checks(args)
    if msg is not None:
        print(msg, file=sys.stderr)
        return 2
    if args.model in DL4J_MODELS:
        return _train_dl4j(args)
    tp = max(1, args.tp)
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
    nproc = args.num_processes if args.coordinator else 1
    if args.coordinator:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
    mgr = None
    if args.checkpoint_dir:
        mgr = (AsyncShardedCheckpointManager
               if args.checkpoint_backend == "orbax" else CheckpointManager)(
            args.checkpoint_dir, save_every=args.save_every)
    # a mesh whenever a mesh feature is asked for: the reference's rule
    # over the global device list (train_mesh_layout)
    mesh = None
    if tp > 1 or args.fsdp or cfg.n_experts or nproc > 1:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        try:
            ici, dcn, devices = train_mesh_layout(nproc, have, tp,
                                                  args.device)
            mesh = (mesh_lib.hybrid_mesh(ici, dcn, devices) if nproc > 1
                    else mesh_lib.dp_mp_mesh(ici[mesh_lib.DATA_AXIS], tp,
                                             devices))
        except ValueError as e:
            print(f"--tp {tp}: {e}", file=sys.stderr)
            return 2
    step, init_state, shard_tokens = transformer_train_step(
        mesh, cfg, optimizer=lm_optimizer(total_steps=args.steps),
        fsdp=args.fsdp, device=args.device,
    )
    params, opt_state = init_state(0)
    gdp = mesh.global_data_size if mesh is not None else 1
    if mesh is not None:
        span = [f"{name} {mesh.offset(axis)}-"
                f"{mesh.offset(axis) + mesh.axis_size(axis) - 1}"
                for name, axis in (("data rows", mesh_lib.DATA_AXIS),
                                   ("model ranks", mesh_lib.MODEL_AXIS))
                if mesh.spans(axis)]
        across = (f" across {nproc} processes (process {args.process_id}: "
                  f"{', '.join(span)})" if nproc > 1 else "")
        print(f"training on a (data, model) = ({gdp}, {tp}) mesh"
              f"{' with fsdp' if args.fsdp else ''}"
              f"{f', {cfg.n_experts} experts' if cfg.n_experts else ''}"
              f"{across}", flush=True)
    svc = ClusterService()
    svc.model_description = (
        f"transformer d_model={cfg.d_model} n_layers={cfg.n_layers} "
        f"n_heads={cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"seq_len={args.seq_len} experts={cfg.n_experts} fsdp={args.fsdp}")
    _start_status_rest(svc, args)
    svc.phase = "train"
    batch = max(gdp, args.batch - args.batch % gdp)
    svc.minibatch = batch
    rng = np.random.default_rng(0)
    loss = step_loss = None
    fa.reset_launches()
    # across processes: each step's host clock (the device synced at its
    # end, the save after it left out), its all-reduce's and its other
    # collectives' (calls, bytes through the host, seconds)
    step_s, reduce_s, coll = [], [], []
    for i in range(args.steps):
        t_step = time.perf_counter()
        # live batch-size control: POST /statetracker/minibatch changes the
        # sampled batch, rounded to the data axis (process 0's value in
        # every process: the processes' batches must agree)
        posted = max(gdp, svc.minibatch - svc.minibatch % gdp)
        if mesh is not None:
            posted = mesh_lib.broadcast_ints([posted], mesh)[0]
        if posted != batch:
            batch = posted
            print(f"minibatch -> {batch} (REST)", flush=True)
        starts = rng.integers(0, len(arr) - args.seq_len - 1, batch)
        toks = np.stack([arr[s:s + args.seq_len + 1] for s in starts])
        params, opt_state, step_loss = step(params, opt_state,
                                            shard_tokens(toks))
        if nproc > 1:
            synchronize(mesh.devices[0])
            step_s.append(time.perf_counter() - t_step)
            reduce_s.append(step.stats["allreduce_s"])
            coll.append(step.stats["collectives"])
        svc.batches_so_far = i + 1
        # read the loss (a host sync) only on the print and save cadence
        on_cadence = (i + 1) % 20 == 0 or (
            mgr is not None and (i + 1) % args.save_every == 0)
        if on_cadence or i + 1 == args.steps:
            loss = float(step_loss)
            if (i + 1) % 20 == 0:
                print(f"step {i + 1}/{args.steps} loss {loss:.4f}",
                      flush=True)
            # True on patience exhausted and on a POSTed earlystop
            # (process 0's verdict in every process)
            stop = svc.report_loss(loss)
            if mesh is not None:
                stop = bool(mesh_lib.broadcast_ints([stop], mesh)[0])
            if stop:
                print("early stop triggered", flush=True)
                break
        if mgr is not None:
            # the config rides in the meta, so generate and serve rebuild
            # the model without the training flags
            mgr.maybe_save(i + 1, params,
                           {"loss": loss, "config": cfg.to_json()})
    if mgr is not None and hasattr(mgr, "wait"):
        mgr.wait()  # queued sharded saves are durable before the exit
    if loss is None and step_loss is not None:
        loss = float(step_loss)
    svc.phase = "done"
    if loss is not None:
        print(f"final loss {loss:.4f}", flush=True)
    if nproc > 1:
        import torch.distributed as dist

        stats = step.stats
        # steps 2..N: step 1 carries the process's first launches
        first = 2 if len(step_s) > 1 else 1
        n = len(step_s) - first + 1
        ms = 1e3 * sum(step_s[first - 1:]) / n
        ms_reduce = 1e3 * sum(reduce_s[first - 1:]) / n
        steps = f"steps {first}-{len(step_s)}"
        if mesh.spans(mesh_lib.DATA_AXIS):
            print(f"data axis across {mesh.dcn[mesh_lib.DATA_AXIS]} "
                  f"processes ({dist.get_backend()}): one bucket of "
                  f"{stats['bucket_bytes']} bytes all-reduced a step, "
                  f"{stats['host_bytes']} bytes through the host; "
                  f"{ms:.2f} ms a step over {steps} (host clock, device "
                  f"synced, saves left out), {ms_reduce:.2f} ms of it in "
                  f"all_reduce_mean; kernel launches flash_attn_fwd "
                  f"{fa.launches} flash_attn_bwd {fa.bwd_launches}",
                  flush=True)
        c = stats["collectives"]
        if c["calls"]:
            ms_coll = 1e3 * sum(x["seconds"] for x in coll[first - 1:]) / n
            where = ("model axis" if mesh.spans(mesh_lib.MODEL_AXIS)
                     else "ZeRO-3 shards")
            print(f"{where} across {nproc} processes "
                  f"({dist.get_backend()}): {c['calls']} collectives a "
                  f"step, {c['bytes']} bytes received, {c['host_bytes']} "
                  f"bytes through the host; {ms:.2f} ms a step over "
                  f"{steps} (host clock, device synced, saves left out), "
                  f"{ms_coll:.2f} ms of it in the cross-process "
                  f"collectives; kernel launches flash_attn_fwd "
                  f"{fa.launches} flash_attn_bwd {fa.bwd_launches}",
                  flush=True)

    if cfg.max_len >= 32:
        # sampled straight from the training layout (no gather)
        gen = transformer_generate(cfg)
        dev = mesh.devices[0] if mesh is not None else params["embed"].device
        out = gen(params, torch.from_numpy(arr[None, :16]).to(dev),
                  min(cfg.max_len - 16, 48), temperature=0.8, top_k=40,
                  key=1)
        text = bytes((out[0] % 256).cpu().numpy().astype(np.uint8))
        print("sample:", text.decode("latin-1"))
    if mgr is not None and hasattr(mgr, "close"):
        mgr.close()
    svc.stop_rest_api()
    if args.coordinator:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def cmd_status(args) -> int:
    """A running trainer's ``GET /statetracker`` (``train --status-port``),
    printed as indented JSON, as the reference's ``status``."""
    import urllib.request

    with urllib.request.urlopen(
            f"http://{args.host}:{args.port}/statetracker", timeout=30) as r:
        print(json.dumps(json.loads(r.read()), indent=2))
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
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        AsyncShardedCheckpointManager,
        CheckpointManager,
    )

    if getattr(args, "demo", False):
        cfg = _cfg_from_args(args)

        def load(c):
            return init_params(c, seed=args.seed, device=args.device)
    else:
        # a read-only command creates no directory for a mistyped path (the
        # managers make their directory)
        missing = f"no checkpoint found in {args.checkpoint_dir}"
        if not Path(args.checkpoint_dir).is_dir():
            print(missing, file=sys.stderr)
            return 1
        mgr = (AsyncShardedCheckpointManager
               if args.checkpoint_backend == "orbax" else CheckpointManager)(
            args.checkpoint_dir)
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
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_beam_search,
        transformer_generate,
    )
    from deeplearning4j_tpu_torch.ops import threefry

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
            key=threefry.key(args.seed))
        print("sample:", text(out[0]))
    return 0


#: the reference's tiny corpus for the ``--embed-models`` demo vocabulary
_DEMO_SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "a day in the life of a serving engine",
    "music in the park makes the day go by",
    "the fox and the dog share the park",
    "continuous batching keeps the engine busy all day",
]


class HostTable:
    """An embedding model's vectors as a host table: the engine serves
    lookups at the admission boundary, so they never touch the device."""

    def __init__(self, model):
        self.cache = model.cache
        self.table = model.syn0.cpu().numpy()

    def get_word_vector(self, word: str):
        i = self.cache.index_of(word)
        return None if i < 0 else self.table[i]


def _demo_embedders(names: list[str], device=None) -> dict:
    """The reference's ``/v1/embeddings`` demo (its ``_demo_embedders``)
    over :data:`_DEMO_SENTENCES`, on ``device``, each served from a host
    copy: ``word2vec`` is ``Word2Vec(layer_size=16, seed=0)``, its
    vocabulary built and its table drawn (the reference's bits), no
    training; ``glove`` is ``Glove(layer_size=16, epochs=1, seed=0)``
    fitted on the corpus. Raises ``ValueError`` on another name."""
    from deeplearning4j_tpu_torch.models.glove import Glove
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec

    out = {}
    for name in names:
        name = name.strip().lower()
        if not name:
            continue
        if name == "word2vec":
            m = Word2Vec(layer_size=16, seed=0, device=device)
            m.build_vocab(_DEMO_SENTENCES)
            m.reset_weights()
        elif name == "glove":
            m = Glove(layer_size=16, epochs=1, seed=0, device=device)
            m.fit(_DEMO_SENTENCES)
        else:
            raise ValueError(
                f"unknown embed model {name!r} (word2vec|glove)")
        out[name] = HostTable(m)
    return out


def cmd_serve(args) -> int:
    """``serve``; with ``--sanitize`` under the lock and sync sanitizers,
    installed before the engine, the server and their locks are built and
    reported (``_report_sanitizers``) when the server stops."""
    sans = (_install_sanitizers(args.device, serving=True)
            if args.sanitize else None)
    try:
        rc, engine = _serve(args, sans)
    finally:
        if sans is not None:
            sans[1].uninstall()
            sans[0].uninstall()
    if sans is not None and rc == 0:
        return _report_sanitizers(engine, *sans)
    return rc


def _install_sanitizers(device=None, serving: bool = False):
    """Install the lock and sync sanitizers (development mode) before any
    lock is built: ``wrap_lock`` instruments only the locks created while
    one is active. The sync sanitizer watches readbacks of tensors on the
    serving device type (the card unless ``device`` is the CPU);
    ``serving`` imports torch first (the router and the controller import
    none, and their sync sanitizer patches nothing)."""
    from deeplearning4j_tpu_torch.analysis.sanitizers import (
        LockSanitizer,
        SyncSanitizer,
    )

    devices = ("cpu",) if str(device or "cuda").startswith("cpu") else (
        "cuda",)
    if serving:
        import torch  # noqa: F401  (the sync sanitizer patches torch)
    sans = (LockSanitizer().install(),
            SyncSanitizer(devices=devices).install())
    print("sanitizers: lock + sync active (development mode)", flush=True)
    return sans


def _report_sanitizers(engine, lock_san, sync_san) -> int:
    """Uninstall the sanitizers, run the compile-count guard, print one
    summary line per detector (the reference's lines), and return 1 when
    any violation was recorded. ``engine`` is None for processes that run
    no engine (the router, the controller): the lock/sync detectors still
    apply, the compile-count guard does not."""
    from deeplearning4j_tpu_torch.analysis.sanitizers import (
        CompileCountGuard,
    )

    sync_san.uninstall()
    lock_san.uninstall()
    compile_viol = (
        CompileCountGuard(engine).check() if engine is not None else []
    )
    print(f"sanitizers: {lock_san.n_wrapped} locks tracked, "
          f"sync counts {dict(sorted(sync_san.counts.items()))}"
          + (f", horizons {sync_san.horizons}" if engine is not None
             else ""), flush=True)
    violations = (
        [f"[lock] {m}" for m in lock_san.violations]
        + [f"[sync] {m}" for m in sync_san.violations]
        + [f"[compile] {m}" for m in compile_viol]
    )
    for msg in violations:
        print(f"sanitizer violation: {msg}", file=sys.stderr)
    if violations:
        print(f"sanitizers: {len(violations)} violation(s)",
              file=sys.stderr, flush=True)
        return 1
    print("sanitizers: clean", flush=True)
    return 0


def _serve(args, sans) -> tuple[int, object]:
    import logging

    from deeplearning4j_tpu_torch.models.transformer import init_lora_bank
    from deeplearning4j_tpu_torch.obs import (
        ProfileTrigger,
        Tracer,
        configure_json_logging,
    )
    from deeplearning4j_tpu_torch.ops import threefry
    from deeplearning4j_tpu_torch.serving import (
        FaultInjector,
        RequestScheduler,
        ServingEngine,
        ServingServer,
        TenantRegistry,
    )

    if not (args.demo or args.checkpoint_dir):
        print("serve needs --checkpoint-dir (or --demo)", file=sys.stderr)
        return 2, None
    tp_devices = None
    if args.tp > 1:
        from deeplearning4j_tpu_torch.parallel.mesh import (
            model_parallel_mesh,
        )

        # the first N cards; --device puts every rank on that device
        try:
            tp_devices = list(model_parallel_mesh(
                args.tp, [args.device] * args.tp if args.device
                else None).devices)
        except ValueError as e:
            print(f"--tp {args.tp}: {e}", file=sys.stderr)
            return 2, None
    embedders = None
    if args.embed_models:
        try:
            embedders = _demo_embedders(args.embed_models.split(","),
                                        device=args.device)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2, None
        print(f"embeddings: POST /v1/embeddings over "
              f"{', '.join(sorted(embedders))} (demo vocab)")
    if args.log_json:
        configure_json_logging(level=logging.INFO)
    tenancy = None
    if args.tenants:
        tenancy = TenantRegistry.from_file(args.tenants)
        print(f"tenancy: {len(tenancy)} tenants from {args.tenants} "
              f"({', '.join(tenancy.tenant_ids())})")
    model = _decode_model(args)
    if isinstance(model, int):
        return model, None
    cfg, params = model
    lora_bank = None
    if args.lora_adapters > 0:
        lora_bank = init_lora_bank(threefry.key(args.lora_seed), cfg,
                                   n_adapters=args.lora_adapters,
                                   rank=args.lora_rank, device=args.device)
        print(f"batched LoRA: {args.lora_adapters} adapters "
              f"(rank {args.lora_rank}, index 0 = base model); "
              f"requests pick one via 'adapter' or the tenant default")
    origin = ("demo mode: random-init model" if args.demo
              else f"checkpoint {args.checkpoint_dir}")
    faults = None
    if args.chaos_rate > 0:
        faults = FaultInjector(seed=args.chaos_seed,
                               transient_rate=args.chaos_rate)
        print(f"chaos mode: transient faults at rate {args.chaos_rate} "
              f"(seed {args.chaos_seed})")
    tracer = Tracer(enabled=args.trace_out is not None,
                    capacity=args.trace_capacity)
    profile = ProfileTrigger(log_dir=args.profile_dir)
    if args.profile_steps > 0:
        d = profile.arm(args.profile_steps)
        print(f"profiling first {args.profile_steps} steps -> {d}")
    probe_cache = None
    if args.probe_cache and args.probe_cache.lower() not in ("off", "none"):
        probe_cache = os.path.expanduser(args.probe_cache)
    engine = ServingEngine(
        cfg, params, n_slots=args.slots, max_total=args.max_total,
        temperature=args.temperature,
        top_k=args.top_k if args.top_k > 0 else None,
        decode_horizon=args.decode_horizon,
        adaptive_horizon=args.adaptive_horizon,
        tracer=tracer, profile=profile, probe_cache=probe_cache,
        embedders=embedders,
        prefix_cache=args.prefix_cache,
        prefix_cache_tokens=args.prefix_cache_tokens,
        scheduler=RequestScheduler(
            max_queue_depth=args.max_queue,
            prefix_affinity_tokens=args.prefix_affinity_tokens,
            tenancy=tenancy),
        rng_seed=args.seed, faults=faults, device=args.device,
        paged=args.paged, block_size=args.block_size,
        piggyback=args.piggyback, prefill_budget=args.prefill_budget,
        sampling_surface=args.sampling_surface,
        grammar_states=args.grammar_states,
        grammar_cache=args.grammar_cache,
        lora_bank=lora_bank, tenancy=tenancy, tp=args.tp,
        tp_parity={"auto": "auto", "trust": True, "off": False}[
            args.tp_parity],
        tp_devices=tp_devices,
    )
    if sans is not None:
        engine.attach_sanitizer(sans[1])
    if args.tp > 1:
        if engine.tp == args.tp:
            print(f"tensor parallel: serving sharded over {engine.tp} "
                  f"devices (model axis: "
                  f"{', '.join(str(d) for d in engine.tp_mesh.devices)})")
        else:
            print("tensor parallel DISABLED (parity probe failed or "
                  "geometry unsupported); serving on 1 device",
                  file=sys.stderr)
    if lora_bank is not None and engine.n_adapters == 0:
        print("batched LoRA DISABLED (adapter-0 parity probe failed); "
              "serving the base model", file=sys.stderr)
    if args.paged:
        if engine._paged:
            print(f"paged KV: {engine.pool.n_blocks} blocks x "
                  f"{engine.pool.block_size} tokens (shared pool, "
                  f"refcounted block tables)")
        else:
            print("paged KV DISABLED (parity probe failed or block size "
                  "does not divide tokens/slot); slab slots",
                  file=sys.stderr)
    if args.piggyback:
        print(f"piggyback prefill: chunked admission behind decode "
              f"dispatches ({engine.prefill_budget} tokens/horizon budget)")
    if args.sampling_surface:
        if engine._surface:
            print(f"sampling surface: grammar-constrained decoding + "
                  f"per-request temperature/top_k/top_p/stop/logit_bias/"
                  f"logprobs ({engine._gtable.capacity} DFA table rows)")
        else:
            print("sampling surface DISABLED (masked parity probe failed "
                  "or approx-top-k engine); per-request sampling fields "
                  "will 400", file=sys.stderr)
    server = ServingServer(engine, host=args.host, port=args.port,
                           request_timeout_s=args.request_timeout,
                           max_restarts=args.max_restarts,
                           hang_threshold_s=args.hang_threshold,
                           metrics_port=args.metrics_port,
                           flight_dir=args.flight_dir,
                           migrate_targets=tuple(args.migrate_target or ()))
    host, port = server.address
    # the process track named after the bound address, so trace-merge
    # tells the servers apart
    tracer.process_name = f"serve {host}:{port}"
    print(f"{origin} ({cfg.d_model}d, {cfg.n_layers}L, "
          f"vocab {cfg.vocab_size}, {cfg.compute_dtype}) on {engine.device}")
    if engine.prefix_cache is not None:
        pc = engine.prefix_cache
        print(f"prefix cache: {pc.capacity_tokens} tokens "
              f"({pc.n_region_slots} segments, "
              f"{pc.nbytes() / 1e6:.1f} MB region)")
    if server.metrics_address is not None:
        mh, mp = server.metrics_address
        print(f"metrics sidecar on http://{mh}:{mp}/metrics")
    print(f"serving on http://{host}:{port}  ({args.slots} slots, "
          f"{engine.max_total} tokens/slot, decode horizon "
          f"{engine.decode_horizon}"
          f"{' (adaptive)' if args.adaptive_horizon else ''}, "
          f"queue depth {args.max_queue})", flush=True)
    try:
        if args.run_seconds is not None:
            # a timed run: start, publish the bound address, serve for N
            # seconds, then drain
            server.start()
            if args.port_file:
                _write_port_file(args.port_file, host, port)
            time.sleep(args.run_seconds)
            server.stop(drain_s=args.drain_s)
        else:
            kw = {}
            if args.port_file:
                kw["on_start"] = lambda: _write_port_file(args.port_file,
                                                          host, port)
            server.serve_forever(drain_s=args.drain_s, **kw)
    finally:
        if args.trace_out:
            out = tracer.export(args.trace_out)
            print(f"trace: {tracer.n_events} events "
                  f"({tracer.dropped} dropped) -> {out}", flush=True)
    return 0, engine


def _write_port_file(path: str, host: str, port: int) -> None:
    """The bound address as JSON, written atomically (a harness polling
    for the file never reads half of it)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"host": host, "port": port}, f)
    os.replace(tmp, path)


def _announce_and_serve(svc, args, kind: str, tracer) -> int:
    """Run a router or controller until Ctrl-C or SIGTERM: with
    ``--port-file`` it writes its bound address there as JSON (atomically)
    once listening; the trace goes to ``--trace-out`` at shutdown."""
    host, port = svc.address
    tracer.process_name = f"{kind} {host}:{port}"
    try:
        if args.port_file:
            svc.start()
            _write_port_file(args.port_file, host, port)
            try:
                while True:
                    time.sleep(1)
            except KeyboardInterrupt:
                pass
            finally:
                svc.stop()
        else:
            svc.serve_forever()
    finally:
        if args.trace_out:
            out = tracer.export(args.trace_out)
            print(f"trace: {tracer.n_events} events "
                  f"({tracer.dropped} dropped) -> {out}", flush=True)
    return 0


def cmd_router(args) -> int:
    """The prefix-affinity replica router in front of N running ``serve``
    processes (``serving/router.py``): it loads no model and imports no
    torch."""
    from deeplearning4j_tpu_torch.obs.logs import configure_json_logging
    from deeplearning4j_tpu_torch.obs.trace import Tracer
    from deeplearning4j_tpu_torch.serving.router import ReplicaRouter

    if args.log_json:
        configure_json_logging()
    tracer = Tracer(enabled=args.trace_out is not None,
                    capacity=args.trace_capacity, process_name="router")
    sans = _install_sanitizers() if args.sanitize else None
    try:
        router = ReplicaRouter(
            args.replica, host=args.host, port=args.port,
            affinity_min_match=args.affinity_min_match,
            health_interval_s=args.health_interval,
            request_timeout_s=args.request_timeout, tracer=tracer,
            flight_dir=args.flight_dir)
    except ValueError as e:
        print(f"router: {e}", file=sys.stderr)
        return 2
    host, port = router.address
    names = ", ".join(r.name for r in router.replicas)
    print(f"routing on http://{host}:{port} -> [{names}]  "
          f"(affinity >= {args.affinity_min_match} tokens, "
          f"health poll {args.health_interval:g}s)", flush=True)
    rc = _announce_and_serve(router, args, "router", tracer)
    return _report_sanitizers(None, *sans) if sans is not None else rc


def cmd_controller(args) -> int:
    """The disaggregated-fleet controller in front of N running ``serve``
    processes with roles (``serving/controller.py``): prompts of
    ``--disagg-threshold`` tokens or more (and at least the decode
    replica's hit grain) prefill on a prefill replica and their KV segment
    is pushed to the decode replica; the rest, and every failed transfer,
    prefill on the decode replica."""
    from deeplearning4j_tpu_torch.obs.logs import configure_json_logging
    from deeplearning4j_tpu_torch.obs.trace import Tracer
    from deeplearning4j_tpu_torch.serving.controller import (
        FleetController,
        RoleBalancer,
    )

    if args.log_json:
        configure_json_logging()
    tracer = Tracer(enabled=args.trace_out is not None,
                    capacity=args.trace_capacity, process_name="controller")
    sans = _install_sanitizers() if args.sanitize else None
    try:
        controller = FleetController(
            args.replica, host=args.host, port=args.port,
            disagg_threshold=args.disagg_threshold,
            affinity_min_match=args.affinity_min_match,
            health_interval_s=args.health_interval,
            request_timeout_s=args.request_timeout,
            rebalance=RoleBalancer(threshold=args.rebalance_threshold,
                                   windows=args.rebalance_windows,
                                   dwell_s=args.rebalance_dwell),
            rebalance_enabled=not args.no_rebalance,
            hedge_enabled=not args.no_hedge, journal=args.journal,
            standby_of=args.standby_of, failover_after=args.failover_after,
            tracer=tracer, flight_dir=args.flight_dir)
    except ValueError as e:
        print(f"controller: {e}", file=sys.stderr)
        return 2
    host, port = controller.address
    roles = ", ".join(f"{m.name}={m.role}" for m in controller.members)
    print(f"fleet control on http://{host}:{port} -> [{roles}]  "
          f"(disagg >= {args.disagg_threshold} tokens, "
          f"health poll {args.health_interval:g}s)", flush=True)
    rc = _announce_and_serve(controller, args, "controller", tracer)
    return _report_sanitizers(None, *sans) if sans is not None else rc


def _add_fleet_flags(ap, what: str) -> None:
    """The flags the router and the controller share (the reference's)."""
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--affinity-min-match", type=int, default=8,
                    help="shared-prefix tokens before affinity overrides "
                    "least-loaded dispatch")
    ap.add_argument("--health-interval", type=float, default=0.5,
                    help="seconds between /healthz polls of each replica")
    ap.add_argument("--request-timeout", type=float, default=300.0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help=f"enable the {what}'s dispatch tracer and write "
                    "its Chrome trace to PATH on shutdown (merge with the "
                    "replicas' by trace-merge)")
    ap.add_argument("--trace-capacity", type=int, default=1 << 16,
                    help="tracer ring-buffer size in events")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help=f"write the {what}'s flight-recorder bundle to DIR "
                    "on SIGTERM; GET /debug/dump serves the live one")
    ap.add_argument("--log-json", action="store_true")
    ap.add_argument("--port-file", default=None, metavar="PATH",
                    help="write the bound address as JSON to PATH once "
                    "listening (for harnesses using --port 0)")
    ap.add_argument("--sanitize", action="store_true",
                    help=f"development mode: run the {what} under the "
                    "runtime sanitizers (lock-order and lockset tracking); "
                    "prints a summary at shutdown and exits 1 on a "
                    "violation")


def cmd_lint(args) -> int:
    """Static analysis for the port's serving bug classes (host-sync,
    zero-copy-alias, prng-reuse, lock-discipline, retrace-hazard; their
    PyTorch meanings are in ``analysis/__init__.py``). Pure stdlib — never
    imports the linted code. Exits 1 on findings not accepted in the
    baseline (``analysis/lint_baseline.json``)."""
    from deeplearning4j_tpu_torch.analysis import lint as graftlint

    argv = list(args.paths)
    if args.rules:
        argv += ["--rules", args.rules]
    if args.baseline:
        argv += ["--baseline", args.baseline]
    for flag in ("no_baseline", "write_baseline", "strict"):
        if getattr(args, flag):
            argv.append("--" + flag.replace("_", "-"))
    return graftlint.main(argv)


def cmd_audit(args) -> int:
    """The serving program surface audited on ``meta`` tensors
    (graftaudit: dtype promotion, the in-place cache update, collective
    signatures, host syncs, the surface, flop/byte budgets against
    ``analysis/audit_baseline.json``). Exits 1 on findings."""
    from deeplearning4j_tpu_torch.analysis import audit as graftaudit

    argv = []
    if args.baseline:
        argv += ["--baseline", args.baseline]
    if args.json_out:
        argv += ["--json-out", args.json_out]
    for flag in ("no_baseline", "write_baseline", "strict", "full_budgets"):
        if getattr(args, flag):
            argv.append("--" + flag.replace("_", "-"))
    return graftaudit.main(argv)


def cmd_provision(args) -> int:
    """Render or EXECUTE cluster provisioning (≙ ClusterSetup.java:24,
    which actually SSHes): GPU VMs with H100s on GCP. The default is the
    dry run — every command that would execute is printed; ``--execute``
    runs them."""
    import shlex

    from deeplearning4j_tpu_torch.utils.provision import (
        ClusterSetup,
        ClusterSpec,
        RecordingRunner,
        SubprocessRunner,
    )

    spec = ClusterSpec(
        name=args.name, num_workers=args.num_workers,
        machine_type=args.machine_type, zone=args.zone,
        image_family=args.image_family, image_project=args.image_project,
        master_script=args.master_script, worker_script=args.worker_script)
    runner = SubprocessRunner() if args.execute else RecordingRunner()
    try:
        names = ClusterSetup(spec, runner=runner).provision()
    except Exception as e:  # ProvisionError / subprocess timeouts
        print(f"provisioning failed: {e}", file=sys.stderr)
        return 1
    if not args.execute:
        for cmd in runner.commands:
            print(shlex.join(cmd))  # paste-safe: spaced args stay quoted
        print(f"# dry run: {len(runner.commands)} commands for "
              f"{', '.join(names)} (pass --execute to run)")
    else:
        print(f"provisioned: {', '.join(names)}")
    return 0


def cmd_trace_merge(args) -> int:
    """Stitch per-process Chrome-trace exports (each a ``serve
    --trace-out``) into one Perfetto document: a process track per input,
    timestamps rebased onto one wall-clock origin, and flow arrows where a
    span's parent lives in another process."""
    from deeplearning4j_tpu_torch.obs.collect import merge_trace_files

    try:
        merged = merge_trace_files(args.traces, out_path=args.out)
    except (OSError, ValueError) as e:
        print(f"trace-merge: {e}", file=sys.stderr)
        return 2
    evs = merged["traceEvents"]
    n_pids = len({e["pid"] for e in evs})
    n_spans = sum(1 for e in evs if e.get("ph") == "X")
    n_flows = sum(1 for e in evs if e.get("ph") == "s")
    print(f"merged {len(args.traces)} traces -> {args.out}: "
          f"{n_pids} process tracks, {n_spans} spans, "
          f"{n_flows} cross-process links "
          f"(open at https://ui.perfetto.dev)")
    return 0


def _add_checkpoint_flags(ap, required: bool) -> None:
    ap.add_argument("--checkpoint-dir", required=required, default=None,
                    help="restore the newest checkpoint of this directory")
    ap.add_argument("--checkpoint-backend", default="npz",
                    choices=["npz", "orbax"],
                    help="npz (both packages' format) or orbax, the "
                    "reference's name for its sharded format: the port "
                    "reads torch.distributed.checkpoint directories")


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
                    help="MoE experts (dense decode over every expert)")
    ap.add_argument("--bf16", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train LeNet or AlexNet (data-parallel "
                       "over the cards or processes) or the transformer LM "
                       "(one device or a (data, model) mesh)")
    t.add_argument("--model", default="lenet",
                   choices=["lenet", "alexnet", "transformer"])
    t.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")
    t.add_argument("--epochs", type=int, default=1,
                   help="lenet, alexnet: passes")
    t.add_argument("--examples", type=int, default=4096,
                   help="lenet: MNIST examples; alexnet: synthetic CIFAR")
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--text", default=None, help="path to a byte-level corpus")
    t.add_argument("--steps", type=int, default=200)
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
                   help="MoE experts, one a model rank (must equal --tp)")
    t.add_argument("--tp", type=int, default=1,
                   help="model-axis ways of the (data, model) training "
                   "mesh; dp = cards // tp over every process's cards, "
                   "the model axis across processes when tp exceeds a "
                   "process's cards (1 data row a process with --device)")
    t.add_argument("--fsdp", action="store_true",
                   help="also split params and optimizer state over the "
                   "data axis (ZeRO-3)")
    t.add_argument("--checkpoint-dir", default=None,
                   help="save checkpoints here (npz: ckpt_<step>.npz; "
                   "orbax: <step>/; the newest 3 kept)")
    t.add_argument("--checkpoint-backend", default="npz",
                   choices=["npz", "orbax"],
                   help="npz (whole leaves, both packages' format) or "
                   "orbax, the reference's name for its sharded format: "
                   "the port writes torch.distributed.checkpoint "
                   "directories (each process its own parts, async)")
    t.add_argument("--save-every", type=int, default=50)
    t.add_argument("--status-port", type=int, default=None,
                   help="serve GET /statetracker and the control POSTs "
                   "(minibatch, earlystop, heartbeat, phase) here (0: any "
                   "free port)")
    t.add_argument("--status-host", default="127.0.0.1",
                   help="interface of the status REST server (loopback by "
                   "default; a routable one makes control POSTs need "
                   "X-Auth-Token)")
    t.add_argument("--status-token", default=None,
                   help="shared secret for control POSTs (X-Auth-Token); "
                   "generated into a 0600 file when binding non-loopback "
                   "without one")
    t.add_argument("--coordinator", default=None,
                   help="host:port of process 0's torch.distributed "
                   "rendezvous: train over a data axis across processes")
    t.add_argument("--num-processes", type=int, default=None)
    t.add_argument("--process-id", type=int, default=None)
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
    v.add_argument("--adaptive-horizon", action="store_true",
                   help="shrink the decode horizon to 1 while requests "
                   "wait in the queue and restore --decode-horizon when it "
                   "drains; token streams are unchanged")
    v.add_argument("--trace-out", default=None, metavar="PATH",
                   help="enable the request-lifecycle tracer and write a "
                   "Chrome-trace/Perfetto JSON of its spans to PATH at "
                   "shutdown")
    v.add_argument("--trace-capacity", type=int, default=1 << 16,
                   help="tracer ring-buffer size in events")
    v.add_argument("--port-file", default=None, metavar="PATH",
                   help="write the bound address as JSON to PATH once "
                   "listening (for harnesses using --port 0)")
    v.add_argument("--migrate-target", action="append", default=None,
                   metavar="HOST:PORT",
                   help="peer replica eligible to re-seat this replica's "
                   "in-flight sessions on drain (POST /migrate also takes "
                   "explicit targets); repeat per peer")
    v.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="write flight-recorder bundles (redacted JSON "
                   "postmortems) to DIR on an engine crash, a watchdog "
                   "trip or SIGTERM; GET /debug/dump serves the live one")
    v.add_argument("--log-json", action="store_true",
                   help="structured JSON log lines on stderr, correlated "
                   "by req_id and trace_id")
    v.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics (and the other observability GETs) "
                   "on a sidecar port")
    v.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="directory torch.profiler captures land in "
                   "(default: under the temporary directory)")
    v.add_argument("--profile-steps", type=int, default=0,
                   help="capture the FIRST N engine steps at startup (0: "
                   "only on demand through POST /profile?s=N)")
    v.add_argument("--probe-cache",
                   default=os.path.join(tempfile.gettempdir(),
                                        "dl4j_tpu_torch_probes.json"),
                   metavar="PATH",
                   help="persist parity-probe verdicts keyed by config, "
                   "stack and geometry, so restarts skip the probes "
                   "(default: a file in the temporary directory); 'off' "
                   "disables")
    v.add_argument("--embed-models", default=None, metavar="M[,M]",
                   help="embedding models to serve at POST /v1/embeddings "
                   "over a small demo vocabulary (word2vec, glove)")
    v.add_argument("--drain-s", type=float, default=5.0,
                   help="graceful-drain window at shutdown: admission stops "
                   "and requests in flight get this many seconds before "
                   "the stragglers are cancelled")
    v.add_argument("--hang-threshold", type=float, default=120.0,
                   help="seconds without an engine-loop heartbeat (while "
                   "work is pending) before /healthz reports the engine "
                   "hung and answers 503")
    v.add_argument("--max-restarts", type=int, default=5,
                   help="consecutive engine-crash recoveries before the "
                   "server declares the engine dead (/healthz 503)")
    v.add_argument("--run-seconds", type=float, default=None,
                   help="serve for N seconds, then drain and exit 0 (smoke "
                   "runs, timed captures; default: until Ctrl-C or "
                   "SIGTERM)")
    _add_model_flags(v)
    _add_int8_flag(v)
    v.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: shard the serving programs "
                   "(attention heads, MLP columns, vocab) and the KV pool "
                   "over the first N cards (with --device, N ranks on that "
                   "device). Gated by a construction-time bitwise parity "
                   "probe (--tp-parity); needs N dividing n_heads and "
                   "kv_heads; exits 2 with fewer than N cards. 1 = single "
                   "device")
    v.add_argument("--tp-parity", default="auto",
                   choices=["auto", "trust", "off"],
                   help="auto: probe TP against the single-device programs "
                   "bitwise once at startup and fall back to tp=1 on a "
                   "mismatch; trust: skip the probe; off: no TP")
    v.add_argument("--paged", action="store_true",
                   help="block-paged KV: slots hold int32 block tables over "
                   "one shared refcounted pool instead of fixed slabs; "
                   "gated by a one-time bitwise parity probe, falls back "
                   "to slab slots")
    v.add_argument("--block-size", type=int, default=None, metavar="T",
                   help="tokens per KV block with --paged (default 8; must "
                   "divide tokens-per-slot)")
    v.add_argument("--prefix-cache", action="store_true",
                   help="radix-tree KV prefix cache: admissions whose "
                   "prompt shares a cached prefix copy those KV rows "
                   "instead of recomputing them (gated by a one-time "
                   "bitwise parity probe; falls back to full prefill). "
                   "Hit rate and saved prefill tokens appear in "
                   "/metrics")
    v.add_argument("--prefix-cache-tokens", type=int, default=None,
                   metavar="N",
                   help="device-side prefix-cache capacity in tokens "
                   "(default: slots x tokens-per-slot, i.e. a region "
                   "as large as the slot pool)")
    v.add_argument("--prefix-affinity-tokens", type=int, default=0,
                   metavar="K",
                   help="scheduler promotes a queued request whose "
                   "first K prompt tokens match the previous admission "
                   "(same priority class only), so shared-prefix "
                   "requests land in the same admission batch; 0 = "
                   "plain FIFO")
    v.add_argument("--piggyback", action="store_true",
                   help="chunked-prefill piggyback: long prompts are "
                   "split into pow2 chunks and ride along with decode "
                   "dispatches (one fused program per horizon) instead "
                   "of stalling active streams behind a blocking "
                   "prefill. Token-budgeted per horizon; byte-identical "
                   "streams, gated by a one-time parity probe")
    v.add_argument("--prefill-budget", type=int, default=None,
                   metavar="N",
                   help="piggyback prefill token budget per decode "
                   "horizon (default: 2x the largest prefill bucket)")
    v.add_argument("--sampling-surface", action="store_true",
                   help="enable the sampling surface: grammar-constrained "
                   "decoding (response_format with a JSON schema or "
                   "regex), per-request temperature/top_k/top_p, stop "
                   "sequences, logit_bias and logprobs. One masked step "
                   "serves every request mix; unconstrained streams stay "
                   "byte-identical, gated by a one-time parity probe")
    v.add_argument("--grammar-states", type=int, default=256, metavar="N",
                   help="device DFA table rows shared by all seated "
                   "grammars (default: 256); compiles whose DFA exceeds "
                   "the free budget are rejected with 400")
    v.add_argument("--grammar-cache", type=str, default=None,
                   metavar="DIR",
                   help="on-disk grammar compile cache directory "
                   "(default: in-memory LRU only)")
    v.add_argument("--chaos-rate", type=float, default=0.0,
                   help="inject transient faults at engine boundaries "
                   "at this per-step probability (smoke-tests the "
                   "supervised retry/replay path; see serving/faults.py)")
    v.add_argument("--chaos-seed", type=int, default=0)
    v.add_argument("--tenants", default=None, metavar="PATH",
                   help="JSON tenant registry: API keys (X-API-Key / "
                   "Bearer), per-tenant priority and weighted-fair share, "
                   "KV-slot caps, token-rate quotas (429), a default LoRA "
                   "adapter and a p99-TPOT objective per tenant")
    v.add_argument("--lora-adapters", type=int, default=0, metavar="N",
                   help="load a batched-LoRA bank of N adapters (random "
                   "demo factors; index 0 is the zero adapter, bitwise the "
                   "base model); requests pick one with 'adapter' or their "
                   "tenant's default. 0 = no bank")
    v.add_argument("--lora-rank", type=int, default=4,
                   help="rank of the demo LoRA factors")
    v.add_argument("--lora-seed", type=int, default=0,
                   help="seed of the demo LoRA bank (threefry key(seed), "
                   "the reference's bank up to erfinv's last ulps)")
    v.add_argument("--sanitize", action="store_true",
                   help="development mode: serve under the runtime "
                   "sanitizers (lock-order and lockset tracking, "
                   "device->host syncs per engine phase with none allowed "
                   "in dispatch, the program-key contract); prints a "
                   "summary at shutdown and exits 1 on a violation")
    v.set_defaults(fn=cmd_serve)

    r = sub.add_parser(
        "router",
        help="prefix-affinity router over N running serve replicas "
        "(least-loaded dispatch, per-replica health, crash retry)")
    r.add_argument("--replica", action="append", required=True,
                   metavar="HOST:PORT",
                   help="one backend serve address; repeat per replica")
    _add_fleet_flags(r, "router")
    r.set_defaults(fn=cmd_router)

    c = sub.add_parser(
        "controller",
        help="disaggregated-fleet controller over N serve replicas with "
        "prefill/decode roles (KV-segment transfer for long prompts, "
        "session stickiness, role rebalancing, rolling-restart drains)")
    c.add_argument("--replica", action="append", required=True,
                   metavar="HOST:PORT[=ROLE]",
                   help="one backend serve address with an optional role "
                   "(prefill|decode|monolithic, default monolithic); "
                   "repeat per replica")
    _add_fleet_flags(c, "controller")
    c.add_argument("--disagg-threshold", type=int, default=64, metavar="N",
                   help="prompt length (tokens) from which a request takes "
                   "the prefill -> transfer -> decode path; a decode "
                   "replica's hit grain (the largest prefill bucket, from "
                   "its /healthz) raises it for that replica")
    c.add_argument("--rebalance-threshold", type=float, default=2.0,
                   help="pressure ratio (queue depth + SLO burn) one role "
                   "pool must exceed over the other before a role flip")
    c.add_argument("--rebalance-windows", type=int, default=3,
                   help="consecutive imbalanced samples before a flip")
    c.add_argument("--rebalance-dwell", type=float, default=30.0,
                   help="minimum seconds between role flips")
    c.add_argument("--no-rebalance", action="store_true",
                   help="no automatic role rebalancing (POST /fleet/role "
                   "still moves roles)")
    c.add_argument("--no-hedge", action="store_true",
                   help="no hedged second attempt on the idempotent "
                   "KV-transfer leg (generate legs are never hedged)")
    c.add_argument("--journal", default=None, metavar="PATH",
                   help="journal roles, stickiness and breaker state to "
                   "PATH so a warm standby can take over")
    c.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                   help="run as a warm standby of the primary at HOST:PORT "
                   "(503 to all traffic), promoting from --journal after "
                   "--failover-after missed health checks")
    c.add_argument("--failover-after", type=int, default=3,
                   help="consecutive missed primary health checks before a "
                   "standby promotes itself")
    c.set_defaults(fn=cmd_controller)

    st = sub.add_parser("status",
                        help="print a running trainer's REST status")
    st.add_argument("--port", type=int, required=True)
    st.add_argument("--host", default="127.0.0.1")
    st.set_defaults(fn=cmd_status)

    m = sub.add_parser(
        "trace-merge",
        help="stitch per-process --trace-out exports into one Perfetto "
        "trace with cross-process flow arrows")
    m.add_argument("traces", nargs="+", metavar="TRACE.json",
                   help="per-process Chrome-trace JSON files")
    m.add_argument("-o", "--out", required=True, metavar="PATH",
                   help="merged Perfetto JSON output path")
    m.set_defaults(fn=cmd_trace_merge)

    L = sub.add_parser(
        "lint",
        help="static analysis for the serving stack's bug classes "
        "(graftlint); exits 1 on non-baselined findings")
    L.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the "
                   "deeplearning4j_tpu_torch package)")
    L.add_argument("--rules", default=None, metavar="R1,R2",
                   help="comma-separated rule subset")
    L.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline JSON (default: analysis/"
                   "lint_baseline.json in the package)")
    L.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    L.add_argument("--write-baseline", action="store_true",
                   help="accept the current findings into the baseline")
    L.add_argument("--strict", action="store_true",
                   help="also fail on stale baseline entries and TODO "
                   "reasons")
    L.set_defaults(fn=cmd_lint)

    A = sub.add_parser(
        "audit",
        help="audit every program family the serving engine can dispatch "
        "on meta tensors (graftaudit: dtype, in-place update, "
        "collectives, host syncs, surface, flop/byte budgets); exits 1 on "
        "findings")
    A.add_argument("--baseline", default=None, metavar="PATH",
                   help="budget baseline JSON (default: analysis/"
                   "audit_baseline.json in the package)")
    A.add_argument("--no-baseline", action="store_true",
                   help="skip baseline comparison entirely")
    A.add_argument("--write-baseline", action="store_true",
                   help="(re)write the baseline from this run")
    A.add_argument("--strict", action="store_true",
                   help="also fail on stale baseline entries")
    A.add_argument("--full-budgets", action="store_true",
                   help="record budgets for every program, not just each "
                   "family's envelope")
    A.add_argument("--json-out", default=None, metavar="PATH",
                   help="write the full report as JSON")
    A.set_defaults(fn=cmd_audit)

    p = sub.add_parser(
        "provision",
        help="provision a GPU-VM cluster on GCP (dry run by default; "
        "--execute runs the gcloud commands)")
    p.add_argument("name")
    p.add_argument("--machine-type", default="a3-highgpu-1g",
                   help="GCP machine type (A3: H100s; -1g one card, -8g "
                   "eight)")
    p.add_argument("--zone", default="us-central1-a")
    p.add_argument("--image-family", default="pytorch-latest-gpu")
    p.add_argument("--image-project", default="deeplearning-platform-release")
    p.add_argument("--num-workers", type=int, default=0,
                   help="worker VMs besides the master")
    p.add_argument("--master-script", default=None,
                   help="setup script run on the master after create")
    p.add_argument("--worker-script", default=None,
                   help="setup script run on each worker after create")
    p.add_argument("--execute", action="store_true",
                   help="actually run the commands (default: print them)")
    p.set_defaults(fn=cmd_provision)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
