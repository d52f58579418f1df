"""A model axis across processes, ZeRO-3 over a data axis across processes
and the ring across processes: two gloo processes on the CPU, every run
from the reference's init of its tiny transformer (``tests/_dist_common.py``
through ``tests/test_torch_distributed.py``) on the same global batch.

- The reference worker's topology (``tests/distributed_worker.py:133-215``):
  each process on ``["cpu"] * 4``, a (4, 2) mesh whose model pairs span the
  processes (``hybrid_mesh({"data": 4, "model": 1}, {"model": 2})``).
  Replicated, FSDP and MoE (2 experts, one a process), and the replicated
  run under AdamW's global-norm clip: losses equal across the processes,
  within rtol 1e-5, atol 1e-6 of the port's one-process (4, 2) run
  (``tests/test_distributed_multiprocess.py:146``'s bar), and the first
  three within ``LOSS_RTOL`` of the reference's ``transformer_train_step``
  on its own (4, 2) mesh.
- ZeRO-3: ``hybrid_mesh({"data": 2, "model": 2}, {"data": 2})``, FSDP over
  the global data axis of 4: the same bars against the one-process (4, 2)
  FSDP run, and the bytes a process holds of the split leaves (params and
  both AdamW moments) half of what each process held under HSDP (the
  one-process (2, 2) FSDP layout).
- Sequence parallelism: the ring over a data axis of 4 across the two
  processes against the one-process ring on (4, 1), and the reference's.
- The elastic restore: each layout's sharded checkpoint, written by the
  two processes, restored by this one onto its (4, 2) layout and held
  against the one-process params.
- The cross-process primitives, forward and gradient, against their
  one-process counterparts: (a) the row-parallel sum, (b) its conjugate at
  the column-parallel input, (c) the gather of model parts, and the data
  parts' gather (ZeRO-3 and the ring).
- The CLI's mesh rule and backend rule as plain functions.

The worker is this file run as a script; it imports no JAX.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
#: f32 losses after a few optimizer steps against the reference's
LOSS_RTOL = 2e-3
#: the clip run's max norm: small enough that every step clips
CLIP = 0.01
#: the ring's tokens: T divisible by the data axis of 4
SP_TOKENS = (8, 8)


def _train(mesh, init: str, tag: str, fsdp: bool, clip=None, sp=False):
    """``STEPS`` train steps from the init saved for ``tag`` (the
    sequence-parallel run: its config with the ring, the replicated
    init); (loss, params, opt_state)."""
    from test_torch_distributed import STEPS, _tokens

    from deeplearning4j_tpu_torch.models import transformer as pt

    saved = torch.load(init, weights_only=False)
    cfg = pt.TransformerConfig.from_json(saved["config"][tag])
    toks = _tokens()
    if sp:
        cfg = dataclasses.replace(cfg, sequence_parallel=True)
        toks = toks[:, :SP_TOKENS[1]]
    params = pt.place_transformer_params(mesh, saved["params"][tag], cfg,
                                         fsdp)
    opt = pt.AdamW(3e-4, clip_norm=clip)
    state = opt.init(params)
    step, _, shard_tokens = pt.transformer_train_step(mesh, cfg,
                                                      optimizer=opt,
                                                      fsdp=fsdp)
    shard = shard_tokens(toks)
    loss = None
    for _ in range(STEPS):
        params, state, loss = step(params, state, shard)
    return float(loss), params, state


#: the runs each process makes: name -> (ici, dcn, tag, fsdp, clip, sp)
RUNS = {
    "REPLICATED": ({"data": 4, "model": 1}, {"model": 2}, "REPLICATED",
                   False, None, False),
    "FSDP": ({"data": 4, "model": 1}, {"model": 2}, "FSDP", True, None,
             False),
    "MOE": ({"data": 4, "model": 1}, {"model": 2}, "MOE", False, None,
            False),
    "CLIP": ({"data": 4, "model": 1}, {"model": 2}, "REPLICATED", False,
             CLIP, False),
    "ZERO3": ({"data": 2, "model": 2}, {"data": 2}, "FSDP", True, None,
              False),
    "SP": ({"data": 2, "model": 1}, {"data": 2}, "REPLICATED", False, None,
           True),
}
#: the one-process mesh each run is held against: (dp, tp)
ONE_PROCESS = {name: (4, 1) if name == "SP" else (4, 2) for name in RUNS}
#: the runs whose sharded checkpoint the elastic restore reads
SAVED = ("REPLICATED", "FSDP", "ZERO3")


def _split_bytes(params, state) -> dict[str, int]:
    """Bytes this process holds of each leaf the data axis splits, params
    and both AdamW moments (``layout_bytes``' sum), by the leaf's path."""
    from deeplearning4j_tpu_torch.models import transformer as pt

    out = {}
    for tree in (params, state["mu"], state["nu"]):
        for path, leaf in pt._leaves(tree):
            if leaf.dim_of("data") is not None:
                key = "/".join(path)
                out[key] = out.get(key, 0) + sum(pt.layout_bytes(
                    {"leaf": leaf}).values())
    return out


def _prims(mesh, outdir: Path, pid: int) -> None:
    """Each primitive's output and its inputs' gradients on a (1, 2) mesh
    whose model axis spans the processes, and the data parts' on a (2, 1)
    one across them; saved for the test's one-process counterparts."""
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    gen = torch.Generator().manual_seed(100)
    x_all = torch.randn((2, 3, 5), generator=gen)  # rank m's partial: x[m]
    w = torch.randn((3, 5), generator=gen)  # the upstream weights
    parts = [x_all[pid].clone().requires_grad_(True)]
    y = mesh_lib.model_sum(mesh, parts, "cpu")
    (g,) = torch.autograd.grad((y * w).sum(), parts)
    out["a"] = (y.detach(), g)
    h = x_all[0].clone().requires_grad_(True)
    (h_m,) = mesh_lib.model_inputs(mesh, h, ["cpu"])
    (g,) = torch.autograd.grad((h_m * x_all[1] * (pid + 1)).sum(), [h])
    out["b"] = (h_m.detach(), g)
    sizes = [3, 2]  # unequal parts, as a vocab split leaves them
    cat_all = torch.randn((4, 5), generator=gen)
    piece = cat_all[:, :3] if pid == 0 else cat_all[:, 3:]
    piece = piece.clone().requires_grad_(True)
    y = mesh_lib.model_cat(mesh, [piece], -1, sizes)
    (g,) = torch.autograd.grad((y * cat_all).sum(), [piece])
    out["c"] = (y.detach(), g)
    dmesh = mesh_lib.hybrid_mesh({"data": 1, "model": 1}, {"data": 2},
                                 devices=["cpu"])
    blocks = torch.randn((2, 4, 3), generator=gen)
    mine = blocks[pid].clone().requires_grad_(True)
    every = mesh_lib.data_parts(dmesh, [mine], 0, [4, 4])
    wts = torch.randn((2, 2, 4, 3), generator=gen)[pid]
    (g,) = torch.autograd.grad(sum((e * wt).sum() for e, wt in
                                   zip(every, wts)), [mine])
    out["data"] = (torch.stack([e.detach() for e in every]), g)
    torch.save(out, outdir / f"prims{pid}.pt")


def _worker(coordinator: str, pid: int, outdir: str, init: str) -> int:
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        AsyncShardedCheckpointManager,
    )
    from deeplearning4j_tpu_torch.parallel.cluster import (
        initialize_distributed,
    )

    outdir = Path(outdir)
    backend = initialize_distributed(coordinator, 2, pid, device="cpu")
    print(f"BACKEND={backend}", flush=True)
    for name, (ici, dcn, tag, fsdp, clip, sp) in RUNS.items():
        mesh = mesh_lib.hybrid_mesh(ici, dcn, devices=["cpu"] * (
            ici["data"] * ici["model"]))
        loss, params, state = _train(mesh, init, tag, fsdp, clip, sp)
        print(f"{name}LOSS={loss:.10f}", flush=True)
        if name in SAVED:
            mgr = AsyncShardedCheckpointManager(outdir / f"ck_{name}",
                                                save_every=1)
            mgr.maybe_save(3, params, {"run": name})
            mgr.close()
        if fsdp:
            print(f"{name}BYTES={json.dumps(_split_bytes(params, state))}",
                  flush=True)
    _prims(mesh_lib.hybrid_mesh({"data": 1, "model": 1}, {"model": 2},
                                devices=["cpu"]), outdir, pid)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs, the two processes' and the one-process runs
    of every case."""
    from test_torch_distributed import _reference

    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib

    tmp = tmp_path_factory.mktemp("model_axis")
    init = tmp / "init.pt"
    jref = _reference(init)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, __file__, coordinator, str(pid), str(tmp),
         str(init)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(ROOT)) for pid in range(2)]
    try:
        one = {}
        for name, (_, _, tag, fsdp, clip, sp) in RUNS.items():
            dp, tp = ONE_PROCESS[name]
            one[name] = _train(mesh_lib.dp_mp_mesh(dp, tp, ["cpu"] * (
                dp * tp)), init, tag, fsdp, clip, sp)
        hsdp = _train(mesh_lib.dp_mp_mesh(2, 2, ["cpu"] * 4), init, "FSDP",
                      True)
        outs = [p.communicate(timeout=420)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert re.search(r"^BACKEND=gloo$", out, re.M), out[-3000:]
    return dict(jref=jref, one=one, hsdp=hsdp, outs=outs, tmp=tmp,
                init=init)


def _printed(outs, key: str) -> list[float]:
    return [float(re.search(rf"^{key}=(\S+)$", out, re.M).group(1))
            for out in outs]


@pytest.mark.parametrize("name", ["REPLICATED", "FSDP", "MOE", "CLIP"])
def test_model_axis_across_processes(runs, name):
    """The reference worker's (4, 2) topology, model pairs across the two
    processes: equal losses, the one-process run's, the reference's."""
    vals = _printed(runs["outs"], f"{name}LOSS")
    assert vals[0] == vals[1], (name, vals)
    np.testing.assert_allclose(vals[0], runs["one"][name][0], rtol=RTOL,
                               atol=ATOL, err_msg=name)
    if name != "CLIP":
        np.testing.assert_allclose(vals[0], runs["jref"][name][0],
                                   rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"{name} vs the reference")


def test_zero3_holds_half_and_matches(runs):
    """FSDP over a data axis across the processes is ZeRO-3: each split
    leaf's shard and AdamW state in one process, half of what each
    process held under HSDP; the losses meet the same bars."""
    vals = _printed(runs["outs"], "ZERO3LOSS")
    assert vals[0] == vals[1], vals
    np.testing.assert_allclose(vals[0], runs["one"]["ZERO3"][0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(vals[0], runs["jref"]["FSDP"][0],
                               rtol=LOSS_RTOL, atol=0)
    held = [json.loads(re.search(r"^ZERO3BYTES=(.*)$", out, re.M).group(1))
            for out in runs["outs"]]
    _, params, state = runs["hsdp"]
    hsdp = _split_bytes(params, state)
    # the leaves both layouts split over the data axis (a data axis of 4
    # leaves b1 whole: its one free dim, the layers, is 2)
    both = sorted(set(held[0]) & set(hsdp))
    assert len(both) >= len(hsdp) - 1, (sorted(held[0]), sorted(hsdp))
    mine = [sum(h[k] for k in both) for h in held]
    assert mine[0] == mine[1] and 2 * mine[0] == sum(hsdp[k] for k in both
                                                     ), (held, hsdp)


def test_sequence_parallel_across_processes(runs):
    """The ring over a data axis of 4 across the two processes: equal
    losses, the one-process ring's, and the reference's ring on its
    (4, 1) mesh."""
    import jax
    import jax.numpy as jnp

    from test_torch_distributed import STEPS, TINY, SEED, _tokens

    from deeplearning4j_tpu.models import transformer as jt
    from deeplearning4j_tpu.parallel import mesh as jmesh

    vals = _printed(runs["outs"], "SPLOSS")
    assert vals[0] == vals[1], vals
    np.testing.assert_allclose(vals[0], runs["one"]["SP"][0], rtol=RTOL,
                               atol=ATOL)
    jcfg = jt.TransformerConfig(**TINY, sequence_parallel=True)
    step, init_state, shard = jt.transformer_train_step(
        jmesh.dp_mp_mesh(4, 1), jcfg)
    params, opt = init_state(jax.random.key(SEED))
    toks = shard(jnp.asarray(_tokens()[:, :SP_TOKENS[1]]))
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, toks)
    np.testing.assert_allclose(vals[0], float(loss), rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("name", SAVED)
def test_elastic_restore_from_cross_process_layouts(runs, name):
    """The two processes' checkpoint (each wrote the parts it holds)
    restored by this one process onto its (4, 2) layout: the one-process
    params of the same run, leaf for leaf."""
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        AsyncShardedCheckpointManager,
    )

    want = runs["one"][name][1]
    mgr = AsyncShardedCheckpointManager(runs["tmp"] / f"ck_{name}")
    restored, meta = mgr.restore_latest(want)
    mgr.close()
    assert meta["run"] == name and int(meta["step"]) == 3
    held = dict(pt._leaves(want))
    for path, leaf in pt._leaves(restored):
        assert leaf.spec == held[path].spec, path
        np.testing.assert_allclose(
            leaf.whole().numpy(), held[path].whole().detach().numpy(),
            rtol=RTOL, atol=ATOL, err_msg=f"{name} {path}")


def _one_process_prims() -> dict:
    """The primitives' one-process counterparts, on the inputs the
    workers draw: (a) the partials' sum, (b) the input's gradient from
    both ranks, (c) the concatenation, the data parts' gather."""
    gen = torch.Generator().manual_seed(100)
    x_all = torch.randn((2, 3, 5), generator=gen)
    w = torch.randn((3, 5), generator=gen)
    out = {}
    parts = [x_all[m].clone().requires_grad_(True) for m in range(2)]
    y = parts[0] + parts[1]
    grads = torch.autograd.grad((y * w).sum(), parts)
    out["a"] = (y.detach(), grads)
    h = x_all[0].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(sum((h * x_all[1] * (m + 1)).sum()
                                   for m in range(2)), [h])
    out["b"] = (h.detach(), [g, g])
    cat_all = torch.randn((4, 5), generator=gen)
    x = cat_all.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((x * cat_all).sum(), [x])
    out["c"] = (cat_all, [g[:, :3], g[:, 3:]])
    blocks = torch.randn((2, 4, 3), generator=gen)
    wts = torch.randn((2, 2, 4, 3), generator=gen)
    b = blocks.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(sum((b[k] * wts[p, k]).sum()
                                   for p in range(2) for k in range(2)),
                               [b])
    out["data"] = (blocks, [g[0], g[1]])
    return out


@pytest.mark.parametrize("prim", ["a", "b", "c", "data"])
def test_cross_process_primitive(runs, prim):
    """Each primitive's forward (the same on both processes) and each
    process's input gradient against the one-process counterpart."""
    want_y, want_g = _one_process_prims()[prim]
    for pid in range(2):
        got_y, got_g = torch.load(runs["tmp"] / f"prims{pid}.pt")[prim]
        torch.testing.assert_close(got_y, want_y, rtol=0, atol=0)
        torch.testing.assert_close(got_g, want_g[pid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nproc,cards,tp,device,want", [
    # one process: dp = cards // tp over its first cards
    (1, 4, 2, None, ({"data": 2, "model": 2}, None, None)),
    # --device D: every rank of a process on D, the data axis across
    (2, 1, 3, "cuda:0", ({"data": 1, "model": 3}, {"data": 2},
                         ["cuda:0"] * 3)),
    # tp inside a process's cards: data across the processes
    (2, 4, 2, None, ({"data": 2, "model": 2}, {"data": 2}, None)),
    # two one-card processes with --tp 2: one model row over both
    (2, 1, 2, None, ({"data": 1, "model": 1}, {"data": 1, "model": 2},
                     None)),
    # 4 processes of 2 cards, tp 4: 2 model rows of 2 processes each
    (4, 2, 4, None, ({"data": 1, "model": 2}, {"data": 2, "model": 2},
                     None)),
])
def test_cli_mesh_rule(nproc, cards, tp, device, want):
    from deeplearning4j_tpu_torch.cli import train_mesh_layout

    assert train_mesh_layout(nproc, cards, tp, device) == want


def test_cli_mesh_rule_refuses_a_split_that_does_not_lay_out():
    from deeplearning4j_tpu_torch.cli import train_mesh_layout

    with pytest.raises(ValueError, match="does not lay out"):
        train_mesh_layout(2, 2, 3)


@pytest.mark.parametrize("device,cuda,shared,want", [
    ("cpu", False, False, "gloo"),
    ("cuda:0", True, False, "gloo"),
    (None, True, False, "nccl"),
    (None, True, True, "gloo"),
    (None, False, False, "gloo"),
])
def test_backend_rule(monkeypatch, device, cuda, shared, want):
    from deeplearning4j_tpu_torch.parallel.cluster import distributed_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    backend, why = distributed_backend(device, shared)
    assert backend == want and why


class _Store:
    """The rendezvous store's ``set`` and ``get``, in one process."""

    def __init__(self):
        self.kv = {}

    def set(self, k, v):
        self.kv[k] = v.encode() if isinstance(v, str) else v

    def get(self, k):
        return self.kv[k]


@pytest.mark.parametrize("ids,want", [
    ([["GPU-a"], ["GPU-a"]], True),
    ([["GPU-a"], ["GPU-b"]], False),
    ([["GPU-a", "GPU-b"], ["GPU-c", "GPU-b"]], True),
])
def test_cards_shared_through_the_store(ids, want):
    from deeplearning4j_tpu_torch.parallel.cluster import cards_shared

    store = _Store()
    for r, mine in enumerate(ids):
        store.set(str(r), json.dumps(mine))
    assert cards_shared(store, 0, len(ids), ids[0]) is want


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3],
                     sys.argv[4]))
