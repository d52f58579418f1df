"""Training over a data axis across processes: two gloo processes on the
CPU, each driving a (2, 2) mesh of ``["cpu"] * 4`` (global data axis 4),
the ``torch.distributed`` coordinator found through a ``RegistryServer``
(process 0 publishes it, process 1 retrieves it: no shared state but the
registry's address). Every run starts from the reference's init of its
tiny transformer (``tests/_dist_common.py``'s config and seeds) and takes
the same global batch:

- replicated, FSDP (HSDP across the processes) and MoE (2 experts, one a
  model rank) losses equal across the processes; within rtol 1e-5, atol
  1e-6 of the port's one-process (4, 2) run over ``["cpu"] * 8`` (the
  reference's bar, ``tests/test_distributed_multiprocess.py:146``); and
  within ``LOSS_RTOL`` of the reference's ``transformer_train_step`` on
  its own (4, 2) mesh of virtual devices (the bar of the port's mesh
  tests against the reference, ``tests/test_torch_train_mesh.py``);
- the elastic restore: the two processes' sharded checkpoint restored by
  this one process onto its (4, 2) layout matches the port's one-process
  params at the same rtol 1e-5, and the reference's params leaf by leaf
  within ``PARAM_RTOL`` of the leaf's norm (the bar of the port's train
  step against the reference, ``tests/test_torch_transformer_train.py``).

The worker is this file run as a script; it imports no JAX.
"""

import os
import re
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
#: f32 losses after a few optimizer steps against the reference's
LOSS_RTOL = 2e-3
#: a param leaf against the reference's: ||a - b|| <= PARAM_RTOL * ||b||
PARAM_RTOL = 1e-5
#: the reference's tiny transformer and seeds (tests/_dist_common.py)
TINY = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
            max_len=16)
SEED, TOKENS, STEPS = 5, (8, 9), 3
MODES = {"REPLICATED": dict(fsdp=False, n_experts=0),
         "FSDP": dict(fsdp=True, n_experts=0),
         "MOE": dict(fsdp=False, n_experts=2)}


def _tokens():
    return np.random.default_rng(SEED).integers(0, TINY["vocab_size"],
                                                TOKENS)


def _run(mesh, init: str, tag: str):
    """``STEPS`` train steps on one global batch from the init saved in
    ``init`` for ``tag``; (loss, params, step)."""
    from deeplearning4j_tpu_torch.models import transformer as pt

    saved = torch.load(init, weights_only=False)
    cfg = pt.TransformerConfig.from_json(saved["config"][tag])
    fsdp = MODES[tag]["fsdp"]
    params = pt.place_transformer_params(mesh, saved["params"][tag], cfg,
                                         fsdp)
    opt = pt.AdamW(3e-4)  # the reference step's default, optax.adamw(3e-4)
    state = opt.init(params)
    step, _, shard_tokens = pt.transformer_train_step(mesh, cfg,
                                                      optimizer=opt,
                                                      fsdp=fsdp)
    toks = shard_tokens(_tokens())
    loss = None
    for _ in range(STEPS):
        params, state, loss = step(params, state, toks)
    return float(loss), params, step


def _reference(init: Path) -> dict:
    """The reference's run of each mode on its (4, 2) mesh of virtual
    devices: its init (saved to ``init`` as the port's trees) and its last
    loss; the replicated run's final params as a numpy tree."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.models import transformer as jt
    from deeplearning4j_tpu.parallel import mesh as jmesh
    from deeplearning4j_tpu_torch.models import transformer as pt

    out, saved = {}, {"config": {}, "params": {}}
    for tag, kw in MODES.items():
        jcfg = jt.TransformerConfig(**TINY, n_experts=kw["n_experts"])
        step, init_state, shard = jt.transformer_train_step(
            jmesh.dp_mp_mesh(4, 2), jcfg, fsdp=kw["fsdp"])
        params, opt = init_state(jax.random.key(SEED))
        tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
        saved["config"][tag] = jcfg.to_json()
        saved["params"][tag] = pt.params_from_jax(
            jax.tree.map(np.array, params), tcfg, device="cpu")
        toks = shard(jnp.asarray(_tokens()))
        for _ in range(STEPS):
            params, opt, loss = step(params, opt, toks)
        out[tag] = (float(loss), jax.tree.map(np.array, params))
    torch.save(saved, init)
    return out


def _ref_leaf(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return np.asarray(tree, np.float32)


def _worker(registry: str, job: str, pid: int, nprocs: int, ckdir: str,
            init: str) -> int:
    import socket

    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        AsyncShardedCheckpointManager,
    )
    from deeplearning4j_tpu_torch.parallel.cluster import (
        initialize_distributed,
    )
    from deeplearning4j_tpu_torch.parallel.registry import NetworkRegistry

    reg = NetworkRegistry(registry, job)
    if pid == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"
        reg.register_master({"coordinator": coordinator, "nprocs": nprocs})
    else:
        coordinator = reg.retrieve_master(timeout=60.0)["coordinator"]
    backend = initialize_distributed(coordinator, nprocs, pid, device="cpu")
    reg.register_worker(str(pid), {"devices": 4})
    mesh = mesh_lib.hybrid_mesh({"data": 2, "model": 2}, {"data": nprocs},
                                devices=["cpu"] * 4)
    assert mesh.num_processes == nprocs and mesh.global_data_size == 4
    print(f"BACKEND={backend}", flush=True)
    for tag in MODES:
        loss, params, step = _run(mesh, init, tag)
        print(f"{tag}LOSS={loss:.10f}", flush=True)
        print(f"{tag}BUCKET={step.stats['bucket_bytes']}", flush=True)
        if tag == "REPLICATED":
            mgr = AsyncShardedCheckpointManager(ckdir, save_every=1)
            mgr.maybe_save(STEPS, params, {"loss": loss})
            mgr.close()
    import torch.distributed as dist

    dist.barrier()
    print(f"WORKERS={','.join(reg.list_workers())}", flush=True)
    dist.destroy_process_group()
    return 0


def test_two_processes_match_the_one_process_run(tmp_path):
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        AsyncShardedCheckpointManager,
    )
    from deeplearning4j_tpu_torch.parallel.registry import RegistryServer

    init = tmp_path / "init.pt"
    jref = _reference(init)
    server = RegistryServer()
    addr = server.start()
    ckdir = tmp_path / "ck"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    job = f"dist-{uuid.uuid4().hex[:8]}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, addr, job, str(pid), "2", str(ckdir),
         str(init)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT)) for pid in range(2)]
    try:
        mesh = mesh_lib.dp_mp_mesh(4, 2, ["cpu"] * 8)
        ref = {tag: _run(mesh, init, tag) for tag in MODES}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        server.stop()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert re.search(r"^BACKEND=gloo$", out, re.M), out[-3000:]
        m = re.search(r"^WORKERS=(.*)$", out, re.M)
        assert m and m.group(1) == "0,1", out[-3000:]
    n_params = sum(leaf.whole().numel() for _, leaf in
                   pt._leaves(ref["REPLICATED"][1]))
    for tag in MODES:
        vals = [float(re.search(rf"^{tag}LOSS=(\S+)$", out, re.M).group(1))
                for out in outs]
        assert vals[0] == vals[1], (tag, vals)
        np.testing.assert_allclose(vals[0], ref[tag][0], rtol=RTOL,
                                   atol=ATOL, err_msg=tag)
        np.testing.assert_allclose(vals[0], jref[tag][0], rtol=LOSS_RTOL,
                                   atol=0, err_msg=f"{tag} vs the reference")
    # one bucket a step: every gradient part of the local layout and the
    # loss, f32
    bucket = int(re.search(r"^REPLICATEDBUCKET=(\d+)$", outs[0],
                           re.M).group(1))
    assert bucket >= 4 * (n_params + 1)
    mgr = AsyncShardedCheckpointManager(ckdir)
    restored, meta = mgr.restore_latest(ref["REPLICATED"][1])
    mgr.close()
    assert int(meta["step"]) == STEPS
    want = dict(pt._leaves(ref["REPLICATED"][1]))
    for path, leaf in pt._leaves(restored):
        assert leaf.spec == want[path].spec
        got = leaf.whole().numpy()
        np.testing.assert_allclose(got, want[path].whole().detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=str(path))
        r = _ref_leaf(jref["REPLICATED"][1], path)
        err = np.linalg.norm(got - r)
        assert err <= PARAM_RTOL * np.linalg.norm(r), (path, err)


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], sys.argv[2], int(sys.argv[3]),
                     int(sys.argv[4]), sys.argv[5], sys.argv[6]))
