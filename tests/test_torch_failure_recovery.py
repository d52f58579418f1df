"""Failure recovery end to end, the port's counterpart of
``tests/test_failure_recovery.py``: a worker trains a small torch MLP with
plain SGD, checkpoints through the port's ``CheckpointManager`` every
``EVERY`` steps and heartbeats to a port ``ClusterService`` over REST. It
is SIGKILLed once its checkpoint at step ``KILL_AT`` exists, the master
evicts it after 2 s of silence, and the restarted worker resumes from the
checkpoint; its final params must equal an uninterrupted run's bitwise
(step-indexed data and a stateless optimizer replay the lost steps
exactly).

The kill is deterministic: the worker writes a signal file after the
checkpoint at ``KILL_AT`` and blocks; the parent kills it on that file.
The worker is this file run as a script.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOTAL, EVERY, KILL_AT = 40, 5, 20


def _batch(i: int):
    """Step-indexed data: replayable after a restart."""
    rng = np.random.default_rng(1000 + i)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = rng.integers(0, 3, 16)
    return torch.from_numpy(x), torch.from_numpy(y)


def _init():
    rng = np.random.default_rng(7)
    return {"w1": torch.from_numpy(rng.normal(size=(6, 12)).astype(
                np.float32) * 0.4),
            "b1": torch.zeros(12),
            "w2": torch.from_numpy(rng.normal(size=(12, 3)).astype(
                np.float32) * 0.4),
            "b2": torch.zeros(3)}


def _worker() -> int:
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        CheckpointManager,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("--status-url", default=None)
    ap.add_argument("--final", default=None)
    ap.add_argument("--signal-at", type=int, default=None,
                    help="after the checkpoint at this step, write "
                    "--signal-file and block until killed")
    ap.add_argument("--signal-file", default=None)
    args = ap.parse_args()
    params = _init()
    mgr = CheckpointManager(args.ckpt_dir, save_every=EVERY, keep=3)
    start = 0
    restored = mgr.restore_latest(params, device="cpu")
    if restored is not None:
        params, meta = restored
        start = int(meta["step"])
        print(f"RESUMED_FROM={start}", flush=True)
    loss = None
    for i in range(start + 1, TOTAL + 1):
        x, y = _batch(i)
        for p in params.values():
            p.requires_grad_(True)
        h = torch.tanh(x @ params["w1"] + params["b1"])
        loss_t = torch.nn.functional.cross_entropy(
            h @ params["w2"] + params["b2"], y)
        grads = torch.autograd.grad(loss_t, list(params.values()))
        with torch.no_grad():
            params = {k: (p - 0.2 * g).detach()
                      for (k, p), g in zip(params.items(), grads)}
        loss = float(loss_t)
        if args.status_url:
            req = urllib.request.Request(
                f"{args.status_url}/statetracker/heartbeat",
                data=json.dumps({"worker": "w0",
                                 "meta": {"step": i}}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=10).read()
        mgr.maybe_save(i, params, {"loss": loss})
        print(f"STEP={i}", flush=True)
        if i == args.signal_at:
            Path(args.signal_file).write_text(str(i))
            while True:  # killed here
                time.sleep(60)
    if args.final:
        np.savez(args.final, **{k: v.numpy() for k, v in params.items()})
    print(f"LOSS={loss:.10f}", flush=True)
    return 0


def _spawn(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.Popen([sys.executable, __file__, *map(str, argv)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=str(ROOT))


def test_kill_restart_resumes_losslessly(tmp_path):
    from deeplearning4j_tpu_torch.parallel.cluster import ClusterService

    svc = ClusterService(evict_after=2.0)
    port = svc.start_rest_api(0)
    ckpt, flag = tmp_path / "ckpt", tmp_path / "at_kill_step"
    p1 = _spawn(ckpt, "--status-url", f"http://127.0.0.1:{port}",
                "--signal-at", KILL_AT, "--signal-file", flag)
    try:
        deadline = time.monotonic() + 120
        while not flag.exists():
            assert time.monotonic() < deadline, "no checkpoint at KILL_AT"
            assert p1.poll() is None, p1.communicate()[0][-3000:]
            time.sleep(0.02)
        assert (ckpt / f"ckpt_{KILL_AT}.npz").is_file()
        p1.send_signal(signal.SIGKILL)
        p1.wait(timeout=30)
        assert p1.returncode == -signal.SIGKILL
        assert svc.workers() == ["w0"]
        assert svc._workers["w0"].meta == {"step": KILL_AT}
        time.sleep(2.2)  # silent past evict_after
        assert svc.evict_stale() == ["w0"]
        assert svc.workers() == []
    finally:
        if p1.poll() is None:
            p1.kill()
        p1.communicate()
        svc.stop_rest_api()

    rec = tmp_path / "recovered.npz"
    p2 = _spawn(ckpt, "--final", rec)
    out2 = p2.communicate(timeout=120)[0]
    assert p2.returncode == 0, out2[-3000:]
    assert f"RESUMED_FROM={KILL_AT}" in out2.splitlines()
    ref = tmp_path / "uninterrupted.npz"
    p3 = _spawn(tmp_path / "ckpt_ref", "--final", ref)
    out3 = p3.communicate(timeout=120)[0]
    assert p3.returncode == 0, out3[-3000:]
    with np.load(rec) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files) == ["b1", "b2", "w1", "w2"]
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


if __name__ == "__main__":
    sys.exit(_worker())
