"""The trainer's cluster surface through the CLI, on the CPU: ``train
--status-port 0`` with a POSTed minibatch and early stop taking effect in
the live run, ``status --port`` printing its ``/statetracker``, and the
flags that exited 2 before the cluster slice (``--status-port``,
``--coordinator``, ``--checkpoint-backend orbax`` on train, generate and
serve) running.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch import cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODEL = ["--d-model", "32", "--n-layers", "1", "--n-heads", "2",
         "--seq-len", "32"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


class _Lines:
    """A process's output lines, read on a thread; ``wait_for`` blocks
    until a line matches."""

    def __init__(self, proc):
        self.lines, self._cv = [], threading.Condition()
        self._t = threading.Thread(target=self._read, args=(proc,),
                                   daemon=True)
        self._t.start()

    def _read(self, proc):
        for line in proc.stdout:
            with self._cv:
                self.lines.append(line)
                self._cv.notify_all()
        with self._cv:
            self.lines.append(None)
            self._cv.notify_all()

    def wait_for(self, pattern, timeout=120.0):
        with self._cv:
            ok = self._cv.wait_for(lambda: any(
                line is None or re.search(pattern, line)
                for line in self.lines), timeout)
            hit = [line for line in self.lines
                   if line is not None and re.search(pattern, line)]
        assert ok and hit, f"{pattern!r} not printed:\n{''.join(map(str, self.lines))}"
        return re.search(pattern, hit[0])


def test_live_minibatch_earlystop_and_status(capsys):
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
         "--model", "transformer", "--device", "cpu", "--steps", "100000",
         "--batch", "4", *MODEL, "--status-port", "0"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = _Lines(proc)
        base = out.wait_for(r"status REST on (http://\S+/statetracker)"
                            ).group(1)
        port = base.split(":")[2].split("/")[0]
        assert _post(f"{base}/minibatch", {"value": 6}) == {"minibatch": 6}
        out.wait_for(r"^minibatch -> 6 \(REST\)$")
        capsys.readouterr()
        assert cli.main(["status", "--port", port]) == 0
        status = json.loads(capsys.readouterr().out)
        assert status["phase"] == "train" and status["minibatch"] == 6
        assert status["numbatchessofar"] >= 1
        assert _post(f"{base}/earlystop", {}) == {"earlystop": True}
        out.wait_for(r"^early stop triggered$")
        proc.wait(timeout=120)
        assert proc.returncode == 0
        text = "".join(line for line in out.lines if line)
        steps = int(re.findall(r"^step (\d+)/100000 loss", text, re.M)[-1])
        assert steps % 20 == 0 and steps < 100000
        assert "final loss" in text and "sample:" in text
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)


def test_status_port_and_coordinator_run(tmp_path):
    """A one-process ``--coordinator`` run (gloo on the CPU) with the
    status port and sharded checkpoints trains and exits 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
         "--model", "transformer", "--device", "cpu", "--steps", "2",
         "--batch", "4", *MODEL, "--status-port", "0", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0",
         "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-backend",
         "orbax", "--save-every", "2"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^torch\.distributed: process 0 of 1 at tcp://\S+, "
                     r"backend gloo \(processes on the CPU\)$", out.stdout,
                     re.M)
    assert "status REST on http://127.0.0.1:" in out.stdout
    assert "final loss" in out.stdout
    assert (tmp_path / "ck" / "2" / "manifest.json").is_file()


@pytest.fixture(scope="module")
def orbax_ckpt(tmp_path_factory):
    ck = tmp_path_factory.mktemp("orbax") / "ck"
    assert cli.main(["train", "--model", "transformer", "--device", "cpu",
                     "--steps", "2", "--batch", "4", *MODEL,
                     "--checkpoint-dir", str(ck), "--checkpoint-backend",
                     "orbax", "--save-every", "2"]) == 0
    return ck


def test_generate_and_serve_restore_orbax(orbax_ckpt, capsys):
    capsys.readouterr()
    assert cli.main(["generate", "--checkpoint-dir", str(orbax_ckpt),
                     "--checkpoint-backend", "orbax", "--device", "cpu",
                     "--beam", "2", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert f"restored step 2 from {orbax_ckpt}" in out and "beam 1" in out
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--checkpoint-dir", str(orbax_ckpt), "--checkpoint-backend",
         "orbax", "--device", "cpu", "--port", "0", "--slots", "2",
         "--temperature", "0"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = _Lines(proc)
        addr = lines.wait_for(r"serving on (http://\S+)").group(1)
        lines.wait_for(r"^restored step 2 from ")
        req = urllib.request.Request(
            addr + "/v1/generate", method="POST",
            data=json.dumps({"prompt": "the quick", "max_new": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert len(json.loads(resp.read())["tokens"]) == 9 + 3
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    assert proc.returncode == 0


def test_status_needs_a_running_trainer():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(OSError):
        cli.main(["status", "--port", str(port)])
