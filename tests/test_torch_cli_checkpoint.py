"""The port's CLI from training to decoding on the CPU: ``train
--checkpoint-dir`` writes npz checkpoints that ``generate`` and ``serve
--checkpoint-dir`` restore, with the reference's printed lines and exit
codes."""

import json
import os
import re
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TRAIN = ["train", "--model", "transformer", "--device", "cpu", "--steps", "4",
         "--seq-len", "32", "--d-model", "32", "--n-layers", "1",
         "--n-heads", "2", "--batch", "4", "--save-every", "2", "--flash"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt") / "run"
    assert cli.main(TRAIN + ["--checkpoint-dir", str(d)]) == 0
    return d


def test_train_writes_checkpoints_with_config(trained):
    assert sorted(p.name for p in trained.iterdir()) == [
        "ckpt_2.npz", "ckpt_4.npz"]
    meta = CheckpointManager(trained).read_meta()
    assert meta["step"] == 4 and isinstance(meta["loss"], float)
    want = cli._cfg_from_args(cli.build_parser().parse_args(TRAIN))
    assert TransformerConfig.from_json(meta["config"]) == want


@pytest.mark.parametrize("extra,lines", [
    ([], [r"restored step 4 from \S+", r"sample: the quick brown "]),
    (["--beam", "2", "--max-new", "6"],
     [r"restored step 4 from \S+", r"beam 0 \(logp -\d+\.\d\d\): the quick",
      r"beam 1 \(logp -\d+\.\d\d\): the quick"]),
    (["--int8", "full", "--temperature", "0"],
     [r"restored step 4 from \S+",
      r"int8 serving mode: full \(weights \+ kv cache\)",
      r"sample: the quick brown "]),
], ids=["sampled", "beam", "int8_full"])
def test_generate_from_checkpoint(trained, capsys, extra, lines):
    rc = cli.main(["generate", "--checkpoint-dir", str(trained),
                   "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert rc == 0
    # a decoded byte stream may hold line breaks of its own
    assert re.fullmatch("\n".join(p + ".*" for p in lines) + "\n", out,
                        re.S), out


def test_generate_beam_scores_are_sorted(trained, capsys):
    assert cli.main(["generate", "--checkpoint-dir", str(trained),
                     "--device", "cpu", "--beam", "3", "--max-new", "5"]) == 0
    scores = [float(m) for m in re.findall(r"logp (-?\d+\.\d+)",
                                           capsys.readouterr().out)]
    assert len(scores) == 3 and scores == sorted(scores, reverse=True)


def test_error_exits(tmp_path, capsys):
    missing = tmp_path / "no" / "such"
    assert cli.main(["generate", "--checkpoint-dir", str(missing),
                     "--device", "cpu"]) == 1
    assert not (tmp_path / "no").exists()
    assert "no checkpoint found in" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["generate", "--checkpoint-dir", str(empty),
                     "--device", "cpu"]) == 1
    # npz across processes: refused before the rendezvous and the mkdir
    assert cli.main(TRAIN + ["--checkpoint-dir", str(tmp_path / "o"),
                             "--coordinator", "127.0.0.1:1",
                             "--num-processes", "2",
                             "--process-id", "0"]) == 2
    assert "orbax" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
    assert cli.main(["serve", "--device", "cpu"]) == 2
    assert "serve needs --checkpoint-dir (or --demo)" in \
        capsys.readouterr().err


def test_serve_checkpoint_answers_a_request(trained):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--checkpoint-dir", str(trained), "--device", "cpu", "--port", "0",
         "--slots", "2", "--temperature", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        seen, addr = [], None
        for line in proc.stdout:
            seen.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                addr = m.group(1)
                break
        assert addr, "".join(seen)
        assert any(line.startswith("restored step 4 from ") for line in seen)
        req = urllib.request.Request(
            addr + "/v1/generate", method="POST",
            data=json.dumps({"prompt": "the quick", "max_new": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200 and len(body["tokens"]) == 9 + 4
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    assert proc.returncode == 0


def test_generate_matches_transformer_generate(trained, capsys):
    """The greedy line is the port's ``transformer_generate`` on the
    restored params."""
    from deeplearning4j_tpu_torch.models.transformer import (
        param_shapes,
        transformer_generate,
    )

    assert cli.main(["generate", "--checkpoint-dir", str(trained),
                     "--device", "cpu", "--temperature", "0",
                     "--max-new", "8"]) == 0
    out = capsys.readouterr().out
    mgr = CheckpointManager(trained)
    cfg = TransformerConfig.from_json(mgr.read_meta()["config"])
    params, _ = mgr.restore_latest(param_shapes(cfg), device="cpu")
    prompt = torch.tensor([list(b"the quick brown ")])
    toks = transformer_generate(cfg)(params, prompt, 8, temperature=0.0)
    assert out.endswith("\nsample: " + bytes(toks[0].tolist()).decode(
        "latin-1") + "\n")
