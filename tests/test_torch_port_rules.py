"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points never fall back to the CPU on their own, and the chip smoke
script stands on the port alone."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    params_from_jax,
)
from deeplearning4j_tpu_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(deeplearning4j_tpu_torch.__file__).resolve().parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [i.name for i in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not i.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "deeplearning4j_tpu" or m.startswith("deeplearning4j_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_in_a_fresh_process():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_statement(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "deeplearning4j_tpu", "optax"}


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no card and no explicit ``device="cpu"``, the entry points
    raise instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, seed=0)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, n_slots=1)
    np_tree = {k: (v.numpy() if isinstance(v, torch.Tensor)
                   else {kk: vv.numpy() for kk, vv in v.items()})
               for k, v in params.items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(np_tree, cfg)
    assert params_from_jax(np_tree, cfg, device="cpu")["head"].shape == (
        16, 32)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper, never to the plain version:
    with the wrapper's launch replaced, the dispatcher must call it."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    calls = []
    monkeypatch.setattr(fa, "_launch", lambda *a: calls.append("fa"))
    monkeypatch.setattr(fa, "_launch_bwd", lambda *a: calls.append("fa_bwd"))
    monkeypatch.setattr(fd, "_launch", lambda *a: calls.append("fd"))
    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    monkeypatch.setattr(fd, "flash_decode_attention_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(q, q, q, True)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(q, q, q, q, q, q, True)

    class FakeCuda:
        device = torch.device("cuda", 0)

    fa.flash_attention_fwd(FakeCuda(), None, None, True)
    fa.flash_attention_bwd(FakeCuda(), None, None, None, None, None, True)
    fd.flash_decode_attention(FakeCuda(), None, 0, 1)
    assert calls == ["fa", "fa_bwd", "fd"]


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py (or on a host without a
    card) the script exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
