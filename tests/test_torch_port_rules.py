"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points never fall back to the CPU on their own, and the chip smoke
script stands on the port alone."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    params_from_jax,
)
from deeplearning4j_tpu_torch.models.word2vec import (
    Word2Vec,
    word2vec_state_from_jax,
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
    for cls in (Word2Vec, ParagraphVectors):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(layer_size=8)
        assert cls(layer_size=8, device="cpu").device.type == "cpu"
    tables = [np.zeros((3, 4), np.float32)] * 3
    with pytest.raises(RuntimeError, match="CUDA"):
        word2vec_state_from_jax(*tables)
    assert word2vec_state_from_jax(*tables, device="cpu")["syn0"].shape == (
        3, 4)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper, never to the plain version:
    with the wrapper's launch replaced, the dispatcher must call it (the
    decode kernel in its bf16 and int8 modes, the paged decode kernel, the
    fused embedding dot in its dense and fused modes)."""
    from deeplearning4j_tpu_torch.ops import emb_dot
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    calls = []
    monkeypatch.setattr(fa, "_launch", lambda *a: calls.append("fa"))
    monkeypatch.setattr(fa, "_launch_bwd", lambda *a: calls.append("fa_bwd"))
    monkeypatch.setattr(fd, "_launch", lambda *a: calls.append(
        "fd" if a[-1] is None else "fd_int8"))
    monkeypatch.setattr(fd, "_launch_paged", lambda *a: calls.append(
        "fd_paged" if a[-1] is None else "fd_paged_int8"))
    monkeypatch.setattr(emb_dot, "_launch",
                        lambda *a: (calls.append("emb_dot"), None))
    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    monkeypatch.setattr(fd, "flash_decode_attention_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    monkeypatch.setattr(fd, "flash_decode_attention_paged_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    monkeypatch.setattr(emb_dot, "_launch_hs",
                        lambda *a: calls.append("emb_dot_hs"))
    monkeypatch.setattr(emb_dot, "fused_embedding_dot_range_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    monkeypatch.setattr(emb_dot, "fused_hs_rows_plain",
                        lambda *a: pytest.fail("plain path on CUDA"))
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(q, q, q, True)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(q, q, q, q, q, q, True)
    with pytest.raises(ValueError, match="unsupported device"):
        fd.flash_decode_attention_paged(q, q, q, 0, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        emb_dot.fused_embedding_dot(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        emb_dot.fused_hs_rows(q, 0, q, q, q, q, 0.1)

    class FakeCuda:
        device = torch.device("cuda", 0)

    fa.flash_attention_fwd(FakeCuda(), None, None, True)
    fa.flash_attention_bwd(FakeCuda(), None, None, None, None, None, True)
    fd.flash_decode_attention(FakeCuda(), None, 0, 1)
    fd.flash_decode_attention(FakeCuda(), None, 0, 1, kv_scales=object())
    fd.flash_decode_attention_paged(FakeCuda(), None, None, 0, 1)
    fd.flash_decode_attention_paged(FakeCuda(), None, None, 0, 1,
                                    block_scales=object())
    emb_dot.fused_embedding_dot(FakeCuda(), None, None)
    emb_dot.fused_embedding_dot_range(FakeCuda(), None, None)
    emb_dot.fused_hs_rows(FakeCuda(), 0, None, None, None, None, 0.1)
    assert calls == ["fa", "fa_bwd", "fd", "fd_int8", "fd_paged",
                     "fd_paged_int8", "emb_dot", "emb_dot", "emb_dot_hs"]


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


# -- the flash kernels' sources ------------------------------------------------

_FLASH = {"flash_attn_fwd": "flash_fwd", "flash_attn_bwd": "flash_bwd"}
#: every source whose kernels' names a profile script groups by substring
#: (scripts/torch_train_profile.py, scripts/torch_serve_profile.py:38)
_NAMED = {**_FLASH, "flash_decode": "flash_decode"}


def _with_headers(stem: str) -> str:
    """A kernel source and every local header it includes."""
    csrc = PKG / "csrc"
    text = (csrc / f"{stem}.cu").read_text()
    for hdr in re.findall(r'#include "([^"]+)"', text):
        text += (csrc / hdr).read_text()
    return text


@pytest.mark.parametrize("stem", sorted(_FLASH))
def test_flash_bf16_bodies_issue_tensor_core_instructions(stem):
    """The bf16 bodies at D 64 and 128 multiply on the tensor cores: the
    static (dtype, D) table picks them, each product goes through a wgmma
    wrapper, and the wrappers are wgmma (or mma.sync) instructions."""
    src = (PKG / "csrc" / f"{stem}.cu").read_text()
    table = re.search(r"Body body_of\(int dtype, int d\) \{(.*?)\n\}", src,
                      re.S)
    assert table and "kBF16" in table.group(1) and "d == 64" in table.group(1)
    assert "d == 128" in table.group(1) and "kWgmma" in table.group(1)
    wgmma_kernels = re.findall(r"(\w+_wgmma_kernel)\(", src)
    assert wgmma_kernels, "no tensor-core body"
    assert re.search(r"\bwgmma_(ss|rs_tb)<", src)
    full = _with_headers(stem)
    assert "wgmma.mma_async" in full or "mma.sync" in full
    assert f"extern \"C\" int dl4j_{stem}_body(" in src


@pytest.mark.parametrize("stem", sorted(_NAMED))
def test_flash_sources_have_no_float_atomics(stem):
    """The backward's determinism (remat on vs off bitwise equal) and the
    decode kernels' (paged bitwise slab, B 1 bitwise B 8) rest on every sum
    running in one thread, or across a cluster in rank order, in a fixed
    order: no float atomics and no bulk reductions into global memory, in
    the source or its headers."""
    full = _with_headers(stem)
    for banned in ("atomicAdd", "red.global", "red.add", "cp.reduce.async",
                   "atom.global.add"):
        assert banned not in full, banned


@pytest.mark.parametrize("stem", sorted(_NAMED))
def test_flash_kernel_symbols_keep_their_names(stem):
    """scripts/torch_train_profile.py and scripts/torch_serve_profile.py
    group device time by these substrings of the kernels' names."""
    src = (PKG / "csrc" / f"{stem}.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", src)
    assert len(names) >= 2
    assert len(names) == src.count("__global__"), names
    assert all(_NAMED[stem] in n for n in names), names
