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
    init_lora_bank,
    init_params,
    lora_bank_from_jax,
    params_from_jax,
    transformer_beam_search,
    transformer_speculative_generate,
)
from deeplearning4j_tpu_torch.models.word2vec import (
    Word2Vec,
    word2vec_state_from_jax,
)
from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.serving import ServingEngine

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

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
    assert n_modules >= 48


_FLEET = ("serving.disagg", "serving.rpc", "serving.netfaults",
          "serving.router", "serving.controller", "utils.httpjson",
          "parallel.cluster", "parallel.registry")

_IMPORT_FLEET = """
import importlib, sys
for n in sys.argv[1:]:
    importlib.import_module("deeplearning4j_tpu_torch." + n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                    "deeplearning4j_tpu"))
print(bad)
assert not bad, bad
"""


def test_fleet_modules_import_no_torch_in_a_fresh_process():
    """The KV wire, the RPC primitives, the chaos proxy, the router, the
    controller, the cluster service and the network registry (the port's
    own copies of the reference's stdlib modules) load no model stack: no
    ``torch``, no JAX, nothing of the JAX package, and so does the CLI
    module their commands run from."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _IMPORT_FLEET, *_FLEET,
                          "cli"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    for rel in _FLEET:
        path = PKG / (rel.replace(".", "/") + ".py")
        assert path in set(PKG.rglob("*.py")), rel


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


def test_tenancy_and_lora_follow_the_rules(monkeypatch):
    """``serving/tenancy.py`` is the port's own copy of the reference's
    module (no JAX and nothing of the JAX package, so it is among the
    files checked above), and the LoRA bank's entry points run on the card
    unless the caller names the CPU."""
    path = PKG / "serving" / "tenancy.py"
    assert path in set(PKG.rglob("*.py"))
    assert not _imported_roots(path) & {"jax", "jaxlib",
                                        "deeplearning4j_tpu"}
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=16)
    bank = init_lora_bank(0, cfg, 2, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lora_bank(0, cfg, 2, 2)
    np_bank = {k: v.numpy() for k, v in bank.items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        lora_bank_from_jax(np_bank, cfg)
    assert lora_bank_from_jax(np_bank, cfg, device="cpu")["a_q"].shape == (
        1, 2, 16, 2)


def test_observability_and_embeddings_follow_the_rules(monkeypatch):
    """The port's own copies of the reference's ``obs/`` modules and
    ``serving/probe_cache.py`` (stdlib and numpy in the reference, JAX-free
    here too; each is among the files checked above), and the new entry
    points run on the card unless the caller names the CPU: the
    ``/v1/embeddings`` demo model and an engine serving embeddings."""
    for rel in ("obs/trace.py", "obs/flight.py", "obs/logs.py",
                "obs/profiler.py", "obs/collect.py",
                "serving/probe_cache.py"):
        path = PKG / rel
        assert path in set(PKG.rglob("*.py")), rel
        assert not _imported_roots(path) & {"jax", "jaxlib",
                                            "deeplearning4j_tpu"}, rel
    from deeplearning4j_tpu_torch import cli

    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=16)
    params = init_params(cfg, seed=0, device="cpu")
    emb = cli._demo_embedders(["word2vec"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli._demo_embedders(["word2vec"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, n_slots=1, embedders=emb,
                      batch_admission=True, adaptive_horizon=True)
    assert ServingEngine(cfg, params, n_slots=1, embedders=emb,
                         device="cpu").device.type == "cpu"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
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
    # checkpoints restore onto the card unless the caller names the CPU
    mgr = CheckpointManager(tmp_path)
    mgr.maybe_save(1, params)
    for restore in (lambda: ckpt.restore(tmp_path / "ckpt_1.npz", params),
                    lambda: mgr.restore_latest(params)):
        with pytest.raises(RuntimeError, match="CUDA"):
            restore()
    assert mgr.restore_latest(params, device="cpu")[0]["head"].shape == (
        16, 32)
    # beam search and speculative decoding run where the params live, so
    # the card is required where params are made (init_params, restore,
    # params_from_jax, above); with the CPU's params they run on the CPU
    prompt = torch.zeros((1, 3), dtype=torch.long)
    toks, _ = transformer_beam_search(cfg)(params, prompt, 2, 2)
    assert toks.device.type == "cpu" and toks.shape == (1, 2, 5)
    toks = transformer_speculative_generate(cfg)(params, params, prompt, 2,
                                                 temperature=0.0)
    assert toks.device.type == "cpu" and toks.shape == (1, 5)
    # the DL4J-era core: the network, LeNet, the carried params, a layer's
    # init, the data-parallel trainer and train --model lenet
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models import lenet, multilayer
    from deeplearning4j_tpu_torch.nn import layers
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        DataParallelTrainer,
    )

    conf = lenet.lenet_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        multilayer.MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="CUDA"):
        lenet.build_lenet()
    net, lp = lenet.build_lenet(device="cpu")
    assert net.device.type == "cpu" and lp[0]["convweights"].device.type == "cpu"
    np_lp = multilayer.params_to_jax(lp, conf)
    with pytest.raises(RuntimeError, match="CUDA"):
        multilayer.params_from_jax(np_lp, conf)
    with pytest.raises(RuntimeError, match="CUDA"):
        multilayer.MultiLayerNetwork.from_bytes(net.to_bytes())
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.get("dense").init((0, 0), conf.confs[2])
    assert layers.get("dense").init((0, 0), conf.confs[2],
                                    device="cpu")["W"].shape == (256, 120)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataParallelTrainer(lenet.lenet_loss(net))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--model", "lenet", "--examples", "64",
                  "--batch", "32"])


def test_zoo_and_parallel_entry_points_follow_the_rules(monkeypatch):
    """The DL4J nets' parallel modes and the rest of the zoo import no JAX
    in a fresh process, and without a card their entry points raise
    unless the CPU is named."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_MESH, "parallel.lockstep",
         "parallel.data_parallel", "parallel.pipeline_parallel",
         "parallel.tensor_parallel", "parallel.sequence_parallel",
         "models.alexnet", "models.resnet", "models.char_lstm"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models import alexnet, lenet, resnet
    from deeplearning4j_tpu_torch.models.char_lstm import CharLSTM
    from deeplearning4j_tpu_torch.parallel import data_parallel as dpar
    from deeplearning4j_tpu_torch.parallel import pipeline_parallel as pp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = resnet.ResNetConfig(num_classes=2, blocks_per_stage=1,
                              stage_channels=(4,))
    for call in (alexnet.build_alexnet, lambda: resnet.init_resnet(0, cfg),
                 lambda: resnet.resnet_train_step(cfg), CharLSTM,
                 lambda: pp.pipeline_mesh(2),
                 lambda: dpar.local_sgd_step(lambda *a: 0.0),
                 lambda: cli.main(["train", "--model", "alexnet",
                                   "--examples", "64", "--batch", "32"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    net, _ = alexnet.build_alexnet(device="cpu")
    assert net.device.type == "cpu"
    assert resnet.init_resnet(0, cfg, device="cpu")[0]["stem"]["w"].device \
        .type == "cpu"
    assert CharLSTM(device="cpu").device.type == "cpu"
    assert pp.pipeline_mesh(2, devices=["cpu"] * 2).size == 2
    lnet, _ = lenet.build_lenet(device="cpu")
    dpar.local_sgd_step(lenet.lenet_loss(lnet),
                        dpar.mesh_lib.data_parallel_mesh(devices=["cpu"]))


_IMPORT_MESH = """
import importlib, sys
for n in sys.argv[1:]:
    importlib.import_module("deeplearning4j_tpu_torch." + n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
print(bad)
assert not bad, bad
"""


def test_mesh_and_moe_follow_the_rules(monkeypatch, capsys):
    """The expert-parallel, sequence-parallel and mesh modules import no
    JAX in a fresh process; without a card, the mesh and MoE entry points
    raise or exit unless the CPU is named; and on a mesh with ``use_flash``
    every model rank's heads go through the flash kernel's wrapper (which
    launches the kernel on a CUDA tensor), one call a rank and layer."""
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel import expert_parallel as ep
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_MESH, "parallel.expert_parallel",
         "parallel.sequence_parallel", "parallel.mesh", "models.transformer"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 2 devices"):
        mesh_lib.dp_mp_mesh(1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ep.init_moe_params(0, 8, 16, 2)
    model = ["--d-model", "16", "--n-layers", "1", "--n-heads", "2",
             "--seq-len", "16"]
    assert cli.main(["train", "--model", "transformer", "--tp", "2",
                     "--steps", "1", *model]) == 2
    assert "need 2 devices" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--demo", "--n-experts", "2", "--port", "0",
                  *model])
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=4,
                            n_layers=2, d_ff=32, max_len=16, use_flash=True)
    mesh = mesh_lib.dp_mp_mesh(2, 2, ["cpu"] * 4)
    seen = []
    real = pt.flash_attention_trainable

    def spy(q, k, v, causal, layout):
        seen.append(tuple(q.shape))
        return real(q, k, v, causal=causal, layout=layout)

    monkeypatch.setattr(pt, "flash_attention_trainable", spy)
    pt.transformer_loss(cfg, mesh)(pt.init_params(cfg, device="cpu"),
                                   torch.zeros((4, 9), dtype=torch.long))
    assert seen == [(2, 2, 8, 4)] * (2 * 2 * 2)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper, never to the plain version:
    with the wrapper's launch replaced, the dispatcher must call it (the
    decode kernel in its bf16 and int8 modes, the paged decode kernel, the
    fused embedding dot in its dense and fused modes, the threefry draw in
    both of its modes)."""
    from deeplearning4j_tpu_torch.ops import emb_dot
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.ops import threefry

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
    monkeypatch.setattr(threefry, "_launch", lambda *a: (calls.append(
        "draw" if a[-1] is None else "draw_rows"), None))
    monkeypatch.setattr(threefry, "categorical_plain",
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
    with pytest.raises(ValueError, match="unsupported device"):
        threefry.draw(q[0], q)

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
    threefry.draw(FakeCuda(), None)
    threefry.categorical(FakeCuda(), None, object())
    assert calls == ["fa", "fa_bwd", "fd", "fd_int8", "fd_paged",
                     "fd_paged_int8", "emb_dot", "emb_dot", "emb_dot_hs",
                     "draw", "draw_rows"]


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
