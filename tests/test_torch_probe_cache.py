"""Persisted parity-probe verdicts (``serving/probe_cache.py`` and the
engine's ``_probe_verdict``).

- A second engine on the same verdict file runs no probe, for every probe
  the port has (paged, LoRA zero, masked, prefix reuse, batched admission,
  chunked replay), and serves the same streams.
- The key names what produced a verdict: the probe's geometry, the device
  (type, name, compute capability), torch and its CUDA version, and a
  digest of the kernel sources. A CPU verdict never vouches for a card and
  no verdict outlives an edit of a kernel source.
- The file is the reference's format; a corrupt one reads as empty (the
  reference's ``test_probe_cache_tolerates_corrupt_file`` and the file half
  of ``test_probe_cache_key_separates_geometry``).
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.probe_cache import ProbeCache as JProbeCache
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.serving import (
    FaultInjector,
    Request,
    ServingEngine,
)
from deeplearning4j_tpu_torch.serving import probe_cache as pc
from deeplearning4j_tpu_torch.serving.probe_cache import ProbeCache, probe_key

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

CFG = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                           n_layers=2, d_ff=64, max_len=48)


@pytest.fixture(scope="module")
def params():
    return pt.init_params(CFG, seed=0, device="cpu")


def _engine(params, path, **kw):
    kw.setdefault("temperature", 0.0)
    return ServingEngine(CFG, params, n_slots=2, device="cpu",
                         probe_cache=str(path), prefill_max_bucket=8,
                         retry_backoff_s=0.001, max_backoff_s=0.004, **kw)


def _traffic():
    """Two same-bucket misses (admitted together: a batched group), then a
    16-token prefix and two prompts extending it (partial hits): with the
    crash the slab configuration injects, every lazy probe runs."""
    a = np.arange(1, 17, dtype=np.int32)
    return ([Request(prompt=np.arange(20 + i, 26 + i, dtype=np.int32),
                     max_new=4) for i in range(2)]
            + [Request(prompt=a.copy(), max_new=3)]
            + [Request(prompt=np.concatenate([a, [40 + i]]), max_new=4)
               for i in range(2)])


def _serve(engine):
    out = []
    for r in _traffic():
        engine.submit(r)
        out.append(r)
    res = engine.run()
    return [np.asarray(res[r.id]) for r in out]


#: the two configurations that between them run every probe the port has
#: (the slab one also takes a LoRA bank and a crash at step 3)
CONFIGS = {
    "slab": dict(prefix_cache=True, sampling_surface=True),
    "paged": dict(paged=True, block_size=8),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_second_engine_runs_no_probe(params, tmp_path, config):
    """The first engine runs its probes and persists the verdicts; a
    second one on the same file reads every verdict (``probes_run`` stays
    empty) and serves byte-identical streams."""
    kw = dict(CONFIGS[config])
    if config == "slab":
        kw["lora_bank"] = pt.init_lora_bank(threefry.key(0), CFG, 2, 2,
                                            device="cpu")
    path = tmp_path / "probes.json"
    streams, engines = [], []
    for _ in range(2):
        faults = (FaultInjector().plan("step", 3, "crash")
                  if config == "slab" else None)
        eng = _engine(params, path, faults=faults, **kw)
        streams.append(_serve(eng))
        engines.append(eng)
    first, second = engines
    want = {"slab": {"lora_zero", "masked_parity", "prefix_reuse",
                     "batch_admission", "chunked_replay"},
            "paged": {"paged_parity"}}[config]
    assert set(first.probes_run) == want and not first.probes_from_cache
    assert second.probes_run == []
    assert sorted(second.probes_from_cache) == sorted(first.probes_run)
    if config == "slab":
        assert first.metrics.n_restarts == second.metrics.n_restarts == 1
        assert second.metrics.n_batched_admissions > 0
        assert second._surface and second.n_adapters == 2
    else:
        assert second._paged
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)
    # one verdict a probe run (the batch probe's, one a geometry)
    assert len(json.loads(path.read_text())) == len(first.probes_run)


def test_key_separates_geometry_device_and_sources(monkeypatch):
    """Verdicts are keyed by the geometry AND the stack: another slot
    count, another card, the CPU against a card, another torch or CUDA
    version, or an edited kernel source never reuses a verdict."""
    cfg = CFG.to_json()
    k = probe_key("batch_admission", cfg, device="cpu", n_slots=2)
    assert k == probe_key("batch_admission", cfg, device="cpu", n_slots=2)
    assert k != probe_key("batch_admission", cfg, device="cpu", n_slots=4)
    assert k != probe_key("prefix_reuse", cfg, device="cpu", n_slots=2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (9, 0))
    h100 = probe_key("batch_admission", cfg, device="cuda", n_slots=2)
    assert h100 != k
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (8, 0))
    assert probe_key("batch_admission", cfg, device="cuda",
                     n_slots=2) not in (h100, k)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (9, 0))
    assert probe_key("batch_admission", cfg, device="cuda",
                     n_slots=2) == h100
    monkeypatch.setattr(torch.version, "cuda", "0.0")
    assert probe_key("batch_admission", cfg, device="cuda",
                     n_slots=2) != h100
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert probe_key("batch_admission", cfg, device="cpu",
                     n_slots=2) != k
    monkeypatch.undo()
    assert probe_key("batch_admission", cfg, device="cpu", n_slots=2) == k
    monkeypatch.setattr(pc, "_sources_digest", lambda: "edited")
    assert probe_key("batch_admission", cfg, device="cpu", n_slots=2) != k


def test_sources_digest_covers_every_kernel_source():
    """The digest reads every ``csrc`` source and header the builder
    compiles, so an edit of any of them changes it."""
    from deeplearning4j_tpu_torch.ops import _build

    names = {p.name for p in (_build.CSRC.glob("*.cu"))}
    assert names >= {"flash_attn_fwd.cu", "flash_attn_bwd.cu",
                     "flash_decode.cu", "emb_dot.cu", "sample.cu"}
    assert len(pc._sources_digest()) == 64
    assert pc.stack_identity("cpu")["sources"] == pc._sources_digest()


def test_edited_source_reprobes(params, tmp_path, monkeypatch):
    """A verdict from before a kernel-source edit misses: the engine
    probes again and adds the new verdict beside the old."""
    path = tmp_path / "probes.json"
    first = _engine(params, path, paged=True, block_size=8)
    assert first.probes_run == ["paged_parity"]
    monkeypatch.setattr(pc, "_sources_digest", lambda: "edited")
    again = _engine(params, path, paged=True, block_size=8)
    assert again.probes_run == ["paged_parity"]
    assert not again.probes_from_cache
    assert len(json.loads(path.read_text())) == 2


def test_probe_cache_key_separates_geometry_file(tmp_path):
    """The file half of the reference's key-separation test: verdicts
    round-trip through the file, an unknown key reads None."""
    k1 = probe_key("paged_parity", CFG.to_json(), device="cpu", tp=1,
                   max_total=32)
    k2 = probe_key("paged_parity", CFG.to_json(), device="cpu", tp=1,
                   max_total=64)
    k3 = probe_key("paged_parity", CFG.to_json(), device="cpu", tp=2,
                   max_total=32)
    assert len({k1, k2, k3}) == 3
    cache = ProbeCache(str(tmp_path / "p.json"))
    cache.put(k1, True)
    cache.put(k2, False)
    again = ProbeCache(str(tmp_path / "p.json"))
    assert again.get(k1) is True and again.get(k2) is False
    assert again.get(k3) is None


def test_probe_cache_tolerates_corrupt_file(tmp_path):
    """The reference's ``test_probe_cache_tolerates_corrupt_file``, on
    the port's cache and on the reference's, with the same outcome."""
    for cls in (ProbeCache, JProbeCache):
        path = tmp_path / f"{cls.__module__}.json"
        path.write_text("{not json")
        cache = cls(str(path))
        assert cache.get("anything") is None
        cache.put("k", True)
        assert cls(str(path)).get("k") is True
        assert json.loads(path.read_text()) == {"k": True}


def test_file_format_is_the_references(tmp_path):
    """Both packages write and read one format: a flat JSON object of
    digests to booleans, sorted; a file either writes, the other reads."""
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    for path, cls in ((a, ProbeCache), (b, JProbeCache)):
        cache = cls(str(path))
        cache.put("k2", False)
        cache.put("k1", True)
    assert a.read_text() == b.read_text()
    assert ProbeCache(str(b)).get("k1") is True
    assert JProbeCache(str(a)).get("k2") is False
