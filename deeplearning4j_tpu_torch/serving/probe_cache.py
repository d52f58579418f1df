"""On-disk cache of parity-probe verdicts (the port's own copy of
``deeplearning4j_tpu/serving/probe_cache.py``).

The engine gates every fast path (paged decode, batched LoRA, the sampling
surface, prefix-cache reuse, batched admission, chunked crash replay)
behind a one-time bitwise parity probe. A verdict is a pure function of
(probe, model config, the stack that ran it, program geometry), so a
verdict computed once holds for every later engine on the same machine.
This module persists them, keyed by a digest of exactly those inputs, so
repeated engine construction (restarts, replicas, tests) skips the probe
dispatches.

The stack that produced a verdict is, on this port: PyTorch's version and
its CUDA version, the device type and, on a card, its name and compute
capability, and a digest of the kernel sources the port compiles
(``csrc/*.cu`` and ``*.cuh``). A CPU verdict never vouches for a card, a
verdict from one card never for another, and no verdict outlives an edit
of a kernel source.

The file is a flat JSON object ``{digest: bool}``. Writes go through a
same-directory temp file and ``os.replace``, so concurrent engines never
read a torn file; a corrupt or unreadable file reads as an empty cache
(the probe just runs again). Losing a race between two writers drops at
most the other writer's fresh verdicts for this process.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path


def _sources_digest() -> str:
    """sha256 over the kernel sources ``ops/_build.py`` compiles, by
    name and content."""
    csrc = Path(__file__).resolve().parent.parent / "csrc"
    h = hashlib.sha256()
    for p in sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def stack_identity(device) -> dict:
    """What produced a verdict on ``device``: torch and its CUDA
    version, the device type, on a card its name and compute capability,
    and the kernel sources' digest."""
    import torch

    device = torch.device(device)
    out = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_type": device.type,
        "sources": _sources_digest(),
    }
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
        out["capability"] = list(torch.cuda.get_device_capability(device))
    return out


def probe_key(probe: str, cfg_json: str, device="cpu", **geometry) -> str:
    """Stable digest for one probe verdict: the probe name, the full model
    config JSON, the stack on ``device`` (:func:`stack_identity`) and the
    program-geometry knobs the probe's programs depend on (bucket sizes,
    slot counts, ...)."""
    payload = {
        "probe": probe,
        "cfg": cfg_json,
        "stack": stack_identity(device),
        **{k: geometry[k] for k in sorted(geometry)},
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class ProbeCache:
    """Read-through/write-through verdict store over one JSON file."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._verdicts: dict[str, bool] = self._load()

    def _load(self) -> dict[str, bool]:
        try:
            with open(self.path) as f:
                data = json.load(f)
            return {
                k: bool(v) for k, v in data.items()
                if isinstance(k, str) and isinstance(v, bool)
            }
        except (OSError, ValueError):
            return {}

    def get(self, key: str) -> bool | None:
        """The persisted verdict, or None if never computed."""
        return self._verdicts.get(key)

    def put(self, key: str, verdict: bool) -> None:
        """Persist one verdict (atomic re-write of the whole file,
        merged over whatever is on disk right now)."""
        merged = self._load()
        merged.update(self._verdicts)
        merged[key] = bool(verdict)
        self._verdicts = merged
        d = os.path.dirname(self.path) or "."
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(merged, f, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                os.unlink(tmp)
                raise
        except OSError:
            # persistence is best-effort: an unwritable path costs a
            # re-probe next process, never a serving failure
            pass
