"""Checkpoint / resume in the reference's npz format
(``deeplearning4j_tpu/parallel/checkpoint.py``), so either package reads
what the other writes.

A checkpoint is one ``np.savez`` archive: an entry per params leaf under
its key path joined by ``//`` (``blocks//wqkv``, ``embed``, ``head``: the
paths ``jax.tree_util.tree_flatten_with_path`` gives the reference's
params dict; the MoE leaves ``blocks//moe//.wg``, ``.w1``, ..., the keys
the reference's ``MoEParams`` NamedTuple flattens to, whose fields print
with a leading dot), plus ``__manifest__``, a JSON string with ``format``
(``dl4j-tpu-ckpt-v1``), ``time``, ``treedef``, ``meta`` and the sorted
``keys``. The reference writes its ``PyTreeDef`` string as ``treedef``
and never reads it back (``restore`` rebuilds the tree from ``like``);
the port writes a plain description of its nested-dict tree in that
slot. The write is atomic: a temporary file in the target directory,
then ``os.replace``.

Leaves are saved as host arrays, f32 or integer; a bf16 leaf raises
(training params are f32). A leaf laid out on a mesh
(``parallel/mesh.MeshTensor``) is gathered whole first, as the
reference's npz backend saves sharded params whole. ``restore`` returns tensors on the card
unless the caller names another device.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import _leaves, _tree
from deeplearning4j_tpu_torch.parallel.mesh import MeshTensor

SEP = "//"
FORMAT = "dl4j-tpu-ckpt-v1"

#: tree nodes the reference holds as a NamedTuple: their fields' keys
#: print as ``.name`` (``GetAttrKey``)
_NAMEDTUPLE_NODES = frozenset({"moe"})


def _key(path) -> str:
    return SEP.join(f".{k}" if i and path[i - 1] in _NAMEDTUPLE_NODES
                    else k for i, k in enumerate(path))


def _keyed(tree) -> list[tuple[str, tuple, object]]:
    """(key, path, leaf) triples of a nested dict, sorted by path."""
    return [(_key(path), path, leaf)
            for path, leaf in sorted(_leaves(tree), key=lambda kv: kv[0])]


def flat_leaves(tree) -> list[tuple[str, object]]:
    """(key, leaf) pairs of a nested dict in the reference's flattening
    order (sorted keys at every level), each key its path joined by
    ``SEP``; any other value is a leaf."""
    return [(key, leaf) for key, _, leaf in _keyed(tree)]


def _describe(tree) -> str:
    """The tree's structure, leaves as ``*`` (the reference's slot holds
    a ``PyTreeDef`` string here)."""
    if not isinstance(tree, dict):
        return "*"
    return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                           for k in sorted(tree)) + "}"


def _host_array(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, MeshTensor):
        leaf = leaf.whole()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16; save the "
                            f"f32 params (npz has no bfloat16)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str | Path, params, meta: dict | None = None) -> Path:
    """Atomic checkpoint write: the npz of ``params``' leaves and the
    manifest with ``meta``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {key: _host_array(key, leaf)
               for key, leaf in flat_leaves(params)}
    manifest = {
        "format": FORMAT,
        "time": time.time(),
        "treedef": _describe(params),
        "meta": meta or {},
        "keys": sorted(payload),
    }
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __manifest__=json.dumps(manifest), **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _read_manifest(z) -> dict:
    return json.loads(str(z["__manifest__"]))


def restore(path: str | Path, like, device=None):
    """Restore into the structure of ``like``, a nested dict whose leaves
    are tensors or arrays (on any device) or shape tuples. Returns
    ``(params, meta)``, every leaf a tensor on ``device`` (the card unless
    the caller names another) with the checkpoint's dtype. Raises
    ``KeyError`` for a leaf the checkpoint lacks and ``ValueError`` for a
    shape that differs, as the reference does."""
    dev = resolve_device(device)
    pairs = []
    with np.load(path, allow_pickle=False) as z:
        meta = _read_manifest(z)["meta"]
        for key, path, leaf in _keyed(like):
            if key not in z.files:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = z[key]
            if tuple(arr.shape) != _shape(leaf):
                raise ValueError(f"shape mismatch for {key!r}: ckpt "
                                 f"{arr.shape} vs model {_shape(leaf)}")
            pairs.append((path, torch.from_numpy(arr).to(dev)))
    return _tree(pairs), meta


class CheckpointManager:
    """Periodic save with retention: ``ckpt_{step}.npz`` every
    ``save_every`` steps, the newest ``keep`` kept (the reference's
    ``CheckpointManager``). Creates ``directory``."""

    _PAT = re.compile(r"ckpt_(\d+)\.npz$")

    def __init__(self, directory: str | Path, keep: int = 3,
                 save_every: int = 1):
        self.directory = Path(directory)
        self.keep = keep
        self.save_every = save_every
        self.directory.mkdir(parents=True, exist_ok=True)

    def maybe_save(self, step: int, params,
                   meta: dict | None = None) -> Path | None:
        """Save at ``step`` when it is on the cadence (meta gains
        ``step``), then drop all but the newest ``keep``."""
        if step % self.save_every != 0:
            return None
        p = save(self.directory / f"ckpt_{step}.npz", params,
                 {**(meta or {}), "step": step})
        self._gc()
        return p

    def _all_steps(self) -> list[int]:
        steps = []
        for f in self.directory.glob("ckpt_*.npz"):
            m = self._PAT.search(f.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _gc(self) -> None:
        for s in self._all_steps()[:-self.keep]:
            (self.directory / f"ckpt_{s}.npz").unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        steps = self._all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, like, device=None):
        """``(params, meta)`` of the newest checkpoint, or None."""
        s = self.latest_step()
        if s is None:
            return None
        return restore(self.directory / f"ckpt_{s}.npz", like, device)

    def read_meta(self) -> dict | None:
        """The newest checkpoint's meta without a params template, so a
        reader can rebuild the model config before restoring."""
        s = self.latest_step()
        if s is None:
            return None
        with np.load(self.directory / f"ckpt_{s}.npz",
                     allow_pickle=False) as z:
            return _read_manifest(z)["meta"]
