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

:class:`AsyncShardedCheckpointManager` is the reference's orbax-backed
manager of the same name on ``torch.distributed.checkpoint`` (DCP): each
process writes only the parts its ranks hold, off the training thread,
and a restore lays the values out on the caller's layout, which may
differ from the writer's (2 processes write, 1 restores). Its format is
not the reference's orbax format; npz stays the format both packages
read.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import _leaves, _tree
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
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


#: the sharded format's name, in every manifest
SHARDED_FORMAT = "dl4j-tpu-torch-dcp-v1"
_MANIFEST = "manifest.json"


def _part_key(key: str, i: int, j: int) -> str:
    """The DCP key of a leaf's part: data part ``i``, model part ``j`` (0
    along an axis the leaf's spec does not split)."""
    return f"{key}[{i},{j}]"


def _dist_group():
    """``(process group for the writes, rank)``: a gloo group of its own
    (the background write's collectives must not interleave with the
    training step's on the default group), or ``(None, 0)`` in one
    process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None, 0
    return dist.new_group(backend="gloo"), dist.get_rank()


def _global_parts(leaf: MeshTensor) -> dict[tuple[int, int], list[int]]:
    """Every global part's shape, by its global (data, model) index: the
    ``torch.tensor_split`` pieces of the leaf's shape, whichever process
    holds them."""
    cd, cm = leaf.counts()
    dd = leaf.dim_of(mesh_lib.DATA_AXIS)
    md = leaf.dim_of(mesh_lib.MODEL_AXIS)
    rows = leaf.sizes(mesh_lib.DATA_AXIS) if dd is not None else [None]
    cols = leaf.sizes(mesh_lib.MODEL_AXIS) if md is not None else [None]
    out = {}
    for i in range(cd):
        for j in range(cm):
            shape = list(leaf.shape)
            if dd is not None:
                shape[dd] = rows[i]
            if md is not None:
                shape[md] = cols[j]
            out[i, j] = shape
    return out


def _staged(params):
    """This process's parts as host copies under their global keys, and
    the manifest's entry of every leaf (shape, dtype, spec, the global
    part count along each split axis, every global part's key and shape,
    whichever process holds it). Copied before the call returns, so
    training may update the params in place while the write runs."""
    state, leaves = {}, {}
    for key, leaf in flat_leaves(params):
        if not isinstance(leaf, MeshTensor):
            state[_part_key(key, 0, 0)] = leaf.detach().to("cpu", copy=True)
            leaves[key] = {
                "shape": list(leaf.shape), "dtype": str(leaf.dtype),
                "spec": [None] * leaf.dim(), "dims": [1, 1],
                "parts": {_part_key(key, 0, 0): list(leaf.shape)}}
            continue
        for i, row in enumerate(leaf.parts):
            for j, part in enumerate(row):
                state[_part_key(key, *leaf.index(i, j))] = (
                    part.detach().to("cpu", copy=True))
        leaves[key] = {
            "shape": list(leaf.shape), "dtype": str(leaf.parts[0][0].dtype),
            "spec": list(leaf.spec), "dims": list(leaf.counts()),
            "parts": {_part_key(key, i, j): shape for (i, j), shape in
                      _global_parts(leaf).items()},
        }
    return state, leaves


def _assemble(entry: dict, loaded: dict) -> torch.Tensor:
    """A leaf whole from its loaded parts: the model parts of each data
    part concatenated on the model-split dim, then the data parts on the
    data-split dim (exact concatenations)."""
    spec = entry["spec"]
    dd = (spec.index(mesh_lib.DATA_AXIS) if mesh_lib.DATA_AXIS in spec
          else None)
    md = (spec.index(mesh_lib.MODEL_AXIS) if mesh_lib.MODEL_AXIS in spec
          else None)
    nd, nm = entry["dims"]
    rows = []
    for i in range(nd):
        cols = [loaded[_part_key(entry["key"], i, j)] for j in range(nm)]
        rows.append(torch.cat(cols, dim=md) if md is not None else cols[0])
    return torch.cat(rows, dim=dd) if dd is not None else rows[0]


class AsyncShardedCheckpointManager:
    """The reference's ``AsyncShardedCheckpointManager`` (its
    parallel/checkpoint.py:143) on ``torch.distributed.checkpoint``:
    checkpoint ``step`` is the directory ``<directory>/<step>``, a DCP
    checkpoint of every process's parts of a laid-out tree
    (``parallel/mesh.MeshTensor`` leaves; a whole tensor is one part)
    under keys that name the global part (``blocks//wqkv[0,1]``: data part
    0, model part 1), so a part held by several processes (a leaf the
    data axis does not split, across processes of a data column) is
    written once and each process writes only the parts it holds (a
    model axis across processes, ZeRO-3's shards), plus
    ``manifest.json`` (process 0 writes it last: a step without one is not
    a checkpoint), holding each leaf's shape, dtype, spec and part counts
    and the meta.

    The contract is the reference's: ``maybe_save`` queues the write on a
    background thread on the ``save_every`` cadence and returns whether it
    did (one write in flight: a new save waits for the last); ``wait()``
    returns once the queued write is durable and the newest ``keep``
    checkpoints are kept; ``close()`` waits too. ``restore_latest(like)``
    lays the values out as ``like``'s leaves are (a MeshTensor's mesh and
    spec, whatever the writer's; a tensor's device; a shape tuple on
    ``device``), as the reference restores onto the live shardings.
    Every process of a multi-process run constructs the manager (it makes
    a gloo process group for the writes) and calls ``maybe_save`` at the
    same steps."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 save_every: int = 1):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.save_every = save_every
        self._group, self._rank = _dist_group()
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None

    def maybe_save(self, step: int, params, meta: dict | None = None
                   ) -> bool:
        """Queue an async save of ``params`` at ``step`` (meta gains
        ``step``); False when the cadence skips it."""
        if step % self.save_every != 0:
            return False
        self.wait()
        state, leaves = _staged(params)
        manifest = {"format": SHARDED_FORMAT, "time": time.time(),
                    "step": step, "meta": {**(meta or {}), "step": step},
                    "leaves": leaves}
        self._pending = self._pool.submit(
            self._write, self.directory / str(step), state, manifest)
        return True

    def _write(self, path: Path, state: dict, manifest: dict) -> None:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        if self._rank == 0:
            shutil.rmtree(path, ignore_errors=True)
        if self._group is not None:
            dist.barrier(group=self._group)
        with warnings.catch_warnings():
            # one process: no_dist=True is the intent
            warnings.simplefilter("ignore", UserWarning)
            dcp.save(state, storage_writer=dcp.FileSystemWriter(path),
                     process_group=self._group, no_dist=self._group is None)
        if self._rank == 0:
            fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, path / _MANIFEST)
        if self._group is not None:
            dist.barrier(group=self._group)

    def wait(self) -> None:
        """Block until the queued save is durable, then keep the newest
        ``keep`` checkpoints."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        pending.result()
        if self._rank == 0:
            for s in self._all_steps()[:-self.keep]:
                shutil.rmtree(self.directory / str(s), ignore_errors=True)

    def _all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _MANIFEST).is_file())

    def latest_step(self) -> int | None:
        steps = self._all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        with open(self.directory / str(step) / _MANIFEST) as f:
            return json.load(f)

    def read_meta(self) -> dict | None:
        """The newest checkpoint's meta, without a params template."""
        s = self.latest_step()
        return None if s is None else self._manifest(s)["meta"]

    def restore_latest(self, like, device=None):
        """``(params, meta)`` of the newest checkpoint laid out like
        ``like`` (see the class doc), or None. ``KeyError`` for a leaf the
        checkpoint lacks, ``ValueError`` for a shape that differs."""
        import torch.distributed.checkpoint as dcp

        s = self.latest_step()
        if s is None:
            return None
        manifest = self._manifest(s)
        entries = manifest["leaves"]
        state = {}
        order = [(_key(path), path, leaf) for path, leaf in _leaves(like)]
        for key, _, leaf in order:
            if key not in entries:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            e = entries[key]
            if tuple(e["shape"]) != _shape(leaf):
                raise ValueError(f"shape mismatch for {key!r}: ckpt "
                                 f"{tuple(e['shape'])} vs model "
                                 f"{_shape(leaf)}")
            dtype = getattr(torch, e["dtype"].removeprefix("torch."))
            for pk, shape in e["parts"].items():
                state[pk] = torch.empty(shape, dtype=dtype)
        with warnings.catch_warnings():
            # no_dist=True is the intent: every process reads the parts it
            # lays out
            warnings.simplefilter("ignore", UserWarning)
            dcp.load(state, storage_reader=dcp.FileSystemReader(
                self.directory / str(s)), no_dist=True)
        pairs = []
        for key, path, leaf in order:
            whole = _assemble({**entries[key], "key": key}, state)
            if isinstance(leaf, MeshTensor):
                mt = mesh_lib.place(leaf.mesh,
                                    whole.to(leaf.mesh.devices[0]),
                                    leaf.spec)
                out = mt.like(p.clone(memory_format=torch.contiguous_format)
                              for p in mt.flat())
            elif isinstance(leaf, torch.Tensor):
                out = whole.to(leaf.device)
            else:
                out = whole.to(resolve_device(device))
            pairs.append((path, out))
        return _tree(pairs), manifest["meta"]

    def close(self) -> None:
        """Wait for the queued save, then stop the writer thread."""
        self.wait()
        self._pool.shutdown()
