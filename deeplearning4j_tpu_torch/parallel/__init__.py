"""Parallel support of the port:

- ``mesh``: the device meshes (the serving model axis; the ``(data,
  model)`` training mesh, ``hybrid_mesh`` and a data axis across
  processes, whose gradient bucket ``all_reduce_mean`` averages);
- ``expert_parallel``: MoE routing and the expert FFNs;
- ``sequence_parallel``: ring attention over the data axis;
- ``data_parallel``: ``DataParallelTrainer``, the DL4J-era nets' per-step
  gradient averaging over a data axis;
- ``checkpoint``: npz checkpoints (both packages' format) and
  ``AsyncShardedCheckpointManager`` on ``torch.distributed.checkpoint``;
- ``cluster``: ``ClusterService`` (heartbeats, eviction, early stop, the
  REST status and control), ``FileRegistry``, ``initialize_distributed``;
- ``registry``: ``RegistryServer``, ``NetworkRegistry``, ``RegistryLock``.

``cluster`` and ``registry`` are host code and import no ``torch``; the
names below load their module on first use, so importing this package
loads no tensor library either.
"""

import importlib

_EXPORTS = {
    "AsyncShardedCheckpointManager": "checkpoint",
    "CheckpointManager": "checkpoint",
    "ClusterService": "cluster",
    "FileRegistry": "cluster",
    "WorkerInfo": "cluster",
    "initialize_distributed": "cluster",
    "DataParallelTrainer": "data_parallel",
    "DeviceMesh": "mesh",
    "all_reduce_mean": "mesh",
    "data_parallel_mesh": "mesh",
    "dp_mp_mesh": "mesh",
    "hybrid_mesh": "mesh",
    "LeaseLostError": "registry",
    "NetworkRegistry": "registry",
    "RegistryLock": "registry",
    "RegistryServer": "registry",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
