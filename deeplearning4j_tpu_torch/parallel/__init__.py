"""Parallel support of the port:

- ``mesh``: the device meshes (the serving model axis; the ``(data,
  model)`` training mesh, ``hybrid_mesh`` and a data axis across
  processes, whose gradient bucket ``all_reduce_mean`` averages);
- ``expert_parallel``: MoE routing and the expert FFNs;
- ``sequence_parallel``: ring attention over the data axis and the
  sequence-sharded LSTM;
- ``data_parallel``: ``DataParallelTrainer``, the DL4J-era nets' per-step
  gradient averaging over a data axis (across processes too), and
  ``local_sgd_step``/``replica_consensus``;
- ``lockstep``: data ranks in lock-step, ``batch_moments`` (a batch's
  statistics over the data axis);
- ``pipeline_parallel``: the GPipe schedule over a ``pipe`` axis;
- ``tensor_parallel``: the Megatron MLP block over a model axis;
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
    "SGD": "data_parallel",
    "TrainState": "data_parallel",
    "local_sgd_step": "data_parallel",
    "replica_consensus": "data_parallel",
    "batch_moments": "lockstep",
    "run_ranks": "lockstep",
    "DeviceMesh": "mesh",
    "all_reduce_mean": "mesh",
    "data_parallel_mesh": "mesh",
    "dp_mp_mesh": "mesh",
    "hybrid_mesh": "mesh",
    "PIPE_AXIS": "pipeline_parallel",
    "pipeline_apply": "pipeline_parallel",
    "pipeline_mesh": "pipeline_parallel",
    "pipeline_train_step": "pipeline_parallel",
    "split_microbatches": "pipeline_parallel",
    "stack_stage_params": "pipeline_parallel",
    "ring_attention": "sequence_parallel",
    "sequence_sharded_lstm": "sequence_parallel",
    "serving_tp_shardings": "tensor_parallel",
    "shard_dense_params": "tensor_parallel",
    "tp_mlp_block": "tensor_parallel",
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
