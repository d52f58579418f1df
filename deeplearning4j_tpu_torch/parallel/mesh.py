"""The device mesh of the port's tensor-parallel serving (the reference's
``parallel/mesh.py`` model axis, :18-61).

The reference lays one SPMD program over a ``jax.sharding.Mesh`` and lets
GSPMD split it. The port keeps its single controller: one process drives
every shard, so the serving engine's host logic runs once. A :class:`Mesh`
is the tuple of devices on the model axis, rank order; a device may repeat
(``["cpu"] * tp`` in the tests, ``["cuda:0"] * tp`` to run the sharded
programs on one card). A tensor split over the axis is a :class:`Shards`,
its ranks' parts in rank order, each on its rank's device. The one
collective is :meth:`Mesh.gather`, an exact concatenation on the first
device, which counts its calls (``gathers``) so a test can hold a program
to ``tp_collective_contract``.

The data and expert meshes come with training beyond one card.
"""

from __future__ import annotations

import torch

MODEL_AXIS = "model"


class Shards(tuple):
    """One tensor split over a mesh's model axis: the ranks' parts, rank
    order, each on its rank's device."""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"Shards({', '.join(str(tuple(p.shape)) for p in self)})"


def smap(fn, x):
    """``fn`` applied to each part of a :class:`Shards` (a new
    ``Shards``), or to ``x`` itself."""
    if isinstance(x, Shards):
        return Shards(fn(p) for p in x)
    return fn(x)


class Mesh:
    """A 1-D mesh over the model axis: ``devices`` in rank order. The
    replicated activations, weights and decode state live on
    ``devices[0]``."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        #: gathers since construction (or the caller's last reset)
        self.gathers = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    def gather(self, parts, dim: int = -1) -> torch.Tensor:
        """The all-gather of one sharded activation: ``parts`` (rank order)
        concatenated on ``dim`` on the first device. A concatenation moves
        bytes and rounds nothing."""
        self.gathers += 1
        dev = self.devices[0]
        return torch.cat([p.to(dev) for p in parts], dim=dim)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def model_parallel_mesh(tp: int, devices=None) -> Mesh:
    """The serving engine's tensor-parallel geometry: a model-axis mesh of
    ``tp`` ranks. By default the first ``tp`` CUDA cards (``ValueError``
    when fewer are visible, as the reference's ``_mesh_1d``); ``devices``
    names them instead and may repeat one."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise ValueError(f"need {tp} devices for a {MODEL_AXIS!r} mesh, "
                             f"have {have}")
        devices = [f"cuda:{i}" for i in range(tp)]
    devices = list(devices)
    if len(devices) != tp:
        raise ValueError(f"a tp={tp} mesh takes {tp} devices, got "
                         f"{len(devices)}")
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda" and (
                not torch.cuda.is_available()
                or (dev.index or 0) >= torch.cuda.device_count()):
            raise ValueError(f"need {tp} devices for a {MODEL_AXIS!r} "
                             f"mesh: {dev} is not available")
    return Mesh(devices)
