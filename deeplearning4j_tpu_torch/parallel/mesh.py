"""The device meshes of the port: tensor-parallel serving's model axis and
training's (data, model) mesh (the reference's ``parallel/mesh.py``,
:23-146).

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

Training lays one program over a :class:`DeviceMesh`, devices on named
axes (``dp_mp_mesh``: ``(data, model)``; ``data_parallel_mesh`` and
``expert_mesh``: one axis), again driven by one controller: rank ``(d,
m)`` of a ``(data, model)`` mesh is ``devices[d * tp + m]`` and a device
may repeat, so ``["cuda:0"] * (dp * tp)`` runs every rank's program on
one card. A tensor laid out on such a mesh is a :class:`MeshTensor`: its
parts along each axis its spec splits, each on its rank's device (the
first rank along an axis it does not split). A row of a ``(data,
model)`` mesh is the model-axis :class:`Mesh` of serving
(:meth:`DeviceMesh.model_row`).
"""

from __future__ import annotations

import math

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"


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


def _mesh_devices(n: int, devices, what: str) -> list:
    """``devices`` (``n`` of them; a device may repeat) or the first ``n``
    CUDA cards, ``ValueError`` when fewer are visible (the reference's
    ``_mesh_1d`` wording)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"need {n} devices for {what}, have {have}")
        return [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"{what} takes {n} devices, got {len(devices)}")
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda" and (
                not torch.cuda.is_available()
                or (dev.index or 0) >= torch.cuda.device_count()):
            raise ValueError(f"need {n} devices for {what}: {dev} is not "
                             f"available")
    return devices


def model_parallel_mesh(tp: int, devices=None) -> Mesh:
    """The serving engine's tensor-parallel geometry: a model-axis mesh of
    ``tp`` ranks. By default the first ``tp`` CUDA cards (``ValueError``
    when fewer are visible, as the reference's ``_mesh_1d``); ``devices``
    names them instead and may repeat one."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return Mesh(_mesh_devices(tp, devices, f"a {MODEL_AXIS!r} mesh"))


class DeviceMesh:
    """Devices on named axes, rank order row-major (the last axis
    fastest), as ``jax.sharding.Mesh`` over ``np.array(devs).reshape``.
    ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names, dims):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in dims)))
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"a {self.shape} mesh takes "
                             f"{math.prod(self.shape.values())} devices, "
                             f"got {len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 for an axis the mesh lacks."""
        return self.shape.get(name, 1)

    def device(self, *index) -> torch.device:
        """The device of the rank at ``index``, one int per axis."""
        flat = 0
        for name, i in zip(self.axis_names, index):
            flat = flat * self.shape[name] + int(i)
        return self.devices[flat]

    def device_at(self, **coords: int) -> torch.device:
        """The device of the rank at the named coordinates (0 on an axis
        not named; a name the mesh lacks is ignored)."""
        return self.device(*(coords.get(a, 0) for a in self.axis_names))

    def model_row(self, d: int) -> Mesh:
        """Data row ``d`` of a ``(data, model)`` mesh as the model-axis
        :class:`Mesh` serving runs over."""
        tp = self.axis_size(MODEL_AXIS)
        return Mesh(self.devices[d * tp:(d + 1) * tp])

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices]})"


def dp_mp_mesh(dp: int, mp: int, devices=None) -> DeviceMesh:
    """The 2-D ``(data, model)`` training mesh (the reference's
    ``dp_mp_mesh``): rank ``(d, m)`` on ``devices[d * mp + m]``, by
    default the first ``dp * mp`` cards."""
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({dp}, {mp})")
    return DeviceMesh(_mesh_devices(dp * mp, devices, f"a ({dp}, {mp}) mesh"),
                      (DATA_AXIS, MODEL_AXIS), (dp, mp))


def _mesh_1d(axis: str, n_devices: int | None, devices) -> DeviceMesh:
    if devices is not None:
        devices = list(devices)
        n_devices = len(devices)
    elif n_devices is None:
        n_devices = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
    return DeviceMesh(_mesh_devices(n_devices, devices, f"a {axis!r} mesh"),
                      (axis,), (n_devices,))


def data_parallel_mesh(n_devices: int | None = None,
                       devices=None) -> DeviceMesh:
    """A 1-D data-axis mesh over ``devices`` or the first ``n_devices``
    cards (every visible card by default)."""
    return _mesh_1d(DATA_AXIS, n_devices, devices)


def expert_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A 1-D expert-axis mesh (the GShard layout ``moe_apply`` runs on:
    tokens split over the devices that hold the experts)."""
    return _mesh_1d(EXPERT_AXIS, n_devices, devices)


class MeshTensor:
    """One tensor laid out on a :class:`DeviceMesh` by ``spec``, a mesh
    axis name (split over that axis) or None (whole) for each dim, as a
    ``PartitionSpec``. ``parts[i][j]``: data part ``i``, model part ``j``
    (one index along an axis the spec does not split), on the device of
    rank ``(i, j)``; an axis the mesh lacks counts as size 1. Parts are
    contiguous ``torch.tensor_split`` pieces, rank order."""

    __slots__ = ("mesh", "spec", "parts")

    def __init__(self, mesh: DeviceMesh, spec, parts):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.parts = [list(row) for row in parts]

    def dim_of(self, axis: str):
        """The dim split over ``axis``, or None."""
        return self.spec.index(axis) if axis in self.spec else None

    def flat(self) -> list[torch.Tensor]:
        """Every part, data-major."""
        return [p for row in self.parts for p in row]

    def like(self, parts) -> "MeshTensor":
        """A MeshTensor of this layout over ``parts`` (:meth:`flat`
        order)."""
        parts = list(parts)
        w = len(self.parts[0])
        return MeshTensor(self.mesh, self.spec,
                          [parts[i:i + w] for i in range(0, len(parts), w)])

    def whole(self, device=None) -> torch.Tensor:
        """The tensor gathered whole on ``device`` (the mesh's first by
        default): an exact concatenation."""
        dev = torch.device(device) if device is not None else (
            self.mesh.devices[0])
        dd, md = self.dim_of(DATA_AXIS), self.dim_of(MODEL_AXIS)
        rows = [torch.cat([p.to(dev) for p in row], dim=md)
                if md is not None else row[0].to(dev) for row in self.parts]
        return torch.cat(rows, dim=dd) if dd is not None else rows[0]

    @property
    def shape(self) -> tuple[int, ...]:
        dd, md = self.dim_of(DATA_AXIS), self.dim_of(MODEL_AXIS)
        shape = list(self.parts[0][0].shape)
        if dd is not None:
            shape[dd] = sum(row[0].shape[dd] for row in self.parts)
        if md is not None:
            shape[md] = sum(p.shape[md] for p in self.parts[0])
        return tuple(shape)

    def __repr__(self) -> str:
        return f"MeshTensor({self.spec}, {self.shape})"


def place(mesh: DeviceMesh, x: torch.Tensor, spec) -> MeshTensor:
    """``x`` laid out by ``spec``: split with ``torch.tensor_split`` along
    each axis the spec names, each part moved to its rank's device (a view
    where the device is x's own). Autograd reaches ``x`` through it."""
    spec = tuple(spec) + (None,) * (x.dim() - len(tuple(spec)))
    dd = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
    md = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
    rows = (torch.tensor_split(x, mesh.axis_size(DATA_AXIS), dim=dd)
            if dd is not None else (x,))
    parts = []
    for i, row in enumerate(rows):
        cols = (torch.tensor_split(row, mesh.axis_size(MODEL_AXIS), dim=md)
                if md is not None else (row,))
        parts.append([c.to(mesh.device_at(**{DATA_AXIS: i, MODEL_AXIS: j}))
                      for j, c in enumerate(cols)])
    return MeshTensor(mesh, spec, parts)
