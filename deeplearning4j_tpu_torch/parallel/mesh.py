"""The device meshes of the port: tensor-parallel serving's model axis and
training's (data, model) mesh (the reference's ``parallel/mesh.py``,
:23-146).

The reference lays one SPMD program over a ``jax.sharding.Mesh`` and lets
GSPMD split it. The port keeps its single controller: one process drives
every shard, so the serving engine's host logic runs once. A :class:`Mesh`
is the tuple of devices on the model axis, rank order; a device may repeat
(``["cpu"] * tp`` in the tests, ``["cuda:0"] * tp`` to run the sharded
programs on one card). A tensor split over the axis is a :class:`Shards`,
its ranks' parts in rank order, each on its rank's device. The
collectives are :meth:`Mesh.gather`, an exact concatenation on the first
device, which counts its calls (``gathers``) so a test can hold a program
to ``tp_collective_contract``, and :meth:`Mesh.psum`, the ranks' partial
sums added in rank order on the first device (``psums``), for the
Megatron row-parallel half of ``parallel/tensor_parallel.py``.

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

A data axis may span processes (``torch.distributed``): each process
drives a ``(dp_local, tp)`` :class:`DeviceMesh` over its own devices, the
global data axis is ``num_processes * dp_local`` and process ``p`` owns
global data rows ``p * dp_local`` to ``(p + 1) * dp_local - 1``; the model
axis stays inside a process (the layout of a multi-node GPU job: tensor
parallelism inside a node, data parallelism across nodes).
:func:`hybrid_mesh` builds it (the reference's multi-slice mesh: the DCN
factor of the data axis is the processes). Across processes the one
collective is :func:`all_reduce_mean`, one flattened bucket a call; a
leaf split over the data axis (FSDP) is split over the local data axis
only, the same shards in every process (HSDP: the losses are FSDP's, the
bytes a process are not ZeRO-3's).
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
        #: gathers and psums since construction (or the caller's last
        #: reset)
        self.gathers = 0
        self.psums = 0

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

    def psum(self, parts) -> torch.Tensor:
        """The all-reduce of partial sums: ``parts`` (rank order) added one
        after another on the first device, the same order on every call."""
        self.psums += 1
        dev = self.devices[0]
        total = parts[0].to(dev)
        for p in parts[1:]:
            total = total + p.to(dev)
        return total

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

    def __init__(self, devices, axis_names, dims, num_processes: int = 1,
                 process_index: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in dims)))
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"a {self.shape} mesh takes "
                             f"{math.prod(self.shape.values())} devices, "
                             f"got {len(self.devices)}")
        #: processes the data axis spans; ``shape`` is this process's part
        self.num_processes = int(num_processes)
        self.process_index = int(process_index)

    @property
    def global_data_size(self) -> int:
        """The data axis over every process."""
        return self.axis_size(DATA_AXIS) * self.num_processes

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
        procs = (f", process {self.process_index} of {self.num_processes}"
                 if self.num_processes > 1 else "")
        return (f"DeviceMesh({self.shape}, {[str(d) for d in self.devices]}"
                f"{procs})")


def dp_mp_mesh(dp: int, mp: int, devices=None) -> DeviceMesh:
    """The 2-D ``(data, model)`` training mesh (the reference's
    ``dp_mp_mesh``): rank ``(d, m)`` on ``devices[d * mp + m]``, by
    default the first ``dp * mp`` cards."""
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({dp}, {mp})")
    return DeviceMesh(_mesh_devices(dp * mp, devices, f"a ({dp}, {mp}) mesh"),
                      (DATA_AXIS, MODEL_AXIS), (dp, mp))


def hybrid_mesh(ici: dict[str, int], dcn: dict[str, int] | None = None,
                devices=None) -> DeviceMesh:
    """The multi-slice mesh (the reference's ``hybrid_mesh``): axis ``a``
    of size ``ici[a] * dcn.get(a, 1)``, the DCN factor outermost. Here a
    slice is a process: in a run of ``torch.distributed`` with a DCN
    factor, the data axis's DCN factor must be the process count and this
    process holds the ``ici`` part over its own ``devices`` (by default its
    first cards), global data rows ``rank * ici["data"]`` on; a DCN factor
    on another axis raises (a model axis across processes is not ported).
    In one process the mesh collapses to the plain mesh of the product
    sizes over ``devices``. ``ValueError`` for a DCN axis the ICI axes
    lack and for a device count that does not match, as the reference."""
    names = tuple(ici)
    unknown = set(dcn or {}) - set(names)
    if unknown:
        raise ValueError(
            f"dcn axes {sorted(unknown)} not present in ici axes {names}")
    ici_shape = tuple(int(n) for n in ici.values())
    dcn_shape = tuple(int((dcn or {}).get(k, 1)) for k in names)
    total = [i * d for i, d in zip(ici_shape, dcn_shape)]
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world > 1 and any(d > 1 for d in dcn_shape):
        across = {k: d for k, d in zip(names, dcn_shape) if d > 1}
        if set(across) != {DATA_AXIS} or across[DATA_AXIS] != world:
            raise ValueError(
                f"across {world} processes the port splits the "
                f"{DATA_AXIS!r} axis alone, by the process count: dcn "
                f"{dict(across)} (a model axis across processes is not "
                f"ported)")
        local = math.prod(ici_shape)
        return DeviceMesh(_hybrid_devices(local, devices, dict(ici)), names,
                          ici_shape, num_processes=world,
                          process_index=dist.get_rank())
    n = math.prod(total)
    return DeviceMesh(_hybrid_devices(n, devices, dict(zip(names, total))),
                      names, total)


def _hybrid_devices(n: int, devices, sizes: dict) -> list:
    """``devices`` or the first ``n`` cards for :func:`hybrid_mesh`, in the
    reference's wording when the count does not match."""
    have = (len(list(devices)) if devices is not None
            else torch.cuda.device_count() if torch.cuda.is_available()
            else 0)
    if have != n if devices is not None else have < n:
        raise ValueError(f"need {n} devices for mesh {sizes}, have {have}")
    return _mesh_devices(n, devices, f"mesh {sizes}")


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


# -- the data axis across processes ------------------------------------------

def all_reduce_mean(tensors, mesh: DeviceMesh) -> tuple[int, int]:
    """Averages ``tensors`` (f32, any devices) in place over the processes
    ``mesh``'s data axis spans: one flattened f32 bucket, one
    ``all_reduce`` (sum) on the default process group, then a division by
    the process count, so every process holds the same values. Gloo takes
    a CUDA bucket and stages it through the host itself. Returns ``(bucket
    bytes, bytes through the host)``: twice the bucket (down and back up)
    for a CUDA bucket on gloo, else 0; (0, 0) in one process."""
    if mesh.num_processes == 1:
        return 0, 0
    import torch.distributed as dist

    dev = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).to(device=dev,
                                                dtype=torch.float32)
                      for t in tensors])
    nbytes = flat.numel() * flat.element_size()
    dist.all_reduce(flat)
    flat /= mesh.num_processes
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n
    host = (2 * nbytes if dev.type == "cuda" and dist.get_backend() == "gloo"
            else 0)
    return nbytes, host


def broadcast_ints(values, mesh: DeviceMesh) -> list[int]:
    """Process 0's ``values`` (ints) on every process of ``mesh``'s data
    axis: a trainer's live controls (a POSTed minibatch, early stop) must
    agree, or the processes' collectives part ways. ``values`` as they are
    in one process."""
    if mesh.num_processes == 1:
        return [int(v) for v in values]
    import torch.distributed as dist

    dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return [int(v) for v in t.tolist()]
