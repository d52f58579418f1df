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

Either axis may span processes (``torch.distributed``): :func:`hybrid_mesh`
lays the ``(data, model)`` mesh over ``num_processes`` processes, the
reference's multi-slice mesh with a process for a slice. Each axis's size
is its ICI factor (the ranks inside a process) times its DCN factor (the
processes along it), the DCN factor outermost: process ``p`` sits at
coordinates ``p`` row-major over the DCN factors, and its rank ``(d, m)``
is global rank ``(pd * dp_local + d, pm * tp_local + m)``. Each process
drives its own ranks' programs over its own devices; its
:class:`DeviceMesh` holds those devices, the local sizes in ``shape`` and
the global ones in :meth:`DeviceMesh.global_size`. A laid-out tensor keeps
only this process's parts, split over the global axes
(:func:`place`): a leaf split over a data axis that spans processes is
ZeRO-3 (each process holds and updates its shards alone), and a model
axis across processes splits heads, d_ff, experts and the vocabulary over
every process of a model row (the reference worker's topology, model
pairs across the process boundary).

The process groups are made once, in the same order in every process:
one per set of processes that differ along one axis (a model row, a data
column), the default group where that set is every process. The
collectives that cross a process are autograd functions
(``torch.autograd.Function``) that keep the one-process program's order
(:func:`model_sum`, :func:`model_inputs`, :func:`model_cat`,
:func:`data_parts`); each is an
all-gather (of a byte view, so any dtype goes through any backend) whose
parts every process adds in global rank order, so every process of a
group computes the same bits. Gloo on a card stages each one through the
host explicitly, and :data:`collectives` counts the calls, bytes, bytes
through the host and host seconds. The data axis's gradient bucket still
goes through :func:`all_reduce_mean`, over the processes that share a
model coordinate.
"""

from __future__ import annotations

import math
import time

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
    ``shape`` maps each axis name to its size in this process; ``dcn``
    maps it to the processes along it (1 for an axis inside a process,
    the data axis's factor being ``num_processes`` when only a process
    count is given), and :meth:`global_size` is their product."""

    def __init__(self, devices, axis_names, dims, num_processes: int = 1,
                 process_index: int = 0, dcn: dict | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in dims)))
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"a {self.shape} mesh takes "
                             f"{math.prod(self.shape.values())} devices, "
                             f"got {len(self.devices)}")
        #: processes the mesh spans and this one's index among them
        self.num_processes = int(num_processes)
        self.process_index = int(process_index)
        if dcn is None:
            dcn = {DATA_AXIS: self.num_processes} if (
                self.num_processes > 1) else {}
        self.dcn = {a: int(dcn.get(a, 1)) for a in self.axis_names}
        if math.prod(self.dcn.values()) != self.num_processes:
            raise ValueError(f"dcn factors {self.dcn} do not multiply to "
                             f"{self.num_processes} processes")
        #: this process's coordinate along each axis's DCN factor
        self.process_coords = _coords(self.process_index, self.axis_names,
                                      self.dcn)
        #: axis -> its process group (None: the default group);
        #: :func:`hybrid_mesh` fills it
        self.groups: dict[str, object] = {}

    @property
    def global_data_size(self) -> int:
        """The data axis over every process."""
        return self.global_size(DATA_AXIS)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` in this process; 1 for an axis the
        mesh lacks."""
        return self.shape.get(name, 1)

    def global_size(self, name: str) -> int:
        """The size of axis ``name`` over every process."""
        return self.axis_size(name) * self.dcn.get(name, 1)

    def offset(self, name: str) -> int:
        """The global index of this process's first rank along ``name``."""
        return self.process_coords.get(name, 0) * self.axis_size(name)

    def spans(self, name: str) -> bool:
        """Whether axis ``name`` crosses processes."""
        return self.dcn.get(name, 1) > 1

    def group(self, name: str | None):
        """``(group, size)``: the process group along axis ``name`` (None:
        the default group), or every process for ``name=None``."""
        if name is None:
            return None, self.num_processes
        return self.groups.get(name), self.dcn[name]

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
                 f" over dcn {self.dcn}" if self.num_processes > 1 else "")
        return (f"DeviceMesh({self.shape}, {[str(d) for d in self.devices]}"
                f"{procs})")


def _coords(p: int, names, dcn: dict) -> dict[str, int]:
    """Process ``p``'s coordinate along each axis, row-major over the DCN
    factors in axis order."""
    out = {}
    for a in reversed(tuple(names)):
        out[a] = p % dcn[a]
        p //= dcn[a]
    return out


def _make_groups(mesh: DeviceMesh) -> None:
    """One process group per set of processes that differ along one
    spanning axis alone, made in the same order in every process (each
    process takes part in every ``new_group`` call); a set of every
    process keeps the default group."""
    import torch.distributed as dist

    for axis in mesh.axis_names:
        if not mesh.spans(axis):
            continue
        sets: dict[tuple, list[int]] = {}
        for p in range(mesh.num_processes):
            c = _coords(p, mesh.axis_names, mesh.dcn)
            key = tuple(c[a] for a in mesh.axis_names if a != axis)
            sets.setdefault(key, []).append(p)
        for key in sorted(sets):
            ranks = sorted(sets[key], key=lambda p: _coords(
                p, mesh.axis_names, mesh.dcn)[axis])
            group = (None if len(ranks) == mesh.num_processes
                     else dist.new_group(ranks))
            if mesh.process_index in ranks:
                mesh.groups[axis] = group


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
    factor, the factors must multiply to the process count, process ``p``
    sits at coordinates ``p`` row-major over them (along the data axis,
    the model axis, or both), and this process holds the ``ici`` part
    over its own ``devices`` (by default its first cards); the process
    groups of the spanning axes are made here (every process calls
    ``hybrid_mesh`` with the same sizes, in the same order). In one
    process the mesh collapses to the plain mesh of the product sizes
    over ``devices``. ``ValueError`` for a DCN axis the ICI axes lack and
    for a device count that does not match, as the reference."""
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
        if math.prod(dcn_shape) != world:
            raise ValueError(
                f"dcn {dict(zip(names, dcn_shape))} spans "
                f"{math.prod(dcn_shape)} processes, the run has {world}")
        local = math.prod(ici_shape)
        mesh = DeviceMesh(_hybrid_devices(local, devices, dict(ici)), names,
                          ici_shape, num_processes=world,
                          process_index=dist.get_rank(),
                          dcn=dict(zip(names, dcn_shape)))
        _make_groups(mesh)
        return mesh
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


def device_data_mesh(device: torch.device) -> DeviceMesh:
    """The default data axis of a model on ``device``: every card when it
    is a card, else the one device."""
    if device.type == "cuda":
        return data_parallel_mesh()
    return data_parallel_mesh(devices=[device])


def expert_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A 1-D expert-axis mesh (the GShard layout ``moe_apply`` runs on:
    tokens split over the devices that hold the experts)."""
    return _mesh_1d(EXPERT_AXIS, n_devices, devices)


class MeshTensor:
    """One tensor laid out on a :class:`DeviceMesh` by ``spec``, a mesh
    axis name (split over that axis) or None (whole) for each dim, as a
    ``PartitionSpec``. ``parts[i][j]``: this process's data part ``i``,
    model part ``j`` (one index along an axis the spec does not split),
    on the device of its rank ``(i, j)``; an axis the mesh lacks counts
    as size 1. Parts are contiguous ``torch.tensor_split`` pieces of
    ``full_shape`` over the global axes, rank order; across processes a
    process holds only its own ranks' parts (:meth:`index` gives a part's
    global index)."""

    __slots__ = ("mesh", "spec", "parts", "full_shape")

    def __init__(self, mesh: DeviceMesh, spec, parts, full_shape=None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.parts = [list(row) for row in parts]
        self.full_shape = (tuple(full_shape) if full_shape is not None
                           else self._local_shape())

    def dim_of(self, axis: str):
        """The dim split over ``axis``, or None."""
        return self.spec.index(axis) if axis in self.spec else None

    def index(self, i: int, j: int) -> tuple[int, int]:
        """The global (data, model) index of local part ``(i, j)``."""
        gi = (i + self.mesh.offset(DATA_AXIS)
              if self.dim_of(DATA_AXIS) is not None else 0)
        gj = (j + self.mesh.offset(MODEL_AXIS)
              if self.dim_of(MODEL_AXIS) is not None else 0)
        return gi, gj

    def counts(self) -> tuple[int, int]:
        """The global part counts along the data and model axes."""
        return tuple(self.mesh.global_size(a) if self.dim_of(a) is not None
                     else 1 for a in (DATA_AXIS, MODEL_AXIS))

    def sizes(self, axis: str) -> list[int]:
        """Every global part's length along the dim ``axis`` splits."""
        n = self.full_shape[self.dim_of(axis)]
        return [len(c) for c in torch.tensor_split(
            torch.empty(n, device="meta"), self.mesh.global_size(axis))]

    def spans(self) -> bool:
        """Whether another process holds parts of this tensor that this
        one lacks."""
        return any(self.mesh.spans(a) and self.dim_of(a) is not None
                   for a in (DATA_AXIS, MODEL_AXIS))

    def flat(self) -> list[torch.Tensor]:
        """Every part, data-major."""
        return [p for row in self.parts for p in row]

    def like(self, parts) -> "MeshTensor":
        """A MeshTensor of this layout over ``parts`` (:meth:`flat`
        order)."""
        parts = list(parts)
        w = len(self.parts[0])
        return MeshTensor(self.mesh, self.spec,
                          [parts[i:i + w] for i in range(0, len(parts), w)],
                          self.full_shape)

    def whole(self, device=None) -> torch.Tensor:
        """The tensor gathered whole on ``device`` (the mesh's first by
        default): an exact concatenation, the parts of other processes
        gathered through :func:`data_parts` and :func:`model_cat` (every
        process of the run must call it)."""
        dev = torch.device(device) if device is not None else (
            self.mesh.devices[0])
        dd, md = self.dim_of(DATA_AXIS), self.dim_of(MODEL_AXIS)

        def row_whole(row):
            if md is None:
                return row[0].to(dev)
            if self.mesh.spans(MODEL_AXIS):
                return model_cat(self.mesh, [p.to(dev) for p in row], md,
                                 self.sizes(MODEL_AXIS))
            return torch.cat([p.to(dev) for p in row], dim=md)

        cols = [row_whole(row) for row in global_rows(self)]
        return torch.cat(cols, dim=dd) if dd is not None else cols[0]

    def _local_shape(self) -> tuple[int, ...]:
        dd, md = self.dim_of(DATA_AXIS), self.dim_of(MODEL_AXIS)
        shape = list(self.parts[0][0].shape)
        if dd is not None:
            shape[dd] = sum(row[0].shape[dd] for row in self.parts)
        if md is not None:
            shape[md] = sum(p.shape[md] for p in self.parts[0])
        return tuple(shape)

    @property
    def shape(self) -> tuple[int, ...]:
        return self.full_shape

    def __repr__(self) -> str:
        return f"MeshTensor({self.spec}, {self.shape})"


def place(mesh: DeviceMesh, x: torch.Tensor, spec) -> MeshTensor:
    """``x`` laid out by ``spec``: split with ``torch.tensor_split`` along
    each axis the spec names over the axis's global size, this process's
    parts kept, each moved to its rank's device (a view where the device
    is x's own). Autograd reaches ``x`` through it."""
    spec = tuple(spec) + (None,) * (x.dim() - len(tuple(spec)))
    dd = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
    md = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None

    def mine(t, axis, dim):
        if dim is None:
            return (t,)
        n, off = mesh.axis_size(axis), mesh.offset(axis)
        return torch.tensor_split(t, mesh.global_size(axis),
                                  dim=dim)[off:off + n]

    parts = []
    for i, row in enumerate(mine(x, DATA_AXIS, dd)):
        parts.append([c.to(mesh.device_at(**{DATA_AXIS: i, MODEL_AXIS: j}))
                      for j, c in enumerate(mine(row, MODEL_AXIS, md))])
    return MeshTensor(mesh, spec, parts, tuple(x.shape))


# -- the collectives that cross a process -------------------------------------

#: since the last :func:`reset_collectives`: calls, bytes each process
#: received, bytes it moved through the host (a CUDA tensor on gloo: down
#: once, every part back up) and host seconds (the device synced on both
#: sides)
collectives = {"calls": 0, "bytes": 0, "host_bytes": 0, "seconds": 0.0}


def reset_collectives() -> None:
    collectives.update(calls=0, bytes=0, host_bytes=0, seconds=0.0)


def process_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str | None
                   ) -> list[torch.Tensor]:
    """Every process's ``t`` (one shape and dtype on all) along ``axis``
    (every process for None), group order, each on ``t``'s device: an
    all-gather of its bytes, which no backend rounds. Gloo with a CUDA
    tensor goes through a host copy made here, counted in
    :data:`collectives`."""
    import torch.distributed as dist

    group, n = mesh.group(axis)
    t = t.detach().contiguous()
    cuda = t.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    staged = cuda and dist.get_backend(group) == "gloo"
    flat = t.reshape(-1).view(torch.uint8)
    src = flat.cpu() if staged else flat
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    if staged:
        out = [o.to(t.device) for o in out]
    if cuda:
        torch.cuda.synchronize(t.device)
    nbytes = src.numel()
    collectives["calls"] += 1
    collectives["bytes"] += n * nbytes
    collectives["host_bytes"] += (n + 1) * nbytes if staged else 0
    collectives["seconds"] += time.perf_counter() - t0
    return [o.view(t.dtype).view(t.shape) for o in out]


def _ordered_sum(ts):
    total = None
    for t in ts:
        total = t if total is None else total + t
    return total


class _ModelSum(torch.autograd.Function):
    """(a) the row-parallel sum across processes: forward, every process's
    local ranks' partials gathered and added one after another in global
    rank order (the one-process program's sum, bitwise); backward, the
    replicated gradient, which every process of the row computes alike,
    to each local partial."""

    @staticmethod
    def forward(ctx, mesh, dev, *parts):
        ctx.devs = [p.device for p in parts]
        every = process_gather(torch.stack([p.to(dev) for p in parts]),
                               mesh, MODEL_AXIS)
        return _ordered_sum(p for blk in every for p in blk.unbind(0))

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(g.to(d) for d in ctx.devs))


class _ModelInputs(torch.autograd.Function):
    """(b) the column-parallel input across processes: forward, a copy of
    the replicated ``x`` for each local rank; backward, every rank's
    gradient (this process's and the others') added in global rank
    order, the same bits on every process of the row."""

    @staticmethod
    def forward(ctx, mesh, devs, x):
        ctx.mesh, ctx.dev = mesh, x.device
        return tuple(x.to(d, copy=True) for d in devs)

    @staticmethod
    def backward(ctx, *gs):
        ref = next(g for g in gs if g is not None)
        local = torch.stack([(g if g is not None else torch.zeros_like(ref)
                              ).to(ctx.dev) for g in gs])
        every = process_gather(local, ctx.mesh, MODEL_AXIS)
        return None, None, _ordered_sum(p for blk in every
                                        for p in blk.unbind(0))


def _pad_to(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    if t.shape[dim] == n:
        return t
    shape = list(t.shape)
    shape[dim] = n - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


class _ModelCat(torch.autograd.Function):
    """(c) the gather of a tensor's model parts across processes (the
    head's vocab parts, the embeddings' d_model parts): forward, the local
    parts concatenated on ``dim``, padded to the longest process's block,
    gathered, trimmed and concatenated in global rank order; backward,
    each local part's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, mesh, dim, sizes, *parts):
        tpl, off = mesh.axis_size(MODEL_AXIS), mesh.offset(MODEL_AXIS)
        blocks = [sum(sizes[q * tpl:(q + 1) * tpl])
                  for q in range(mesh.dcn[MODEL_AXIS])]
        dim = dim % parts[0].dim()
        ctx.dim, ctx.devs = dim, [p.device for p in parts]
        ctx.start, ctx.lens = sum(sizes[:off]), [p.shape[dim] for p in parts]
        mine = torch.cat(parts, dim=dim)
        every = process_gather(_pad_to(mine, dim, max(blocks)), mesh,
                               MODEL_AXIS)
        return torch.cat([b.narrow(dim, 0, n) for b, n in zip(every, blocks)],
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        out, at = [], ctx.start
        for n, d in zip(ctx.lens, ctx.devs):
            out.append(g.narrow(ctx.dim, at, n).to(d))
            at += n
        return (None, None, None, *out)


class _DataParts(torch.autograd.Function):
    """ZeRO-3's gather at use, and the ring's K/V blocks across processes:
    forward, every data part of one model column over the global data
    axis (this process's and the others', gathered; parts padded to the
    longest); backward, each global part's gradient added over the
    processes of the data column in process order (an all-reduce; every
    backend takes an all-gather), and this process's own parts' sums
    returned to them."""

    @staticmethod
    def forward(ctx, mesh, dim, sizes, *parts):
        ctx.mesh, ctx.dim, ctx.sizes = mesh, dim, sizes
        ctx.off, ctx.devs = mesh.offset(DATA_AXIS), [p.device for p in parts]
        dev = parts[0].device
        top = max(sizes)
        mine = torch.stack([_pad_to(p.to(dev), dim, top) for p in parts])
        ctx.padded = mine.shape[1:]
        every = process_gather(mine, mesh, DATA_AXIS)
        flat = [p for blk in every for p in blk.unbind(0)]
        return tuple(p.narrow(dim, 0, n).clone()
                     for p, n in zip(flat, sizes))

    @staticmethod
    def backward(ctx, *gs):
        dim, dev = ctx.dim, ctx.devs[0]
        full = torch.zeros((len(gs), *ctx.padded), dtype=next(
            g for g in gs if g is not None).dtype, device=dev)
        for k, g in enumerate(gs):
            if g is not None:
                full[k].narrow(dim, 0, g.shape[dim]).copy_(g)
        total = _ordered_sum(process_gather(full, ctx.mesh, DATA_AXIS))
        return (None, None, None,
                *(total[ctx.off + i].narrow(dim, 0, ctx.sizes[ctx.off + i])
                  .to(d) for i, d in enumerate(ctx.devs)))


def model_sum(mesh: DeviceMesh, parts, dev) -> torch.Tensor:
    """The row-parallel sum of the local model ranks' ``parts`` on
    ``dev``: added one after another in rank order, across processes
    through (a) :class:`_ModelSum`."""
    if mesh.spans(MODEL_AXIS):
        return _ModelSum.apply(mesh, dev, *parts)
    return _ordered_sum(p.to(dev) for p in parts)


def model_inputs(mesh: DeviceMesh, x: torch.Tensor, devs) -> list:
    """The replicated ``x`` on each local model rank's device, across
    processes through (b) :class:`_ModelInputs`."""
    if mesh.spans(MODEL_AXIS):
        return list(_ModelInputs.apply(mesh, list(devs), x))
    return [x.to(d) for d in devs]


def model_cat(mesh: DeviceMesh, parts, dim: int, sizes=None) -> torch.Tensor:
    """The local model ranks' ``parts`` (on one device) concatenated on
    ``dim``, across processes with the other processes' parts through
    (c) :class:`_ModelCat` (``sizes``: every global part's length on
    ``dim``)."""
    if mesh.spans(MODEL_AXIS):
        return _ModelCat.apply(mesh, dim, list(sizes), *parts)
    return torch.cat(list(parts), dim=dim) if len(parts) > 1 else parts[0]


def data_parts(mesh: DeviceMesh, parts, dim: int, sizes) -> list:
    """Every global data part of one model column from this process's
    ``parts`` (rank order; ``sizes`` every global part's length on
    ``dim``): the parts themselves in one process, else gathered through
    :class:`_DataParts`."""
    if mesh.spans(DATA_AXIS):
        return list(_DataParts.apply(mesh, dim, list(sizes), *parts))
    return list(parts)


def global_rows(mt: MeshTensor) -> list[list[torch.Tensor]]:
    """``mt.parts`` with the data axis made global: where a data axis that
    spans processes splits the tensor, every data part (ZeRO-3's gather at
    use, :func:`data_parts`), else this process's own."""
    dd = mt.dim_of(DATA_AXIS)
    if dd is None or not mt.mesh.spans(DATA_AXIS):
        return mt.parts
    sizes = mt.sizes(DATA_AXIS)
    cols = [data_parts(mt.mesh, [row[j] for row in mt.parts], dd, sizes)
            for j in range(len(mt.parts[0]))]
    return [list(row) for row in zip(*cols)]


# -- the data axis across processes ------------------------------------------

def all_reduce_mean(tensors, mesh: DeviceMesh) -> tuple[int, int]:
    """Averages ``tensors`` (f32, any devices) in place over the processes
    ``mesh``'s data axis spans (those that share this process's model
    coordinate): one flattened f32 bucket, one ``all_reduce`` (sum) on
    that group, then a division by its size, so every process of the group
    holds the same values. Gloo takes a CUDA bucket and stages it through
    the host itself. Returns ``(bucket bytes, bytes through the host)``:
    twice the bucket (down and back up) for a CUDA bucket on gloo, else 0;
    (0, 0) when the data axis stays in the process."""
    if not mesh.spans(DATA_AXIS):
        return 0, 0
    import torch.distributed as dist

    group, n_proc = mesh.group(DATA_AXIS)
    dev = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).to(device=dev,
                                                dtype=torch.float32)
                      for t in tensors])
    nbytes = flat.numel() * flat.element_size()
    dist.all_reduce(flat, group=group)
    flat /= n_proc
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n
    host = (2 * nbytes if dev.type == "cuda"
            and dist.get_backend(group) == "gloo" else 0)
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


def rank_mean(mesh: DeviceMesh, tables, rank_step) -> list[torch.Tensor]:
    """One data-parallel step over replicated tables, averaged: for every
    data rank ``r`` of ``mesh`` in rank order, ``rank_step(r, copies)``
    gets its own copies of ``tables`` on its device (the rank's step may
    update them in place) and returns its updated tensors (the tables, and
    anything else to average, such as its loss). The ranks' results are
    summed in rank order on the first device, one rank at a time, and
    divided by the rank count (a device scalar: CUDA divides by a host
    number as a product with its reciprocal), as the reference's ``pmean``
    over a ``shard_map``; across processes (``hybrid_mesh``) the local
    means then go through :func:`all_reduce_mean`, one bucket a step. The
    embedding models' ``fit_distributed`` (GloVe, Word2Vec) share it."""
    dev = mesh.devices[0]
    n = mesh.axis_size(DATA_AXIS)
    total = None
    for r in range(n):
        rdev = mesh.device_at(**{DATA_AXIS: r})
        out = rank_step(r, [t.detach().to(rdev, copy=True) for t in tables])
        if total is None:
            total = [o.to(dev) for o in out]
        else:
            for acc, o in zip(total, out):
                acc.add_(o.to(dev))
    div = torch.full((), float(n), device=dev)
    total = [acc / div for acc in total]
    all_reduce_mean(total, mesh)
    return total
