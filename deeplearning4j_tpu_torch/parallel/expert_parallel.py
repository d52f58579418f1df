"""Expert parallelism (MoE): the port of
``deeplearning4j_tpu/parallel/expert_parallel.py``.

A mixture-of-experts feed-forward block with GShard-style top-k routing and
a fixed per-expert capacity (overflow tokens drop: their combine weight is
zero), one expert per rank of the mesh axis the experts live on, and the
Switch load-balancing loss beside the output.

The reference builds dense ``(T, E, C)`` dispatch and combine masks and
contracts them with einsums. The masks are one-hot, so the port routes by
index instead (:func:`_top_k_route`): each kept ``(token, choice)`` gets its
``(expert, slot)``, each expert's ``(C, D)`` bucket is a gather of its
tokens (an empty slot is a zero row, as the reference's einsum leaves it),
and the output is a gather of the bucket rows scaled by the combine
weights. That is the same function at O(T) memory where the masks take
O(T^2) (``C`` grows with ``T``); :func:`_top_k_dispatch` rebuilds the
masks from the route for the tests.

The forms, as the reference's:

- :func:`moe_apply` (``moe_apply``, :178): tokens split over the expert
  axis, one all-to-all to the experts and one back. On one controller the
  all-to-all is a permutation of ``(E, C, D)`` buckets between ranks.
- :func:`moe_ffn` (``moe_ffn``, :210), the form the transformer trains:
  tokens whole on every model rank, each rank applies its own expert to its
  capacity bucket, and the partial outputs are summed over the expert axis
  in rank order.
- :func:`moe_reference` (:258), no capacity: the decode programs' MoE.
  Every expert runs over every row and each row then takes its k chosen
  outputs ("dense decode"), so a row's value depends on that row alone, as
  with the dense MLP (grouping rows by expert would make each expert
  product's row count, and with it the library's kernel, depend on the
  batch's routing). :func:`moe_reference_shard` is the same function with
  the experts on their model ranks (generate over the training layout).

Top-k is ``argmax`` (the first maximum, as ``jnp.argmax``) in the routing
and a stable descending sort in :func:`moe_reference` (the lower index
first on a tie, as ``lax.top_k``). Slots are counted in integers (the
reference counts in f32, exact below 2^24 tokens); the combine weights are
computed in f32 and cast to the gate dtype, as the reference's.
Activations default as the reference's: relu for :func:`moe_apply` and
:func:`moe_reference`, gelu (tanh-approximated, ``jax.nn.gelu``'s default)
for :func:`moe_ffn`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
from deeplearning4j_tpu_torch.parallel.mesh import Shards

AXIS = mesh_lib.EXPERT_AXIS


class MoEParams(NamedTuple):
    """Router and stacked expert FFN weights; the expert tensors carry a
    leading ``(E, ...)`` axis (split over the expert axis when placed),
    the router is whole."""

    wg: torch.Tensor  # (D, E) router
    w1: torch.Tensor  # (E, D, H)
    b1: torch.Tensor  # (E, H)
    w2: torch.Tensor  # (E, H, D)
    b2: torch.Tensor  # (E, D)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


relu = F.relu


def init_moe_params(seed: int, d_model: int, d_hidden: int,
                    num_experts: int, dtype=torch.float32,
                    device=None) -> MoEParams:
    """Random params at the reference's scales (normal weights over
    sqrt(fan-in), zero biases), drawn from a numpy RNG: the draws differ
    from ``init_moe_params``'s, so hold weights across the frameworks by
    converting the reference's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(device=dev, dtype=dtype)

    s_in, s_hid = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    return MoEParams(
        wg=normal((d_model, num_experts), s_in),
        w1=normal((num_experts, d_model, d_hidden), s_in),
        b1=torch.zeros((num_experts, d_hidden), dtype=dtype, device=dev),
        w2=normal((num_experts, d_hidden, d_model), s_hid),
        b2=torch.zeros((num_experts, d_model), dtype=dtype, device=dev),
    )


def place_moe_params(mesh, params: MoEParams) -> MoEParams:
    """The expert tensors split over the mesh's expert axis (a
    :class:`Shards` of one expert a rank, each on its rank's device), the
    router whole on the first device."""
    n = mesh.shape[AXIS]

    def split(x):
        return Shards(p.to(mesh.devices[r]).contiguous() for r, p in
                      enumerate(torch.tensor_split(x, n, dim=0)))

    return MoEParams(wg=params.wg.to(mesh.devices[0]), w1=split(params.w1),
                     b1=split(params.b1), w2=split(params.w2),
                     b2=split(params.b2))


class Route(NamedTuple):
    """Top-k routing by index: per choice ``j``, the expert ``idx[j]``
    (T,), the slot ``slot[j]`` (T,) in that expert's bucket and ``keep[j]``
    (T,) bool (slot < capacity); ``weight[j]`` (T,) the combine weight in
    the gate dtype (0 where dropped); ``frac`` (E,) the pre-capacity routed
    fractions, in the gate dtype."""

    idx: list
    slot: list
    keep: list
    weight: list
    frac: torch.Tensor


def _top_k_route(gates: torch.Tensor, k: int, capacity: int) -> Route:
    """The reference's ``_top_k_dispatch`` (GShard alg. 1) by index:
    sequential top-k, choice j's slots after the tokens choices < j
    placed; a slot >= ``capacity`` drops. At k > 1 each token's kept gate
    weights are normalized to sum to 1; at k = 1 the raw gate is the
    multiplier (g/g = 1 would cut the router's gradient)."""
    t, e = gates.shape
    g32 = gates.float()
    remaining = g32
    counts = torch.zeros((e,), dtype=torch.long, device=gates.device)
    frac = torch.zeros((e,), dtype=torch.float32, device=gates.device)
    gate_sum = torch.zeros((t,), dtype=torch.float32, device=gates.device)
    idxs, slots, keeps, raw = [], [], [], []
    for _ in range(k):
        idx = remaining.argmax(dim=1)
        onehot = F.one_hot(idx, e)
        # pre-capacity fraction: the load-balancing loss must see the
        # router's assignment, not the post-drop dispatch
        frac = frac + onehot.float().mean(dim=0) / k
        gate_j = g32.gather(1, idx[:, None])[:, 0]
        pos = onehot.cumsum(dim=0) - 1 + counts
        counts = counts + onehot.sum(dim=0)
        slot = pos.gather(1, idx[:, None])[:, 0]
        keep = slot < capacity
        gate_sum = gate_sum + gate_j * keep
        remaining = remaining * (1 - onehot)
        idxs.append(idx)
        slots.append(slot)
        keeps.append(keep)
        raw.append(gate_j)
    if k > 1:
        raw = [g / torch.clamp_min(gate_sum, 1e-9) for g in raw]
    dt = gates.dtype
    weights = [torch.where(kp, g, torch.zeros_like(g)).to(dt)
               for g, kp in zip(raw, keeps)]
    return Route(idxs, slots, keeps, weights, frac.to(dt))


def _top_k_dispatch(gates: torch.Tensor, k: int, capacity: int):
    """The reference's dense ``(dispatch (T, E, C), combine (T, E, C),
    route_frac (E,))``, built from :func:`_top_k_route` (the tests hold
    the route against the reference's masks)."""
    t, e = gates.shape
    r = _top_k_route(gates, k, capacity)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    rows = torch.arange(t, device=gates.device)
    for idx, slot, keep, w in zip(r.idx, r.slot, r.keep, r.weight):
        tk, ek, sk = rows[keep], idx[keep], slot[keep]
        dispatch[tk, ek, sk] += 1.0
        combine[tk, ek, sk] += w[keep].float()
    dt = gates.dtype
    return dispatch.to(dt), combine.to(dt), r.frac


def _aux(route: Route, gates: torch.Tensor, n_exp: int) -> torch.Tensor:
    """Switch load balancing, ``E * sum_e(f_e * P_e)`` over the routed
    fractions (floor 1.0 when perfectly balanced)."""
    return n_exp * torch.sum(route.frac * gates.mean(dim=0))


def _select(route: Route, e: int, j: int, sink: int) -> torch.Tensor:
    """Choice j's slot for tokens it sends to expert ``e``, ``sink`` for
    the rest."""
    sel = route.keep[j] & (route.idx[j] == e)
    return torch.where(sel, route.slot[j], torch.full_like(route.slot[j],
                                                           sink))


def _bucket(xt: torch.Tensor, route: Route, e: int,
            capacity: int) -> torch.Tensor:
    """Expert ``e``'s ``(C, D)`` capacity bucket: slot ``c`` holds the row
    of the token routed there, an empty slot a zero row. A gather: the
    reference's dispatch einsum against one-hot masks."""
    t, d = xt.shape
    src = torch.full((capacity + 1,), t, dtype=torch.long, device=xt.device)
    rows = torch.arange(t, device=xt.device)
    for j in range(len(route.idx)):
        # unrouted tokens all write slot C, which is cut off below
        src.scatter_(0, _select(route, e, j, capacity), rows)
    return torch.cat([xt, xt.new_zeros((1, d))])[src[:capacity]]


def _combine(out: torch.Tensor, route: Route, e: int) -> torch.Tensor:
    """Expert ``e``'s share of the output, ``(T, D)``: each token its
    bucket row times its combine weight (0 for tokens not routed to ``e``;
    the reference's ``einsum("cd,tc->td")``)."""
    c, d = out.shape
    padded = torch.cat([out, out.new_zeros((1, d))])
    y = None
    for j, w in enumerate(route.weight):
        pick = _select(route, e, j, c)
        wj = torch.where(pick < c, w, torch.zeros_like(w))
        v = padded[pick] * wj[:, None]
        y = v if y is None else y + v
    return y


def _expert(w1, b1, w2, b2, x, activation):
    """One expert's FFN over rows ``x``."""
    return activation(x @ w1 + b1) @ w2 + b2


def _expert_views(params: MoEParams, n_exp: int, axis: str):
    """Per rank, its expert's ``(w1, b1, w2, b2)`` (leading axis dropped).
    Raises the reference's ``ValueError`` unless there is exactly one
    expert a rank."""
    w1 = params.w1
    total = (sum(p.shape[0] for p in w1) if isinstance(w1, Shards)
             else w1.shape[0])
    if total != n_exp or (isinstance(w1, Shards) and len(w1) != n_exp):
        block = total // n_exp if total % n_exp == 0 else f"{total}/{n_exp}"
        raise ValueError(
            f"MoE assumes one expert per device: num_experts must equal "
            f"the mesh's {axis!r} size ({n_exp}), got a per-device block of "
            f"{block}")
    parts = [list(leaf) if isinstance(leaf, Shards)
             else list(torch.tensor_split(leaf, n_exp, dim=0))
             for leaf in (params.w1, params.b1, params.w2, params.b2)]
    return [tuple(p[r][0] for p in parts) for r in range(n_exp)]


def moe_ffn_shard(x: torch.Tensor, wg: torch.Tensor, experts, devices, *,
                  k: int, capacity_factor: float, activation=gelu,
                  mesh=None):
    """One data shard of :func:`moe_ffn`: ``x`` (b, t, D) whole on every
    model rank (held on the shard's first device), ``experts`` the ranks'
    ``(w1, b1, w2, b2)`` on ``devices``. Routes the shard's tokens, runs
    each rank's expert over its bucket and sums the partial outputs in
    rank order. Returns ``(y (b, t, D), aux)``, aux this shard's.

    Given a ``mesh`` whose model axis spans processes, ``experts`` are
    this process's (global experts ``mesh.offset("model")`` on) and every
    process of the row routes alike from the replicated stream; the
    tokens and the combine weights reach the local experts through
    ``mesh_lib.model_inputs`` (so their gradients add over every expert)
    and the partial outputs are summed through ``mesh_lib.model_sum``,
    in global expert order."""
    b, t, d = x.shape
    spans = mesh is not None and mesh.spans(mesh_lib.MODEL_AXIS)
    n_exp = mesh.global_size(mesh_lib.MODEL_AXIS) if spans else len(experts)
    first = mesh.offset(mesh_lib.MODEL_AXIS) if spans else 0
    xt = x.reshape(b * t, d)
    capacity = max(1, int(capacity_factor * k * b * t / n_exp))
    gates = torch.softmax(xt @ wg.to(xt.device), dim=-1)
    route = _top_k_route(gates, k, capacity)
    aux = _aux(route, gates, n_exp)
    here = [xt.device] * len(experts)
    if spans:
        xts = mesh_lib.model_inputs(mesh, xt, here)
        weights = mesh_lib.model_inputs(mesh, torch.stack(route.weight),
                                        here)
        routes = [route._replace(weight=list(w.unbind(0)))
                  for w in weights]
    else:
        xts, routes = [xt] * len(experts), [route] * len(experts)
    parts = []
    for e, (ex, dev, xe, r) in enumerate(zip(experts, devices, xts, routes),
                                         start=first):
        out = _expert(*ex, _bucket(xe, r, e, capacity).to(dev), activation)
        parts.append(_combine(out.to(xt.device), r, e))
    if spans:
        y = mesh_lib.model_sum(mesh, parts, xt.device)
    else:
        y = None
        for ye in parts:
            y = ye if y is None else y + ye
    return y.reshape(b, t, d), aux


def _token_dim(token_spec) -> int | None:
    spec = tuple(token_spec)
    return spec.index(mesh_lib.DATA_AXIS) if (
        mesh_lib.DATA_AXIS in spec) else None


def moe_ffn(mesh, *, expert_axis: str | None = None, token_spec=None,
            k: int = 2, capacity_factor: float = 2.0, activation=gelu):
    """The MoE FFN over ``(B, T, D)`` activations on a multi-axis mesh
    (the reference's ``moe_ffn``): experts one a rank on ``expert_axis``
    (the model axis by default), tokens split over the data axis by
    ``token_spec`` (``(data, None, None)`` by default; ``(None, data,
    None)`` splits the sequence) and whole on every expert rank. Returns
    ``fn(params, x) -> (y, aux)``: ``params`` a :class:`MoEParams` (whole,
    or its expert leaves as :class:`Shards` over the axis), ``x`` whole;
    ``y`` whole on x's device, ``aux`` averaged over the mesh."""
    axis = expert_axis or mesh_lib.MODEL_AXIS
    n_exp = mesh.shape[axis]
    dp = mesh.axis_size(mesh_lib.DATA_AXIS)
    token_spec = token_spec or (mesh_lib.DATA_AXIS, None, None)
    tdim = _token_dim(token_spec)

    def fn(params: MoEParams, x: torch.Tensor):
        experts = _expert_views(params, n_exp, axis)
        shards = (torch.tensor_split(x, dp, dim=tdim) if tdim is not None
                  else [x] * dp)
        ys, auxes = [], []
        for di, xs in enumerate(shards):
            devs = [mesh.device_at(**{mesh_lib.DATA_AXIS: di, axis: r})
                    for r in range(n_exp)]
            y, aux = moe_ffn_shard(
                xs.to(devs[0]), params.wg,
                [tuple(w.to(dv) for w in ex) for ex, dv in zip(experts,
                                                                devs)],
                devs, k=k, capacity_factor=capacity_factor,
                activation=activation)
            ys.append(y.to(x.device))
            auxes.append(aux.to(x.device))
        y = torch.cat(ys, dim=tdim) if tdim is not None else ys[0]
        return y, torch.stack(auxes).mean()

    return fn


def moe_apply(mesh, *, k: int = 2, capacity_factor: float = 2.0,
              activation=relu):
    """The all-to-all form (the reference's ``moe_apply``): ``fn(params,
    x) -> (y, aux)`` with ``x`` (T, D) split over the expert axis, each
    rank routing its tokens into ``(E, C, D)`` buckets; bucket ``e`` of
    every rank goes to rank ``e`` (the all-to-all), which applies its
    expert, and the outputs come back the same way and are combined in
    token order. ``y`` comes back whole on x's device; ``aux``, the
    Switch loss, averaged over the mesh."""
    n_exp = mesh.shape[AXIS]
    devs = [mesh.device_at(**{AXIS: r}) for r in range(n_exp)]

    def fn(params: MoEParams, x: torch.Tensor):
        experts = _expert_views(params, n_exp, AXIS)
        shards = torch.tensor_split(x, n_exp, dim=0)
        routes, sent = [], []
        for s, xs in enumerate(shards):
            xs = xs.to(devs[s])
            capacity = max(1, int(capacity_factor * k * xs.shape[0]
                                  / n_exp))
            gates = torch.softmax(xs @ params.wg.to(devs[s]), dim=-1)
            route = _top_k_route(gates, k, capacity)
            routes.append((route, _aux(route, gates, n_exp), capacity))
            sent.append([_bucket(xs, route, e, capacity)
                         for e in range(n_exp)])
        # all-to-all: rank e holds every source's bucket for expert e
        back = [[None] * n_exp for _ in range(n_exp)]
        for e, ex in enumerate(experts):
            ex = tuple(w.to(devs[e]) for w in ex)
            got = torch.stack([sent[s][e].to(devs[e])
                               for s in range(n_exp)])
            out = _expert(*ex, got, activation)
            for s in range(n_exp):  # the return trip
                back[s][e] = out[s].to(devs[s])
        ys = []
        for s, (route, _, capacity) in enumerate(routes):
            outs = torch.stack(back[s])  # (E, C, D) by expert
            flat = torch.cat([outs.reshape(-1, outs.shape[-1]),
                              outs.new_zeros((1, outs.shape[-1]))])
            sink = n_exp * capacity
            acc = None
            # every token's kept choices, combined with f32 accumulation
            # (the reference's one einsum over (E, C))
            for idx, slot, keep, w in zip(route.idx, route.slot, route.keep,
                                          route.weight):
                pick = torch.where(keep, idx * capacity + slot,
                                   torch.full_like(slot, sink))
                v = flat[pick].float() * w.float()[:, None]
                acc = v if acc is None else acc + v
            ys.append(acc.to(x.dtype).to(x.device))
        aux = torch.stack([a.to(x.device) for _, a, _ in routes]).mean()
        return torch.cat(ys, dim=0), aux

    return fn


def _moe_select(gates, outs, k: int):
    """Each row's top-``k`` experts' outputs ``outs`` (E, T, D), weighted
    by their renormalized gates and summed in choice order (ties to the
    lower expert id: a stable sort)."""
    top_idx = torch.sort(gates, dim=1, descending=True,
                         stable=True).indices[:, :k]
    top_gates = gates.gather(1, top_idx)
    if k > 1:  # k=1 keeps the raw gate multiplier (Switch)
        top_gates = top_gates / top_gates.sum(dim=1, keepdim=True)
    rows = torch.arange(gates.shape[0], device=gates.device)
    y = None
    for j in range(k):
        v = top_gates[:, j, None] * outs[top_idx[:, j], rows]
        y = v if y is None else y + v
    return y


def moe_reference(params: MoEParams, x: torch.Tensor, *, k: int = 2,
                  activation=relu) -> torch.Tensor:
    """The single-device MoE without a capacity (the reference's
    ``moe_reference``): every token through its true top-k experts,
    ``x`` (T, D) -> (T, D). Every expert runs over every row, then each
    row takes its chosen outputs, weighted and summed in choice order."""
    gates = torch.softmax(x @ params.wg, dim=-1)
    h = activation(torch.matmul(x, params.w1) + params.b1[:, None])
    outs = torch.matmul(h, params.w2) + params.b2[:, None]  # (E, T, D)
    return _moe_select(gates, outs, k)


def moe_reference_shard(x: torch.Tensor, wg: torch.Tensor, experts, devices,
                        *, k: int = 2, activation=relu) -> torch.Tensor:
    """:func:`moe_reference` with the experts on their ranks: ``experts``
    the ranks' stacked ``(w1 (e, D, H), b1, w2, b2)`` on ``devices``, rank
    order. Each rank runs its experts over every row of ``x`` (T, D); the
    outputs are gathered on x's device in expert order (an exact
    concatenation) and each row takes its top-k there, as the whole
    function does. The decode programs over the training layout run it."""
    gates = torch.softmax(x @ wg.to(x.device), dim=-1)
    outs = []
    for (w1, b1, w2, b2), dev in zip(experts, devices):
        h = activation(torch.matmul(x.to(dev), w1) + b1[:, None])
        outs.append((torch.matmul(h, w2) + b2[:, None]).to(x.device))
    return _moe_select(gates, torch.cat(outs, dim=0), k)
