"""ResNet (CIFAR-style) with BatchNorm (the JAX package's
``models/resnet.py``): 3x3 conv / BN / relu basic blocks with identity
skips in He et al.'s CIFAR layout (stages of ``blocks_per_stage`` blocks at
16/32/64 channels, ResNet-20 by default), the stage transitions a
count-corrected 2x2 average pool, a global average pool and a dense head.

Layout: the input is the reference's NHWC image batch; inside, activations
are NCHW and conv kernels OIHW (``params_from_jax``/``params_to_jax`` carry
the reference's HWIO kernels across). Convs are stride-1 SAME (``padding``
k // 2); the 1x1 projection is there only on a channel change.

BatchNorm is written out as the reference's: statistics in f32 whatever
the compute dtype, the population variance, the running update ``momentum *
s + (1 - momentum) * batch`` (``F.batch_norm`` would keep the unbiased
variance and weigh the other way), the output cast back to the compute
dtype. The BN state is an explicit tree threaded through the step. Over a
data axis (a ``mesh``) the ranks run in lock-step and the batch statistics
are the whole batch's (``parallel.lockstep.batch_moments``): sync-BN, as
the reference's sharded step is by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    hwio_to_oihw,
    oihw_to_hwio,
)
from deeplearning4j_tpu_torch.parallel import lockstep
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
from deeplearning4j_tpu_torch.utils import tree_math as tm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    in_channels: int = 3
    #: blocks per stage (He's CIFAR recipe: depth 6n + 2; n = 3: ResNet-20)
    blocks_per_stage: int = 3
    stage_channels: tuple = (16, 32, 64)
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5


def _conv_init(key, h, w, cin, cout, device):
    """He normal fan-in init, drawn in the reference's HWIO order."""
    scale = float(np.float32(np.sqrt(2.0 / (h * w * cin))))
    return hwio_to_oihw(rng.normal(key, (h, w, cin, cout), device=device)
                        * scale)


def _bn_params(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _bn_state(c, device):
    return {"mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device)}


def init_resnet(key, cfg: ResNetConfig, device=None):
    """``(params, bn_state)`` from ``key`` (a seed or key data), the
    reference's draws in its split order, on ``device`` (the card unless
    the caller names another)."""
    dev = resolve_device(device)
    keys = iter(rng.split(key, 4 + 3 * cfg.blocks_per_stage
                          * len(cfg.stage_channels)))
    c0, cl = cfg.stage_channels[0], cfg.stage_channels[-1]
    stem_w = _conv_init(next(keys), 3, 3, cfg.in_channels, c0, dev)
    head_w = rng.normal(next(keys), (cl, cfg.num_classes), device=dev)
    # a true division by a device scalar, as the reference's jnp division
    head_w = head_w / torch.tensor(np.float32(np.sqrt(cl)), device=dev)
    params = {
        "stem": {"w": stem_w, "bn": _bn_params(c0, dev)},
        "stages": [],
        "head": {"w": head_w,
                 "b": torch.zeros((cfg.num_classes,), device=dev)},
    }
    state: dict[str, Any] = {"stem": _bn_state(c0, dev), "stages": []}
    cin = c0
    for cout in cfg.stage_channels:
        stage_p, stage_s = [], []
        for _ in range(cfg.blocks_per_stage):
            block = {
                "conv1": _conv_init(next(keys), 3, 3, cin, cout, dev),
                "bn1": _bn_params(cout, dev),
                "conv2": _conv_init(next(keys), 3, 3, cout, cout, dev),
                "bn2": _bn_params(cout, dev),
            }
            if cin != cout:
                block["proj"] = _conv_init(next(keys), 1, 1, cin, cout, dev)
            stage_p.append(block)
            stage_s.append({"bn1": _bn_state(cout, dev),
                            "bn2": _bn_state(cout, dev)})
            cin = cout
        params["stages"].append(stage_p)
        state["stages"].append(stage_s)
    return params, state


def _conv(x, w):
    # stride 1, SAME: downsampling happens in the average pool alone
    with dtypes.precision():
        return F.conv2d(x, w.to(x.dtype), padding=w.shape[-1] // 2)


def _channels(v):
    return v[None, :, None, None]


def _batch_norm(x, p, s, train: bool, momentum: float, eps: float):
    """``(y, new_state)``: f32 statistics over (N, H, W), the whole
    batch's over a data axis in lock-step; eval mode reads the running
    statistics."""
    x32 = x.float()
    if train:
        mean, var = lockstep.batch_moments(x32, (0, 2, 3))
        mean, var = mean.reshape(-1), var.reshape(-1)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
                 "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mean, var, new_s = s["mean"], s["var"], s
    y = ((x32 - _channels(mean)) * _channels(torch.rsqrt(var + eps))
         * _channels(p["scale"]) + _channels(p["bias"]))
    return y.to(x.dtype), new_s


def _avg_pool_same(h):
    """The reference's SAME 2x2 stride-2 average pool, each window divided
    by its in-bounds count (an odd side's last window holds one row)."""
    return F.avg_pool2d(h, 2, 2, ceil_mode=True)


def _forward(cfg: ResNetConfig, train: bool, params, state, x):
    """(logits f32, new_state) of an NHWC batch on the params' device."""
    policy = dtypes.get_policy()
    m, eps = cfg.bn_momentum, cfg.bn_eps
    h = x.to(policy.compute_dtype).permute(0, 3, 1, 2)
    h, stem_s = _batch_norm(_conv(h, params["stem"]["w"]),
                            params["stem"]["bn"], state["stem"], train, m,
                            eps)
    h = torch.relu(h)
    new_state = {"stem": stem_s, "stages": []}
    for si, (stage_p, stage_s) in enumerate(zip(params["stages"],
                                                state["stages"])):
        if si > 0:
            h = _avg_pool_same(h)
        ss = []
        for bp, bs in zip(stage_p, stage_s):
            y, bs1 = _batch_norm(_conv(h, bp["conv1"]), bp["bn1"], bs["bn1"],
                                 train, m, eps)
            y, bs2 = _batch_norm(_conv(torch.relu(y), bp["conv2"]),
                                 bp["bn2"], bs["bn2"], train, m, eps)
            skip = _conv(h, bp["proj"]) if "proj" in bp else h
            h = torch.relu(y + skip)
            ss.append({"bn1": bs1, "bn2": bs2})
        new_state["stages"].append(ss)
    h = h.float().mean(dim=(2, 3))  # global average pool
    with dtypes.precision():
        logits = h @ params["head"]["w"] + params["head"]["b"]
    return logits, new_state


def _on(tree, device):
    return tm.tree_map(lambda t: t.to(device), tree)


def _whole(mesh) -> bool:
    """One rank holds the whole batch."""
    return (mesh is None or (mesh.axis_size(mesh_lib.DATA_AXIS) == 1
                             and mesh.num_processes == 1))


def resnet_apply(cfg: ResNetConfig, train: bool, mesh=None):
    """``apply(params, state, x NHWC) -> (logits f32, new_state)``. With a
    data-axis ``mesh`` the batch splits over its ranks, which run in
    lock-step with whole-batch BN statistics; the logits come back whole
    on the first rank's device, the state is rank 0's (every rank's is the
    same)."""
    def apply(params, state, x):
        x = torch.as_tensor(x)
        if _whole(mesh):
            return _forward(cfg, train, params, state, x)
        xs = lockstep.shards(mesh, x)

        def rank(r: int):
            dev = xs[r].device
            return _forward(cfg, train, _on(params, dev), _on(state, dev),
                            xs[r])

        with dtypes.precision():
            outs = lockstep.run_ranks(mesh, rank, x.shape[0])
        dev = mesh.devices[0]
        return (torch.cat([logits.to(dev) for logits, _ in outs]),
                _on(outs[0][1], dev))

    return apply


def _loss_fn(cfg: ResNetConfig):
    def loss(params, state, x, y):
        logits, new_state = _forward(cfg, True, params, state, x)
        ce = -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
        return ce, new_state

    return loss


def resnet_train_step(cfg: ResNetConfig, optimizer=None, mesh=None,
                      device=None):
    """The supervised step threading the BN state: ``(step, init)`` with
    ``step(params, state, opt_state, x, y) -> (params, state, opt_state,
    loss)`` (x NHWC, labels one-hot (B, C), the loss a 0-dim tensor) and
    ``init(key) -> (params, state, opt_state)``. Over a data-axis
    ``mesh`` the gradients and losses are averaged in rank order and BN is
    synchronized; without one the step runs on ``device`` (the card unless
    the caller names another). The optimizer defaults to the reference's
    ``sgd(0.1, momentum=0.9)`` (``data_parallel.SGD``)."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import SGD

    optimizer = optimizer or SGD(0.1, momentum=0.9)
    if mesh is None:
        mesh = mesh_lib.data_parallel_mesh(devices=[resolve_device(device)])
    dev = mesh.devices[0]
    loss_fn = _loss_fn(cfg)

    def step(params, state, opt_state, x, y):
        x, y = torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev)
        xs, ys = lockstep.shards(mesh, x), lockstep.shards(mesh, y)
        args = [(_on(state, a.device), a, b) for a, b in zip(xs, ys)]
        with dtypes.precision():
            loss, grads, new_state = lockstep.value_and_grad(
                loss_fn, mesh, params, args, x.shape[0], has_aux=True)
        new_state = tm.tree_map(lambda t: t.detach().to(dev), new_state)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return tm.add(params, updates), new_state, opt_state, loss

    def init(key):
        params, state = init_resnet(key, cfg, device=dev)
        return params, state, optimizer.init(params)

    return step, init


def resnet_run_steps(cfg: ResNetConfig, optimizer=None, mesh=None,
                     device=None):
    """``run(params, state, opt_state, x, y, n) -> (params, state,
    opt_state, losses (n,))``: ``n`` steps of :func:`resnet_train_step` on
    one batch (the reference's scanned form, here a loop)."""
    step, _ = resnet_train_step(cfg, optimizer, mesh, device)

    def run(params, state, opt_state, x, y, n: int):
        losses = []
        for _ in range(n):
            params, state, opt_state, loss = step(params, state, opt_state,
                                                  x, y)
            losses.append(loss)
        return params, state, opt_state, torch.stack(losses)

    return run


def _map_convs(tree, fn):
    """``fn`` applied to the 4-D leaves (the conv kernels)."""
    return tm.tree_map(lambda t: fn(t) if t.dim() == 4 else t, tree)


def params_from_jax(params, state, device=None):
    """The reference's ``(params, bn_state)`` (arrays, e.g. numpy) as the
    port's: copies on ``device`` (the card unless the caller names
    another), conv kernels HWIO -> OIHW."""
    dev = resolve_device(device)

    def put(tree):
        return tm.tree_map(lambda a: torch.tensor(np.asarray(a), device=dev),
                           tree)

    return _map_convs(put(params), hwio_to_oihw), put(state)


def params_to_jax(params, state):
    """The inverse of :func:`params_from_jax`: host numpy trees in the
    reference's layout."""
    def host(tree):
        return tm.tree_map(lambda t: t.detach().cpu().numpy(), tree)

    return host(_map_convs(params, oihw_to_hwio)), host(state)
