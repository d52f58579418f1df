"""Weights made from ``--seed`` on the device, one large draw a leaf.

The tree is the program's own (``param_shapes``). Each leaf has a
generator of its own, seeded from the run's seed and the leaf's index, so
one leaf can be made again alone (the training check does, to take the
change of each leaf without holding a second copy of the model). The same
seed on the same device gives the same values, so the reference gets
exactly what the program got.

Matrices are normal with the program's scales (1/sqrt(d), 1/sqrt(d_ff) for
the MLP's output, 0.02 for the embeddings); norm scales are 1 + N(0,
0.02^2) and biases N(0, 0.02^2), not 1 and 0, so that a dropped bias or
scale shows in the check.
"""

from __future__ import annotations

import math

import torch


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _scale(name: str, d: int, f: int) -> tuple[float, float]:
    """(mean, std) of a leaf's draw."""
    if name.endswith("_scale"):
        return 1.0, 0.02
    if name.endswith("_bias") or name in ("b1", "b2"):
        return 0.0, 0.02
    if name in ("embed", "pos"):
        return 0.0, 0.02
    return 0.0, 1.0 / math.sqrt(f if name == "w2" else d)


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 131 + index) % (1 << 63)


def make_leaf(shape, name: str, index: int, seed: int, d: int, f: int,
              device, dtype) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    mean, std = _scale(name, d, f)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    x.mul_(std).add_(mean)
    return x.to(dtype)


def make_params(shapes: dict, seed: int, d: int, f: int, device,
                dtype=torch.float32) -> dict:
    """A params tree of ``shapes`` (the program's ``param_shapes``)."""
    out: dict = {}
    for i, (path, shape) in enumerate(_leaf_paths(shapes)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = make_leaf(shape, path[-1], i, seed, d, f, device,
                                   dtype)
    return out


def remake_leaf(shapes: dict, dotted: str, seed: int, d: int, f: int,
                device, dtype=torch.float32) -> torch.Tensor:
    """Leaf ``dotted`` of :func:`make_params`' tree, made again alone."""
    for i, (path, shape) in enumerate(_leaf_paths(shapes)):
        if ".".join(path) == dotted:
            return make_leaf(shape, path[-1], i, seed, d, f, device, dtype)
    raise KeyError(dotted)
