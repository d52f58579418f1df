"""Tree linear algebra (the reference's ``utils/tree_math.py``).

The solvers do their vector algebra on parameter trees (lists, tuples and
dicts of tensors) leaf by leaf; a dot product reduces each leaf, then sums
the scalars. :func:`ravel` packs a tree to one vector in the order of the
reference's ``jax.flatten_util.ravel_pytree``: list and tuple items in
order, dict entries by sorted key, each leaf in C order, so a vector
interchanges with the JAX package's when the leaves have its shapes.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

Tree = object  # a list, tuple or dict of tensors, nested


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return pytree.tree_map(fn, tree, *rest)


def leaves(tree: Tree) -> list[torch.Tensor]:
    return pytree.tree_leaves(tree)


def vdot(a: Tree, b: Tree) -> torch.Tensor:
    # summed leaf by leaf in order, as the reference's ``sum(..., start=0)``
    total = None
    for x, y in zip(leaves(a), leaves(b)):
        d = torch.dot(x.reshape(-1), y.reshape(-1))
        total = d if total is None else total + d
    return total


def add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def axpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha*x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def neg(a: Tree) -> Tree:
    return tree_map(torch.neg, a)


def norm2(a: Tree) -> torch.Tensor:
    return torch.sqrt(vdot(a, a))


def zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def ones_like(a: Tree) -> Tree:
    return tree_map(torch.ones_like, a)


def where(pred, a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def cast(a: Tree, dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), a)


def _sorted_items(tree):
    """(path, leaf) pairs in ``ravel_pytree``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in _sorted_items(tree[k]):
                yield (k, *path), leaf
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for path, leaf in _sorted_items(v):
                yield (i, *path), leaf
    else:
        yield (), tree


def _rebuild(like, parts, prefix=()):
    """A tree of ``like``'s structure whose leaf at each path is
    ``parts[path]``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, parts, (*prefix, k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, parts, (*prefix, i))
                          for i, v in enumerate(like))
    return parts[prefix]


def ravel(a: Tree) -> tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """``(vector, unravel)``: the leaves packed in the reference's order, and
    the function that cuts a vector back into a tree of ``a``'s structure,
    shapes, dtypes and devices."""
    items = list(_sorted_items(a))
    flat = torch.cat([leaf.reshape(-1) for _, leaf in items])
    specs = {path: (leaf.shape, leaf.dtype, leaf.device)
             for path, leaf in items}

    def unravel(vec: torch.Tensor) -> Tree:
        vec = torch.as_tensor(vec)
        parts, off = {}, 0
        for path, (shape, dtype, device) in specs.items():
            n = shape.numel()
            parts[path] = vec[off:off + n].reshape(shape).to(device, dtype)
            off += n
        return _rebuild(a, parts)

    return flat, unravel
