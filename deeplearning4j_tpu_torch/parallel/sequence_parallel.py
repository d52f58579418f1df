"""Sequence parallelism: ring attention (the port of
``deeplearning4j_tpu/parallel/sequence_parallel.py``, :38-86).

Q, K and V are split over the mesh's data axis along the sequence. Each
data rank keeps its Q block and every K/V block passes it around the ring,
one step a block, accumulating exact attention by online softmax
(``ops/attention.online_softmax_block``); the causal mask comes from the
blocks' global positions. On one controller the ring's hop is a copy to
the next rank's device. ``head_axis`` keeps the heads split over a second
mesh axis (tensor parallelism): the ring then runs within each head
shard's column of ranks.

``sequence_sharded_lstm`` waits for the port's ``nn/`` LSTM.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.attention import (
    causal_bias,
    finalize_online_softmax,
    online_softmax_block,
)
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib


def ring_blocks(qs, ks, vs, causal: bool):
    """The ring over one column of data ranks: ``qs``, ``ks``, ``vs`` the
    ranks' (B, T/n, H, D) blocks, rank order, each on its rank's device.
    Step ``i`` rank ``me`` holds the K/V block of rank ``(me - i) % n``.
    Returns the ranks' output blocks."""
    n = len(qs)
    outs = []
    for me, q in enumerate(qs):
        b, t_local, h, _ = q.shape
        dev = q.device
        m = torch.full((b, h, t_local), float("-inf"), dtype=q.dtype,
                       device=dev)
        l = torch.zeros((b, h, t_local), dtype=q.dtype, device=dev)
        o = torch.zeros_like(q)
        pos_q = me * t_local + torch.arange(t_local, device=dev)
        for i in range(n):
            src = (me - i) % n
            bias = None
            if causal:
                bias = causal_bias(pos_q, src * t_local + torch.arange(
                    t_local, device=dev), q.dtype)
            m, l, o = online_softmax_block(q, ks[src].to(dev),
                                           vs[src].to(dev), m, l, o, bias)
        outs.append(finalize_online_softmax(l, o))
    return outs


def ring_attention(mesh, causal: bool = False, head_axis: str | None = None):
    """``fn(q, k, v) -> out`` over whole (B, T, H, D) tensors with T split
    over the mesh's data axis (and H over ``head_axis`` when given): exact
    attention through :func:`ring_blocks`, the output whole on q's
    device."""
    axis = mesh_lib.DATA_AXIS
    n = mesh.shape[axis]
    nh = mesh.shape[head_axis] if head_axis is not None else 1

    def fn(q, k, v):
        cols = []
        for hcol, (qh, kh, vh) in enumerate(zip(
                *(torch.tensor_split(x, nh, dim=2) for x in (q, k, v)))):
            devs = [mesh.device_at(**{axis: d, **(
                {head_axis: hcol} if head_axis else {})}) for d in range(n)]
            blocks = [[x.to(dv) for x, dv in zip(torch.tensor_split(
                t, n, dim=1), devs)] for t in (qh, kh, vh)]
            cols.append(torch.cat([o.to(q.device) for o in ring_blocks(
                *blocks, causal)], dim=1))
        return torch.cat(cols, dim=2)

    return fn
