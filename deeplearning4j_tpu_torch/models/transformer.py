"""Decoder-only transformer LM — the port of
``deeplearning4j_tpu/models/transformer.py``: training (forward, loss,
optimizer, single-device train step) and serving (KV-cached decode and
generate).

Layouts are the reference's, so the tests compare like with like:

- params are a dict tree with a leading ``n_layers`` axis on every block
  tensor (``wqkv (nl, D, 3, H, K)`` for MHA, ``wq (nl, D, H, K)`` +
  ``wkv (nl, D, 2, Hkv, K)`` under GQA, ``wo (nl, H, K, D)``, ...);
- the decode cache is ONE packed stacked buffer ``(n_layers, 2, B, Tpad,
  Hkv*K)`` (axis 1: K then V);
- prefill attention runs ``bhtd``.

Unlike JAX, PyTorch tensors are mutable: the cache writes here update the
cache in place (the reference's ``dynamic_update_slice``/scatter return a
new buffer that XLA aliases in place); the functions still return the cache
so call sites read like the reference's.

Prefill attention calls the flash forward kernel (``ops/flash_attention``)
when ``use_flash`` and :func:`_flash_seq_ok` hold, dense attention
otherwise; decode attention calls the flash decode kernel
(``ops/flash_decode``) when ``decode_kernel`` is set, else the dense chunk
block. The projection, MLP and head matmuls are ``torch.matmul``, as the
reference leaves them to XLA.

int8 decode (the reference's ``--int8``): :func:`quantize_decode_params`
stores the streamed weights int8 with per-output-channel scales, and
:func:`_w` dequantizes them at each use (eager PyTorch writes a dequantized
copy per use: correct, but the bytes are not yet the int8 bytes).
``decode_int8`` adds the int8 KV cache, ``{"kv": int8 (nl, 2, B, Tpad,
Hkv*K), "scale": f32 (nl, 2, B, Tpad, 1)}`` with one scale per row, and the
int8 mode of the decode kernel.

Block-paged KV (the serving engine's ``paged=True``): the cache is a pool
of fixed-size blocks, ``{"blocks": pool leaves (nl, 2, n_blocks, bs, ...),
"tables": (B, Tpad/bs) int32}``. The ``paged_*`` views move rows between
the pool and slab-shaped scratch caches; the decode step writes each new
row through the table and calls the paged decode kernel on the pool, never
gathering a slab. Block 0 is the all-zero sentinel and is re-zeroed after
every write that can reach it.

Training attention runs the flash forward and backward kernels under
``torch.autograd`` (``flash_attention_trainable``) when ``use_flash``; the
loss is the memory-fused CE (``ops/fused_ce``); ``remat`` maps to
``torch.utils.checkpoint``. The optimizer is a copy of optax's arithmetic
(``adamw``, ``clip_by_global_norm``, ``warmup_cosine_decay_schedule``), so
no optax is needed.

Decode variants: greedy and sampled ``transformer_generate``, beam search
(``transformer_beam_search``) and speculative decoding
(``transformer_speculative_generate``), all on the same decode builder.

Not in these slices: MoE (``n_experts``) and sequence parallelism raise
``NotImplementedError``; training on a mesh
(tensor parallelism, FSDP) comes with the ``torch.distributed`` slice;
LoRA and tensor-parallel serving are later slices.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ops.attention import attention, dtype_scalar
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_trainable,
)
from deeplearning4j_tpu_torch.ops.fused_ce import (
    cross_entropy_with_integer_labels,
)
from deeplearning4j_tpu_torch.ops.flash_decode import (
    _div127,
    flash_decode_attention,
    flash_decode_attention_paged,
)

_DTYPE_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_name(dtype: torch.dtype) -> str:
    for name, dt in _DTYPE_NAMES.items():
        if dt == dtype:
            return name
    raise ValueError(f"unsupported compute dtype {dtype}")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's ``TransformerConfig`` fields and JSON; see
    deeplearning4j_tpu/models/transformer.py:41 for what each one means.
    ``compute_dtype`` is a ``torch.dtype`` here, serialized by name."""

    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 256
    remat: bool = False
    remat_policy: str = "dots_no_batch"
    scan_layers: bool = True
    compute_dtype: Any = torch.float32
    n_experts: int = 0
    moe_k: int = 2
    moe_capacity_factor: float = 2.0
    aux_coef: float = 0.01
    sequence_parallel: bool = False
    use_flash: bool = False
    rope: bool = False
    n_kv_heads: int | None = None
    decode_kernel: bool = True
    decode_int8: bool = False

    def __post_init__(self):
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_kv_heads ({self.kv_heads}) must divide n_heads "
                f"({self.n_heads})"
            )

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("n_heads must divide d_model")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def to_json(self) -> str:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["compute_dtype"] = dtype_name(self.compute_dtype)
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "TransformerConfig":
        # tolerant like the reference: unknown keys are ignored, missing
        # ones take their defaults
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if "compute_dtype" in d:
            name = d["compute_dtype"]
            if name not in _DTYPE_NAMES:
                raise ValueError(f"unsupported compute dtype {name!r}")
            d["compute_dtype"] = _DTYPE_NAMES[name]
        return cls(**d)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for configurations a later slice of the port covers."""
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE (n_experts > 0) comes with a later slice of the port"
        )


def _block_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    d, h, k, f, nl = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.n_layers)
    if cfg.kv_heads == h:
        attn = {"wqkv": (nl, d, 3, h, k)}
    else:
        attn = {"wq": (nl, d, h, k), "wkv": (nl, d, 2, cfg.kv_heads, k)}
    return {
        "ln1_scale": (nl, d), "ln1_bias": (nl, d), **attn,
        "wo": (nl, h, k, d), "ln2_scale": (nl, d), "ln2_bias": (nl, d),
        "w1": (nl, d, f), "b1": (nl, f), "w2": (nl, f, d), "b2": (nl, d),
    }


def param_shapes(cfg: TransformerConfig) -> dict:
    """The float params tree of ``cfg`` with a shape tuple at every leaf:
    a restore template that allocates nothing."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    return {"embed": (v, d), "pos": (cfg.max_len, d),
            "blocks": _block_shapes(cfg), "lnf_scale": (d,),
            "lnf_bias": (d,), "head": (d, v)}


def init_params(cfg: TransformerConfig, seed: int = 0, device=None):
    """Random params in the reference's tree and scales (normal weights,
    unit norm scales, zero biases), drawn from a numpy RNG so no JAX is
    needed. The draws differ from ``init_transformer``'s: hold weights
    across the frameworks with :func:`params_from_jax` instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    s_d, s_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(dev)

    blocks = {}
    for name, shape in _block_shapes(cfg).items():
        if name.endswith("_scale"):
            blocks[name] = torch.ones(shape, device=dev)
        elif name.endswith("_bias") or name in ("b1", "b2"):
            blocks[name] = torch.zeros(shape, device=dev)
        else:
            blocks[name] = normal(shape, s_f if name == "w2" else s_d)
    return {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "pos": normal((cfg.max_len, d), 0.02),
        "blocks": blocks,
        "lnf_scale": torch.ones((d,), device=dev),
        "lnf_bias": torch.zeros((d,), device=dev),
        "head": normal((d, cfg.vocab_size), s_d),
    }


# block-weight leaves quantized for int8 decode, with the axes their
# matmuls reduce (the scale is per OUTPUT channel: max|w| over the
# contraction axes); the head contracts d (axis 0). The reference's
# _INT8_BLOCK_AXES (transformer.py:199).
_INT8_BLOCK_AXES = {
    "wqkv": (1,), "wq": (1,), "wkv": (1,),
    "wo": (1, 2), "w1": (1,), "w2": (1,),
}
_INT8_SCALES = frozenset(n + "_scale" for n in _INT8_BLOCK_AXES)


def _quantize_int8(w: torch.Tensor, axes):
    """(int8 values, f32 scales with ``axes`` kept): scale = max(max|w|,
    1e-8) / 127 and round half to even, in w's dtype, as the reference."""
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = _div127(amax.clamp_min(1e-8))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_decode_params(params, cfg: TransformerConfig):
    """Weight-only int8 quantization of the decode-streamed weights (block
    projections and MLP, the head) with per-output-channel scales: each
    quantized leaf ``name`` is stored int8 beside an f32 ``name_scale``
    leaf; embeddings, positions and norms stay float. The reference's
    ``quantize_decode_params`` (transformer.py:212). Pair it with
    ``decode_int8=True`` for the int8 KV cache too; with ``decode_int8``
    off, :func:`_w` dequantizes the weights over a float cache."""
    if cfg.n_experts:
        raise NotImplementedError(
            "int8 decode quantization does not cover MoE experts")
    blocks = dict(params["blocks"])
    for name, axes in _INT8_BLOCK_AXES.items():
        if name in blocks:
            blocks[name], blocks[name + "_scale"] = _quantize_int8(
                blocks[name], axes)
    out = dict(params)
    out["blocks"] = blocks
    out["head"], out["head_scale"] = _quantize_int8(params["head"], (0,))
    return out


def _scale_shape(shape, axes):
    return tuple(1 if i in axes else n for i, n in enumerate(shape))


def params_from_jax(np_tree, cfg: TransformerConfig, device=None):
    """The reference's params pytree, given as nested dicts of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, params)``), as the port's
    tensors on ``device``. Shapes are checked against ``cfg``. A quantized
    tree (:func:`quantize_decode_params`) keeps its int8 leaves and their
    f32 ``*_scale`` siblings; MoE leaves raise ``NotImplementedError`` (a
    later slice)."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(name, x, shape):
        a = np.asarray(x)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {a.shape}, expected "
                             f"{shape}")
        dt = np.int8 if a.dtype == np.int8 else np.float32
        return torch.from_numpy(np.array(a, dtype=dt)).to(dev)

    def quantizable(tree, name, shape, axes):
        """A leaf and, when it is int8, its scale sibling."""
        out = {name: conv(name, tree[name], shape)}
        if out[name].dtype == torch.int8:
            sname = name + "_scale"
            out[sname] = conv(sname, tree[sname], _scale_shape(shape, axes))
        return out

    blocks_in = np_tree["blocks"]
    if "moe" in blocks_in:
        raise NotImplementedError("MoE params come with a later slice")
    blocks = {}
    for name, shape in _block_shapes(cfg).items():
        blocks.update(quantizable(blocks_in, name, shape,
                                  _INT8_BLOCK_AXES.get(name, ())))
    extra = set(blocks_in) - set(blocks)
    if extra:
        raise ValueError(f"unexpected block params {sorted(extra)}")
    d = cfg.d_model
    return {
        "embed": conv("embed", np_tree["embed"], (cfg.vocab_size, d)),
        "pos": conv("pos", np_tree["pos"], (cfg.max_len, d)),
        "blocks": blocks,
        "lnf_scale": conv("lnf_scale", np_tree["lnf_scale"], (d,)),
        "lnf_bias": conv("lnf_bias", np_tree["lnf_bias"], (d,)),
        **quantizable(np_tree, "head", (d, cfg.vocab_size), (0,)),
    }


def params_to(params, device):
    """The same tree with every tensor on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


# -- shared math --------------------------------------------------------------

def _layer_norm(x, scale, bias, eps: float = 1e-5):
    """f32 statistics (population variance, eps inside the rsqrt) and f32
    affine, cast back to x's dtype — the reference's formula, as one fused
    PyTorch op."""
    d = x.shape[-1]
    return F.layer_norm(x.float(), (d,), scale.float(), bias.float(),
                        eps).to(x.dtype)


def _w(p, name: str, dtype):
    """Weight leaf ``name`` at the compute dtype; an int8 leaf is
    dequantized with its ``name_scale`` sibling (f32 product, then the
    cast), as the reference's ``_w`` (transformer.py:249)."""
    w = p[name]
    if w.dtype == torch.int8:
        return (w.float() * p[name + "_scale"]).to(dtype)
    return w.to(dtype)


def _rope_tables(positions, head_dim: int, dtype, device,
                 base: float = 10000.0):
    """(cos, sin) tables for RoPE at the given positions: (..., head_dim/2)."""
    if not isinstance(positions, torch.Tensor):
        # an int position, made on the device (no blocking upload)
        positions = torch.full((), int(positions), device=device)
    half = head_dim // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _apply_rope(x, cos, sin):
    """Rotate pairs of head-dim channels (halves convention)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


#: KV caches are padded to a multiple of this row count
_DECODE_PAD_T = 8


def _flash_seq_ok(t: int) -> bool:
    """Sequence lengths the flash kernels take from the training block
    (which raises otherwise) and bulk prefill (which falls back to dense):
    the reference's rule, 8-aligned and either <= 128 or a multiple of 128."""
    return t % 8 == 0 and (t <= 128 or t % 128 == 0)


def _project_qkv(cfg: TransformerConfig, p, h_in):
    """h_in (B, T, D) -> q (B, H, T, K) and the unexpanded k, v
    (B, Hkv, T, K)."""
    b, t, d = h_in.shape
    kd = cfg.head_dim
    if cfg.kv_heads != cfg.n_heads:
        q = (h_in @ _w(p, "wq", h_in.dtype).reshape(d, -1)).view(
            b, t, cfg.n_heads, kd).transpose(1, 2)
        kv = (h_in @ _w(p, "wkv", h_in.dtype).reshape(d, -1)).view(
            b, t, 2, cfg.kv_heads, kd).permute(2, 0, 3, 1, 4)
        return q, kv[0], kv[1]
    qkv = (h_in @ _w(p, "wqkv", h_in.dtype).reshape(d, -1)).view(
        b, t, 3, cfg.n_heads, kd).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _expand_kv(cfg: TransformerConfig, k_r, v_r):
    """GQA group-repeat (no-op for MHA): (B, Hkv, T, K) -> (B, H, T, K)."""
    g = cfg.n_heads // cfg.kv_heads
    if g == 1:
        return k_r, v_r
    return k_r.repeat_interleave(g, dim=1), v_r.repeat_interleave(g, dim=1)


def _mlp(p, h_in):
    """Dense FFN: tanh-approximated gelu, as ``jax.nn.gelu`` defaults."""
    dt = h_in.dtype
    h = h_in @ _w(p, "w1", dt) + p["b1"].to(dt)
    h = F.gelu(h, approximate="tanh")
    return h @ _w(p, "w2", dt) + p["b2"].to(dt)


def _head_logits(x, head):
    """Head matmul with f32 accumulation over the (bf16) operands: the
    operands are upcast for this one product so the logits keep f32
    precision (a bf16-output product would quantize them and create ties)."""
    return x.float() @ head.float()


def _layer(params, i: int):
    return {name: a[i] for name, a in params["blocks"].items()}


def _pos_rows(params, positions, max_len: int):
    """Learned positional rows, clamped to the table (the reference's
    ``emb_pos`` clamp / ``mode='clip'`` take)."""
    if isinstance(positions, torch.Tensor):
        return params["pos"][positions.clamp(max=max_len - 1).long()]
    return params["pos"][min(int(positions), max_len - 1)]


def _write_rows(positions, kv_all):
    """Per-row cache write positions, clamped to the last row. A live row
    is always inside the cache; a serving slot that finished with
    ``prompt + max_new == Tpad`` keeps decoding a dead token at position
    Tpad until it is retired, and its write must stay in its own slab (the
    reference's scatter drops it; the next admission rewrites the slab)."""
    return positions.long().clamp(max=kv_all.shape[3] - 1)


# -- training ------------------------------------------------------------------

def _check_trainable(cfg: TransformerConfig, mesh) -> None:
    """Raise for what the single-device training path does not cover."""
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh (data/tensor parallelism, FSDP) comes with "
            "the torch.distributed slice of the port; pass mesh=None"
        )
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE (n_experts > 0) comes with a later slice of the port"
        )
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence parallelism (ring attention) comes with the "
            "torch.distributed slice of the port"
        )
    if cfg.rope and cfg.head_dim % 2:
        raise ValueError(
            f"rope needs an even head_dim, got {cfg.head_dim} "
            f"(d_model {cfg.d_model} / n_heads {cfg.n_heads})"
        )
    if cfg.remat and cfg.remat_policy not in ("dots_no_batch", "full"):
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r} "
            "(expected 'dots_no_batch' or 'full')"
        )


def _train_block(cfg: TransformerConfig, x, p):
    """One block over the whole sequence (x: (B, T, D)), attention in the
    (B, H, T, K) layout: the reference's ``block`` (transformer.py:776)
    without its MoE and sequence-parallel branches."""
    h_in = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q, k_r, v_r = _project_qkv(cfg, p, h_in)
    b, h, t, kd = q.shape
    if cfg.rope:
        cos, sin = _rope_tables(torch.arange(t, device=x.device), kd,
                                q.dtype, x.device)
        q = _apply_rope(q, cos, sin)
        k_r = _apply_rope(k_r, cos, sin)
    k_h, v_h = _expand_kv(cfg, k_r, v_r)
    if cfg.use_flash:
        if not _flash_seq_ok(t):
            raise ValueError(
                f"use_flash needs a seq len that is a multiple of 8 and "
                f"either <= 128 or a multiple of 128, got {t}"
            )
        o = flash_attention_trainable(q, k_h, v_h, causal=True,
                                      layout="bhtd")
    else:
        o = attention(q, k_h, v_h, causal=True, layout="bhtd")
    x = x + o.transpose(1, 2).reshape(b, t, h * kd) @ p["wo"].to(
        x.dtype).reshape(h * kd, -1)
    h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    return x + _mlp(p, h_in)


#: forward ops whose outputs the "dots_no_batch" remat policy keeps: the
#: weight matmuls (the reference's ``dots_with_no_batch_dims_saveable``) and
#: the flash forward (the residuals it names "flash_out"/"flash_lse"), so the
#: backward never reruns the forward kernel. Everything else is recomputed,
#: the dense attention's batched products included (the reference also keeps
#: the dense output by name; a PyTorch policy sees ops, not names).
_SAVED_UNDER_REMAT = (
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.dl4j.flash_attn_fwd.default,
)


def _dots_no_batch_policy(ctx, func, *args, **kwargs):
    if func in _SAVED_UNDER_REMAT:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_body(cfg: TransformerConfig):
    """``body(x, p) -> x``: the block, under ``torch.utils.checkpoint`` when
    ``cfg.remat`` ("full" recomputes the whole block in the backward,
    "dots_no_batch" keeps :data:`_SAVED_UNDER_REMAT`)."""
    block = functools.partial(_train_block, cfg)
    if not cfg.remat:
        return block
    if cfg.remat_policy == "full":
        return lambda x, p: checkpoint(block, x, p, use_reentrant=False)
    context = functools.partial(create_selective_checkpoint_contexts,
                                _dots_no_batch_policy)
    return lambda x, p: checkpoint(block, x, p, use_reentrant=False,
                                   context_fn=context)


def transformer_apply(cfg: TransformerConfig, mesh=None,
                      upcast_logits: bool = True):
    """Build ``apply(params, tokens) -> (logits (B, T, V), aux_loss)``,
    causal: the reference's ``transformer_apply`` (transformer.py:726) on
    one device. ``upcast_logits=False`` keeps the logits in the compute
    dtype, for the fused CE. ``scan_layers`` is accepted and changes
    nothing: a Python loop over the layers is the only form here."""
    _check_trainable(cfg, mesh)
    body = _block_body(cfg)

    def apply(params, tokens):
        t = tokens.shape[1]
        x = (F.embedding(tokens, params["embed"]) + params["pos"][:t]).to(
            cfg.compute_dtype)
        names = list(params["blocks"])
        # one unbind per stacked leaf: its backward stacks the layers'
        # grads once instead of scattering each layer into a zero tensor
        for layer in zip(*(params["blocks"][n].unbind(0) for n in names)):
            x = body(x, dict(zip(names, layer)))
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        # the head in the compute dtype (a bf16-output product at bf16, as
        # the reference's training head; serving's _head_logits upcasts)
        logits = x @ params["head"].to(x.dtype)
        if upcast_logits:
            logits = logits.float()
        # dense blocks only (MoE raises), so the aux loss is zero
        return logits, torch.zeros((), device=x.device)

    return apply


def transformer_loss(cfg: TransformerConfig, mesh=None):
    """Next-token cross-entropy: ``loss(params, tokens)`` with tokens
    (B, T+1), through the fused CE on compute-dtype logits (the reference's
    non-sequence-parallel branch, transformer.py:926)."""
    apply = transformer_apply(cfg, mesh, upcast_logits=False)

    def loss(params, tokens):
        logits, aux = apply(params, tokens[:, :-1])
        ce = cross_entropy_with_integer_labels(logits, tokens[:, 1:]).mean()
        return ce + cfg.aux_coef * aux

    return loss


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree(pairs):
    """The nested dict of (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def value_and_grad(loss_fn, params, tokens):
    """``(loss, grads)``: the loss (a 0-dim tensor, detached) and its
    gradient with respect to every leaf of ``params``, as a tree of the same
    shape (``jax.value_and_grad`` of ``loss_fn``). Marks the leaves as
    requiring grad."""
    leaves = list(_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, tokens)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), _tree(zip((path for path, _ in leaves), grads))


# param leaves exempt from AdamW weight decay (the reference's _NO_DECAY,
# transformer.py:2108): norm scales/biases, biases and the position table
_NO_DECAY = frozenset({
    "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
    "lnf_scale", "lnf_bias", "b1", "b2", "pos",
})


def _decay_mask(params):
    """True where AdamW weight decay applies (matmul weights only), as a
    tree of the params' shape. Matched by leaf name: the stacked layer axis
    makes block biases 2-D, so a rank test would misclassify them."""
    return _tree((path, path[-1] not in _NO_DECAY)
                 for path, _ in _leaves(params))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps``; a function of the update count."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(
            f"decay_steps ({decay_steps}) must exceed warmup_steps "
            f"({warmup_steps})"
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


#: optax.adamw's moment decays and epsilon (the reference never sets them)
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw`` (``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate``), behind ``clip_by_global_norm`` when
    ``clip_norm`` is set, in the same arithmetic. The defaults are optax's
    (b1 0.9, b2 0.999, eps 1e-8, ``weight_decay`` 1e-4, every leaf
    decayed). ``learning_rate`` is a
    constant or a function of the update count, read before the update (so
    a warm-up from 0 makes the first update a no-op, as in optax).

    Unlike optax it updates the params and its state in place: the state is
    ``{"count": int, "mu": tree, "nu": tree}``."""

    learning_rate: float | Callable[[int], float]
    weight_decay: float = 1e-4
    mask: Callable[[dict], dict] | None = None
    clip_norm: float | None = None

    def init(self, params):
        zeros = [(path, torch.zeros_like(p)) for path, p in _leaves(params)]
        return {"count": 0, "mu": _tree(zeros),
                "nu": _tree((path, torch.zeros_like(z)) for path, z in zeros)}

    @torch.no_grad()
    def update_(self, params, grads, state) -> None:
        """One update of ``params`` (and ``state``) in place from ``grads``,
        a tree of the params' shape."""
        count = state["count"]
        ps = [p for _, p in _leaves(params)]
        gs = [g for _, g in _leaves(grads)]
        mus = [m for _, m in _leaves(state["mu"])]
        nus = [n for _, n in _leaves(state["nu"])]
        decays = ([d for _, d in _leaves(self.mask(params))]
                  if self.mask is not None else [True] * len(ps))
        if self.clip_norm is not None:
            # optax scales by max_norm / g_norm only at g_norm >= max_norm,
            # with no epsilon (torch's clip_grad_norm_ adds 1e-6)
            g_norm = torch.sqrt(sum(g.square().sum() for g in gs))
            keep = g_norm < self.clip_norm
            gs = [torch.where(keep, g, (g / g_norm) * self.clip_norm)
                  for g in gs]
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        b1, b2 = _ADAM_B1, _ADAM_B2
        bc1 = 1 - b1 ** (count + 1)
        bc2 = 1 - b2 ** (count + 1)
        for p, g, mu, nu, decay in zip(ps, gs, mus, nus, decays):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * g.square() + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _ADAM_EPS)
            if decay:
                u = u + self.weight_decay * p
            p.add_(u * -lr)
        state["count"] = count + 1


def lm_optimizer(peak_lr: float = 3e-4, total_steps: int = 10_000,
                 warmup_steps: int | None = None, clip_norm: float = 1.0,
                 weight_decay: float = 0.01) -> AdamW:
    """The reference's LM recipe (transformer.py:2126): global-norm clipping
    and AdamW on a linear-warmup / cosine-decay schedule, weight decay
    masked off norms, biases and the position table."""
    warmup = warmup_steps if warmup_steps is not None else max(
        1, total_steps // 20)
    sched = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak_lr, warmup_steps=warmup,
        # tiny runs (total_steps <= warmup) must still construct
        decay_steps=max(total_steps, warmup + 1), end_value=peak_lr * 0.1,
    )
    return AdamW(sched, weight_decay=weight_decay, mask=_decay_mask,
                 clip_norm=clip_norm)


def transformer_train_step(mesh, cfg: TransformerConfig, optimizer=None,
                           fsdp: bool = False, device=None):
    """The reference's ``transformer_train_step`` (transformer.py:2157) on
    one device (``mesh`` must be None). Returns ``(step, init_state,
    shard_tokens)``:

    - ``step(params, opt_state, tokens) -> (params, opt_state, loss)``
      updates params and optimizer state in place (the reference donates
      both) and returns them with the loss as a 0-dim tensor (no host sync);
    - ``init_state(seed=0) -> (params, opt_state)`` on the step's device;
    - ``shard_tokens(tokens)`` puts a (B, T+1) int array on that device.

    The default optimizer is ``AdamW(3e-4)``, as the reference defaults to
    ``optax.adamw(3e-4)``."""
    if fsdp:
        raise NotImplementedError(
            "fsdp (ZeRO-3 sharding over the data axis) comes with the "
            "torch.distributed slice of the port"
        )
    optimizer = optimizer or AdamW(3e-4)
    loss_fn = transformer_loss(cfg, mesh)
    dev = resolve_device(device)

    def init_state(seed: int = 0):
        params = init_params(cfg, seed=seed, device=dev)
        return params, optimizer.init(params)

    def shard_tokens(tokens):
        return torch.as_tensor(tokens).to(device=dev, dtype=torch.long)

    def step(params, opt_state, tokens):
        loss, grads = value_and_grad(loss_fn, params, tokens)
        optimizer.update_(params, grads, opt_state)
        return params, opt_state, loss

    return step, init_state, shard_tokens


# -- KV caches: slab or int8 dict, slab or block pool ---------------------------

def kv_map(fn, *caches):
    """Apply ``fn`` leafwise over caches of one structure: a float cache
    tensor, or the int8 ``{"kv", "scale"}`` dict (``fn`` sees the int8
    rows, then their scale planes). Returns the same structure."""
    if isinstance(caches[0], dict):
        return {k: fn(*(c[k] for c in caches)) for k in ("kv", "scale")}
    return fn(*caches)


def _kv_planes(caches):
    """(rows, scales) of a cache or pool: the int8 dict's two leaves, or a
    float tensor and None."""
    if isinstance(caches, dict):
        return caches["kv"], caches["scale"]
    return caches, None


def is_paged(caches) -> bool:
    """A block-paged cache ``{"blocks": pool, "tables": (B, bps)}``."""
    return isinstance(caches, dict) and "tables" in caches


def _quantize_rows(rows):
    """Per-row int8 quantization of new cache rows (..., Hkv*K) -> (int8
    rows, f32 scales (..., 1)): one scale over all packed heads of a row,
    the reference's ``quantize_kv_rows`` (transformer.py:955)."""
    return _quantize_int8(rows.float(), (-1,))


def _row_values(caches, rows):
    """(leaf, values) pairs for writing float ``rows`` into ``caches``:
    quantized rows and scales into an int8 dict, else the rows cast to the
    cache dtype."""
    kv, sc = _kv_planes(caches)
    if sc is None:
        return [(kv, rows.to(kv.dtype))]
    q_rows, s_rows = _quantize_rows(rows)
    return [(kv, q_rows), (sc, s_rows)]


def _layer_view(caches, i: int, dtype):
    """Layer ``i``'s K and V planes (B, Tpad, Hkv*K) at ``dtype``; an int8
    cache is dequantized (f32 product, then the cast, as the reference's
    ``_block_chunk``)."""
    kv, sc = _kv_planes(caches)
    if sc is None:
        return kv[i, 0], kv[i, 1]
    return tuple((kv[i, j].float() * sc[i, j]).to(dtype) for j in (0, 1))


# -- block-paged KV views --------------------------------------------------------
#
# The paged pool keeps KV as fixed-size blocks addressed by per-slot int32
# tables (serving/cache_pool.py PagedKVPool); entry j of a table row maps
# rows [j*bs, (j+1)*bs). These views move rows between the pool and
# slab-shaped scratch caches (prefill, chunks, the parity probe), leafwise
# over int8 dicts, in place. Block 0 is the all-zero SENTINEL: unallocated
# entries name it, rows past a slot's coverage land in it, and every write
# that can reach it re-zeroes it. The reference's paged views
# (transformer.py:1390-1454).

def paged_gather(blocks, tables):
    """Contiguous (nl, 2, B, bps*bs, ...) slab of every table row's blocks,
    in table order (sentinel entries give zero rows)."""
    idx = tables.reshape(-1).long()

    def g(x):
        nl, two, _, bs, w = x.shape
        return x[:, :, idx].reshape(nl, two, tables.shape[0],
                                    tables.shape[1] * bs, w)
    return kv_map(g, blocks)


def paged_scatter(blocks, tables, view):
    """Write a slab view back into the blocks its tables name, then re-zero
    the sentinel. Aliased blocks receive identical bytes from every
    writer."""
    idx = tables.reshape(-1).long()

    def s(x, v):
        nl, two, _, bs, w = x.shape
        x[:, :, idx] = v.reshape(nl, two, idx.numel(), bs, w)
        x[:, :, 0] = 0
        return x
    return kv_map(s, blocks, view)


def paged_slot_gather(blocks, table_row):
    """One slot's batch-1 slab: the blocks of one (bps,) table row."""
    return paged_gather(blocks, table_row[None])


def paged_slot_scatter(blocks, table_row, slab):
    """Land a batch-1 slab covering all Tpad rows (zeros past the prompt
    included, so a reused block keeps no stale row) in the blocks one
    table row names, then re-zero the sentinel."""
    return paged_scatter(blocks, table_row[None], slab)


def paged_block_copy(blocks, src: int, dst: int):
    """Copy block ``src``'s rows to block ``dst`` in every leaf (``src=0``
    zeroes ``dst``)."""
    def c(x):
        x[:, :, dst] = x[:, :, src]
        return x
    return kv_map(c, blocks)


def _paged_write_index(caches, pos):
    """Where one decode step writes in a paged cache, the same in every
    layer: (block, row) per batch row, row ``pos[b]`` living at block
    ``tables[b, pos // bs]``, row ``pos % bs``. A dead slot at pos == Tpad
    (past its table) gets the sentinel, as does an unallocated entry."""
    tables = caches["tables"]
    b, bps = tables.shape
    bs = _kv_planes(caches["blocks"])[0].shape[3]
    p = torch.as_tensor(pos, device=tables.device).long().expand(b)
    ent = p // bs
    blk = tables[torch.arange(b, device=tables.device),
                 ent.clamp(max=bps - 1)].long()
    return torch.where(ent < bps, blk, 0), p % bs


def _write_paged_rows(blocks, i: int, where, rows):
    """Write one decode step's rows (2, B, Hkv*K) into layer ``i`` of the
    pool at ``where`` (:func:`_paged_write_index`), then re-zero the
    sentinel, which dead and uncovered rows may have hit."""
    blk, row = where
    for x, v in _row_values(blocks, rows):
        x[i][:, blk, row] = v
        x[i, :, 0] = 0


# -- chunked cached forward (dense attention against the cache) ----------------

def _block_chunk(cfg: TransformerConfig, x, p, kv_all, i: int, pos0):
    """One block over C consecutive cached positions (x: (B, C, D), rows
    pos0..pos0+C-1): projection, RoPE, cache write (in place; quantized
    rows into an int8 cache), dense masked attention against the
    (dequantized) cache, MLP. ``pos0`` is an int or a (B,) tensor of
    per-row starts. Divides the logits by ``sqrt(kd)`` as the reference
    does (the kernels multiply by the scale instead)."""
    b, c, _ = x.shape
    kd = cfg.head_dim
    grp = cfg.n_heads // cfg.kv_heads
    vec_pos = isinstance(pos0, torch.Tensor) and pos0.dim() == 1
    steps = torch.arange(c, device=x.device)
    positions = (pos0.long()[:, None] + steps) if vec_pos else (
        int(pos0) + steps)
    h_in = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q, k_r, v_r = _project_qkv(cfg, p, h_in)
    if cfg.rope:
        cos, sin = _rope_tables(positions, kd, x.dtype, x.device)
        if vec_pos:  # (B, C, hd/2): per-row tables over the head axis
            cos, sin = cos[:, None], sin[:, None]
        q = _apply_rope(q, cos, sin)
        k_r = _apply_rope(k_r, cos, sin)
    rows = torch.stack([
        k_r.transpose(1, 2).reshape(b, c, -1),
        v_r.transpose(1, 2).reshape(b, c, -1),
    ])  # (2, B, C, Hkv*K)
    for buf, vals in _row_values(kv_all, rows):
        if vec_pos:
            bidx = torch.arange(b, device=x.device)[:, None]
            buf[i][:, bidx, _write_rows(positions, buf)] = vals
        else:
            buf[i, :, :, int(pos0):int(pos0) + c] = vals
    ck, cv = _layer_view(kv_all, i, x.dtype)
    tpad = ck.shape[1]
    ck4 = ck.view(b, tpad, cfg.kv_heads, kd)
    cv4 = cv.view(b, tpad, cfg.kv_heads, kd)
    qg = q.reshape(b, cfg.kv_heads, grp, c, kd)  # head = kv*G + g
    att = torch.einsum("bhgck,bthk->bhgct", qg, ck4) / dtype_scalar(
        math.sqrt(kd), x.dtype)
    mask = torch.arange(tpad, device=x.device) <= positions[..., None]
    mask = mask[:, None, None] if vec_pos else mask[None, None, None]
    att = att.masked_fill(~mask, float("-inf"))
    w_att = torch.softmax(att, dim=-1)
    o = torch.einsum("bhgct,bthk->bhgck", w_att, cv4)
    o_flat = o.permute(0, 3, 1, 2, 4).reshape(b, c, cfg.n_heads * kd)
    x = x + o_flat @ _w(p, "wo", x.dtype).reshape(cfg.n_heads * kd, -1)
    h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    return x + _mlp(p, h_in), kv_all


def _chunk_builder(cfg: TransformerConfig):
    """``forward_chunk(params, caches, toks (B, C), pos0, last_idx=None)``
    advances C positions from the int ``pos0`` through every layer against
    the cache (written in place) and returns (logits, caches): (B, C, V),
    or (B, V) at ``last_idx`` (int or (B,) tensor)."""
    check_supported(cfg)

    def forward_chunk(params, caches, toks, pos0: int, last_idx=None):
        b, c = toks.shape
        pos_rows = _pos_rows(
            params, int(pos0) + torch.arange(c, device=toks.device),
            cfg.max_len)
        x = (params["embed"][toks] + pos_rows[None]).to(cfg.compute_dtype)
        for i in range(cfg.n_layers):
            x, caches = _block_chunk(cfg, x, _layer(params, i), caches, i,
                                     pos0)
        if last_idx is not None:
            if isinstance(last_idx, torch.Tensor) and last_idx.dim() == 1:
                x = x[torch.arange(b, device=x.device), last_idx.long()]
            else:
                x = x[:, int(last_idx)]
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        return _head_logits(x, _w(params, "head", x.dtype)), caches

    return forward_chunk


# -- KV-cached decode ----------------------------------------------------------

def _decode_builder(cfg: TransformerConfig):
    """Shared KV-cache decode machinery: ``(forward_one, init_caches,
    prefill, cast_params)``, as the reference's ``_decode_builder``
    (transformer.py:936) returns. ``forward_one`` also takes a block-paged
    cache (see the module doc)."""
    check_supported(cfg)
    kd = cfg.head_dim
    grp = cfg.n_heads // cfg.kv_heads

    def write_kv_rows(kv_all, i: int, pos, kv_row):
        """Write one decode step's rows ``kv_row`` (2, B, Hkv*K) into layer
        ``i`` of the stacked cache (quantized into an int8 cache), in
        place. An int ``pos`` writes every row at that position (generate);
        a (B,) tensor scatters each row at its own position (the serving
        engine's per-slot depths)."""
        for buf, vals in _row_values(kv_all, kv_row):
            if isinstance(pos, torch.Tensor) and pos.dim() == 1:
                bidx = torch.arange(vals.shape[1], device=vals.device)
                buf[i][:, bidx, _write_rows(pos, buf)] = vals
            else:
                buf[i, :, :, int(pos)] = vals
        return kv_all

    def block_decode(x, p, kv_all, i: int, pos, where=None):
        if not cfg.decode_kernel:
            # the dense path IS the C=1 chunk block (one code path)
            y, kv_all = _block_chunk(cfg, x[:, None, :], p, kv_all, i, pos)
            return y[:, 0], kv_all
        b, d = x.shape
        h_in = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
        if cfg.kv_heads != cfg.n_heads:
            q = (h_in @ _w(p, "wq", x.dtype).reshape(d, -1)).view(
                b, cfg.n_heads, kd)
            kv = (h_in @ _w(p, "wkv", x.dtype).reshape(d, -1)).view(
                b, 2, cfg.kv_heads, kd)
            k, v = kv[:, 0], kv[:, 1]
        else:
            qkv = (h_in @ _w(p, "wqkv", x.dtype).reshape(d, -1)).view(
                b, 3, cfg.n_heads, kd)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        if cfg.rope:
            cos, sin = _rope_tables(pos, kd, x.dtype, x.device)
            if isinstance(pos, torch.Tensor) and pos.dim() == 1:
                cos, sin = cos[:, None, :], sin[:, None, :]
            q = _apply_rope(q, cos, sin)
            k = _apply_rope(k, cos, sin)
        rows = torch.stack([k.reshape(b, -1), v.reshape(b, -1)])
        # query head h = kv*G + g: group into (B, G, Hkv*K), each group
        # packed head-major
        qp = (q.reshape(b, cfg.kv_heads, grp, kd).transpose(1, 2)
              .reshape(b, grp, cfg.kv_heads * kd).contiguous())
        # the kernels take the WHOLE stacked cache or pool and the layer
        # index — slicing here would copy a layer's cache per call
        if is_paged(kv_all):
            blocks, tables = kv_all["blocks"], kv_all["tables"]
            _write_paged_rows(blocks, i, where, rows)
            kv_buf, sc_buf = _kv_planes(blocks)
            o = flash_decode_attention_paged(qp, kv_buf, tables, pos,
                                             cfg.kv_heads, layer=i,
                                             block_scales=sc_buf)
        else:
            write_kv_rows(kv_all, i, pos, rows)
            kv_buf, sc_buf = _kv_planes(kv_all)
            o = flash_decode_attention(qp, kv_buf, pos, cfg.kv_heads,
                                       layer=i, kv_scales=sc_buf)
        o_flat = (o.reshape(b, grp, cfg.kv_heads, kd).transpose(1, 2)
                  .reshape(b, cfg.n_heads * kd))
        x = x + o_flat @ _w(p, "wo", x.dtype).reshape(cfg.n_heads * kd, -1)
        h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
        return x + _mlp(p, h_in), kv_all

    def forward_one(params, caches, token, pos):
        """One position through all layers -> (logits (B, V) f32, caches).
        ``pos`` is an int (every row at one depth) or a (B,) tensor."""
        if is_paged(caches) and not cfg.decode_kernel:
            # the dense chunk block reads whole slabs: gather the view,
            # step it, scatter it back (the reference's make_paged_fwd1)
            view = paged_gather(caches["blocks"], caches["tables"])
            logits, view = forward_one(params, view, token, pos)
            paged_scatter(caches["blocks"], caches["tables"], view)
            return logits, caches
        x = (params["embed"][token] + _pos_rows(params, pos, cfg.max_len)
             ).to(cfg.compute_dtype)
        where = _paged_write_index(caches, pos) if is_paged(caches) else None
        for i in range(cfg.n_layers):
            x, caches = block_decode(x, _layer(params, i), caches, i, pos,
                                     where)
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        return _head_logits(x, _w(params, "head", x.dtype)), caches

    def cast_params(params):
        """One-time cast of the streamed float weights (every block tensor
        and the head) to the compute dtype; embeddings, positions and the
        final norm stay f32. int8 leaves and their f32 scales (NOT the
        ``ln1_scale``/``ln2_scale`` norms) pass through untouched."""
        def cast(name, a):
            if a.dtype == torch.int8 or name in _INT8_SCALES:
                return a
            return a.to(cfg.compute_dtype)
        out = dict(params)
        out["blocks"] = {name: cast(name, a)
                         for name, a in params["blocks"].items()}
        out["head"] = cast("head", params["head"])
        return out

    def init_caches(batch: int, total: int, device):
        """Zeroed stacked cache (nl, 2, batch, Tpad, Hkv*K) at the compute
        dtype, or with ``decode_int8`` the dict ``{"kv": int8, "scale":
        f32 (nl, 2, batch, Tpad, 1)}``. Tpad is ``total`` rounded up to 8
        rows, or to 512 above 1024 rows."""
        if total <= 1024:
            tpad = -(-total // _DECODE_PAD_T) * _DECODE_PAD_T
        else:
            tpad = -(-total // 512) * 512
        shape = (cfg.n_layers, 2, batch, tpad, cfg.kv_heads * kd)
        if cfg.decode_int8:
            return {
                "kv": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.zeros(shape[:4] + (1,), dtype=torch.float32,
                                     device=device),
            }
        return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)

    def prefill(params, caches, prompt, last_idx=None):
        """Bulk prefill: one causal forward over the prompt (B, Tp) writes
        rows 0..Tp-1 of every layer's cache (in place; quantized rows into
        an int8 cache, while attention uses the float k/v) and returns
        (caches, logits (B, V) f32) at ``last_idx`` (default Tp-1; an int
        or a (B,) tensor)."""
        b, tp = prompt.shape
        if tp == 0:
            return caches, torch.zeros((b, cfg.vocab_size),
                                       dtype=torch.float32,
                                       device=prompt.device)
        x = (params["embed"][prompt] + params["pos"][:tp]).to(
            cfg.compute_dtype)
        if cfg.rope:
            cos, sin = _rope_tables(
                torch.arange(tp, device=x.device), kd, cfg.compute_dtype,
                x.device)
        use_flash = cfg.use_flash and _flash_seq_ok(tp)
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            h_in = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
            q, k_r, v_r = _project_qkv(cfg, p, h_in)
            if cfg.rope:
                q = _apply_rope(q, cos, sin)
                k_r = _apply_rope(k_r, cos, sin)
            rows = torch.stack([
                k_r.transpose(1, 2).reshape(b, tp, -1),
                v_r.transpose(1, 2).reshape(b, tp, -1),
            ])
            for buf, vals in _row_values(caches, rows):
                buf[i, :, :, :tp] = vals
            k_h, v_h = _expand_kv(cfg, k_r, v_r)
            if use_flash:
                o = flash_attention(q, k_h, v_h, causal=True)
            else:
                o = attention(q, k_h, v_h, causal=True, layout="bhtd")
            x = x + o.transpose(1, 2).reshape(b, tp, -1) @ _w(
                p, "wo", x.dtype).reshape(cfg.n_heads * kd, -1)
            h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
            x = x + _mlp(p, h_in)
        if last_idx is None:
            x_last = x[:, -1]
        elif isinstance(last_idx, torch.Tensor) and last_idx.dim() == 1:
            x_last = x[torch.arange(b, device=x.device), last_idx.long()]
        else:
            x_last = x[:, int(last_idx)]
        x_last = _layer_norm(x_last, params["lnf_scale"], params["lnf_bias"])
        return caches, _head_logits(x_last, _w(params, "head", x_last.dtype))

    return forward_one, init_caches, prefill, cast_params


def _check_decode_len(cfg: TransformerConfig, tp: int, max_new: int) -> int:
    total = tp + max_new
    if total > cfg.max_len:
        raise ValueError(
            f"prompt+max_new ({total}) exceeds max_len ({cfg.max_len})"
        )
    return total


def _top_k_filter(logits, top_k: int | None):
    """Top-k threshold filter: logits below the k-th largest become -inf;
    logits EQUAL to the k-th are kept, as the reference keeps them. One
    filter for every sampler of the port (generate, speculative decoding's
    draft and verify sides, the serving engine), as in the reference
    (transformer.py:1607).

    The threshold is exact. The reference's ``approx_top_k`` flag picks
    ``lax.approx_max_k``, which XLA lowers to the exact top-k off the TPU
    (over (4, 50,304) f32 at k 40 the two thresholds are equal), so the
    exact threshold is the reference's function with or without the flag
    on any other device: recall 1.0, which meets its ~0.95 contract. The
    port's entry points accept the flag and ignore it."""
    if top_k is None:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _filtered_probs(logits, temperature: float, top_k: int | None):
    """The sampling distribution as f32 probabilities: the top-k filter,
    then the temperature softmax; at ``temperature=0`` a one-hot argmax,
    taken before any filter. Speculative decoding's draft and verify
    sides share it, so the acceptance ratio compares the filtered
    distributions the plain sampler draws from (the reference's
    ``_filtered_probs``, transformer.py:1624)."""
    logits = logits.float()
    if temperature == 0:
        return F.one_hot(logits.argmax(dim=-1), logits.shape[-1]).float()
    logits = _top_k_filter(logits, top_k)
    return torch.softmax(logits / temperature, dim=-1)


def _draw(probs, generator=None):
    """One index per row of ``probs`` (..., V), drawn with ``generator``:
    the draw ``torch.multinomial(probs, 1)`` makes (an Exp(1) variate per
    entry, then the argmax of probs / variate; same generator, same
    tokens), without multinomial's two validating host syncs. Rows must
    be finite and non-negative with a positive sum."""
    e = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / e).argmax(dim=-1)


def transformer_generate(cfg: TransformerConfig):
    """Autoregressive sampling with the KV cache. Returns
    ``generate(params, prompt, max_new, temperature=1.0, top_k=None,
    generator=None, return_logits=False, approx_top_k=False) -> tokens
    (B, Tp + max_new)`` (plus the (max_new, B, V) sampling logits with
    ``return_logits``).

    Runs on the device ``params`` live on. ``temperature=0`` decodes
    greedily (argmax, first index on ties, as the reference); sampled
    decoding draws with the explicit ``generator`` (a ``torch.Generator``
    on the params' device) — its stream is not the reference's threefry
    stream. ``approx_top_k`` is accepted and ignored: the exact threshold
    is the reference's function off the TPU (:func:`_top_k_filter`)."""
    forward_one, init_caches, do_prefill, cast_params = _decode_builder(cfg)

    @torch.no_grad()
    def generate(params, prompt, max_new: int, temperature: float = 1.0,
                 top_k: int | None = None, generator=None,
                 return_logits: bool = False, approx_top_k: bool = False):
        b, tp = prompt.shape
        total = _check_decode_len(cfg, tp, max_new)
        params = cast_params(params)
        dev = params["embed"].device
        prompt = prompt.to(dev)
        caches, logits = do_prefill(params, init_caches(b, total, dev),
                                    prompt)
        toks, seen = [], []
        for i in range(max_new):
            seen.append(logits)
            filt = _top_k_filter(logits, top_k)
            if temperature == 0:
                tok = filt.argmax(dim=-1)
            else:
                tok = _draw(torch.softmax(filt / temperature, dim=-1),
                            generator)
            tok = tok.to(prompt.dtype)
            toks.append(tok)
            logits, caches = forward_one(params, caches, tok, tp + i)
        out = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1) if toks \
            else prompt
        if return_logits:
            return out, torch.stack(seen)
        return out

    return generate


def _stable_top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    largest first, ties to the LOWER index as ``lax.top_k`` breaks them: a
    stable descending sort (``torch.topk`` promises no order among
    ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def transformer_beam_search(cfg: TransformerConfig):
    """KV-cached beam search, the reference's ``transformer_beam_search``
    (transformer.py:1530). Returns ``beam(params, prompt, beam_width,
    max_new) -> (tokens (B, W, Tp + max_new), log_probs (B, W))``, beams
    sorted best first; runs on the device ``params`` live on.

    The prompt is prefilled once at batch B and its cache rows tiled to
    B*W beams (``repeat_interleave``). Each step scores the W*V
    continuations of every batch row, keeps the top W (ties to the lower
    flat index, as ``lax.top_k``), reorders the token history and every
    cache leaf (both int8 planes in ``decode_int8`` mode) to the surviving
    parents, and decodes the W new tokens as one batch of B*W rows. At
    the first step beams 1..W-1 score -inf, so all W picks come from beam
    0. The final order is a stable sort of the scores."""
    forward_one, init_caches, do_prefill, cast_params = _decode_builder(cfg)

    @torch.no_grad()
    def beam(params, prompt, beam_width: int, max_new: int):
        b, tp = prompt.shape
        w, v = int(beam_width), cfg.vocab_size
        total = _check_decode_len(cfg, tp, max_new)
        params = cast_params(params)
        dev = params["embed"].device
        prompt = prompt.to(dev)
        caches, logits = do_prefill(params, init_caches(b, total, dev),
                                    prompt)
        # (nl, 2, B*W, Tpad, ...): beam j of row r at r*W + j
        caches = kv_map(lambda a: a.repeat_interleave(w, dim=2), caches)
        logp = torch.log_softmax(logits, dim=-1)[:, None].expand(b, w, v)
        scores = torch.full((b, w), float("-inf"), device=dev)
        scores[:, 0] = 0.0
        tokens = torch.zeros((b, w, max_new), dtype=prompt.dtype,
                             device=dev)
        rows = torch.arange(b, device=dev)[:, None] * w
        for i in range(max_new):
            cand = (scores[:, :, None] + logp).reshape(b, w * v)
            scores, flat_idx = _stable_top_k(cand, w)
            parent = flat_idx // v
            tok = (flat_idx % v).to(tokens.dtype)
            tokens = torch.take_along_dim(tokens, parent[:, :, None], dim=1)
            tokens[:, :, i] = tok
            # a new contiguous stacked cache: the decode kernel takes the
            # whole buffer, not a view
            flat_parent = (rows + parent).reshape(-1)
            caches = kv_map(lambda a: a.index_select(2, flat_parent), caches)
            logits, caches = forward_one(params, caches, tok.reshape(-1),
                                         tp + i)
            logp = torch.log_softmax(logits, dim=-1).reshape(b, w, v)
        order = torch.argsort(-scores, dim=1, stable=True)
        scores = torch.take_along_dim(scores, order, dim=1)
        tokens = torch.take_along_dim(tokens, order[:, :, None], dim=1)
        full = torch.cat([prompt[:, None].expand(b, w, tp), tokens], dim=2)
        return full, scores

    return beam


def _accept_round(ps, qs, ds, u, pick):
    """One round's rejection sampling (the reference's, transformer.py:
    2012-2040): draft tokens ``ds`` (B, k) drawn from the draft's ``qs``
    (B, k, V), the target's ``ps`` (B, k+1, V) over the same slots plus
    the bonus slot, uniforms ``u`` (B, k). Accepts d_i while ``u * max(q,
    1e-30) < p`` (division-free ``u < p/q``); ``n`` (B,) counts the
    accepted prefix (a cumulative product). The correction token is drawn
    by ``pick`` from the residual max(p_n - q_n, 0) / Z at slot n; with
    n = k the zero-padded q row makes that p itself (the bonus token), and
    a zero residual falls back to p_n, so every row drawn from is a valid
    distribution. Returns ``(n, correction)``."""
    b, k = ds.shape
    v = ps.shape[-1]
    p_d = ps[:, :k].gather(-1, ds[..., None])[..., 0]
    q_d = qs.gather(-1, ds[..., None])[..., 0]
    accept = u * q_d.clamp_min(1e-30) < p_d
    n = accept.long().cumprod(dim=1).sum(dim=1)
    qs_pad = torch.cat([qs, qs.new_zeros((b, 1, v))], dim=1)
    at_n = n[:, None, None].expand(b, 1, v)
    pn = ps.gather(1, at_n)[:, 0]
    qn = qs_pad.gather(1, at_n)[:, 0]
    resid = (pn - qn).clamp_min(0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rs > 0, resid / rs, pn)
    return n, pick(resid)


def transformer_speculative_generate(
        cfg: TransformerConfig, draft_cfg: TransformerConfig | None = None):
    """Speculative decoding, the reference's
    ``transformer_speculative_generate`` (transformer.py:1843): a draft
    model proposes ``draft_k`` tokens, the target verifies them in one
    chunked forward, and rejection sampling keeps the output a sample of
    the target's filtered distribution as the verify program computes it
    (at temperature 0: the target's greedy chain, up to near-ties between
    the verify chunk's dense attention and the serial decode kernel). The
    production draft is the target's own weights in int8
    (``quantize_decode_params(params, cfg)`` with ``draft_cfg=None``).

    Returns ``generate(params, draft_params, prompt, max_new, draft_k=4,
    temperature=1.0, top_k=None, approx_top_k=False, generator=None,
    return_stats=False, return_logits=False) -> tokens (1, Tp +
    max_new)``; ``return_logits`` adds the verify logits each emitted
    token was taken from, (max_new, 1, V) as ``transformer_generate``
    returns its own, and ``return_stats`` then adds ``{"rounds": n,
    "accepted": [n_i per round]}``. Batch 1 only (acceptance is ragged
    across rows) and prompts of >= 2 tokens. ``approx_top_k`` is accepted
    and ignored (:func:`_top_k_filter`).

    As in the reference: caches padded by k+1 rows; a lag-one prefill
    (the last prompt token is fed by the first round), its 128-aligned
    prefix through bulk prefill (the flash kernel) and the rest through
    the chunk; each round a 2-token catch-up chunk on the draft as its
    first step (it rewrites the rows of d_k and of the last correction,
    which the draft never fed), k-1 serial draft steps (the decode
    kernel), one verify chunk over [c_prev, d_1..d_k], then
    :func:`_accept_round`. The reference keeps the cursor on the device
    inside one ``lax.while_loop``; here it is on the host: one host sync a
    round, reading the accepted count.

    Sampling draws from ``generator`` in a fixed order each round: d_1,
    the k-1 later draft tokens, u (B, k), the correction token (at
    temperature 0 only u is drawn)."""
    draft_cfg = draft_cfg or cfg
    _, t_init, t_prefill, t_cast = _decode_builder(cfg)
    t_chunk = _chunk_builder(cfg)
    d_fwd1, d_init, d_prefill, d_cast = _decode_builder(draft_cfg)
    d_chunk = _chunk_builder(draft_cfg)

    @torch.no_grad()
    def generate(params, draft_params, prompt, max_new: int,
                 draft_k: int = 4, temperature: float = 1.0,
                 top_k: int | None = None, approx_top_k: bool = False,
                 generator=None, return_stats: bool = False,
                 return_logits: bool = False):
        b, tp = prompt.shape
        if b != 1:
            raise ValueError(
                "speculative decode is the B=1 latency path (acceptance "
                "lengths are ragged across batch rows)")
        if tp < 2:
            raise ValueError(
                "speculative decode needs a prompt of >= 2 tokens (each "
                "round's first draft step is a 2-token catch-up chunk)")
        k = int(draft_k)
        if k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        total = _check_decode_len(cfg, tp, max_new)
        _check_decode_len(draft_cfg, tp, max_new)
        params = t_cast(params)
        draft_params = d_cast(draft_params)
        dev = params["embed"].device
        prompt = prompt.to(dev)
        caches_t = t_init(b, total + k + 1, dev)
        caches_d = d_init(b, total + k + 1, dev)
        pre = tp - 1
        aligned = pre - (pre % 128) if pre > 128 else pre
        if aligned:
            t_prefill(params, caches_t, prompt[:, :aligned])
            d_prefill(draft_params, caches_d, prompt[:, :aligned])
        if pre - aligned:
            rest = prompt[:, aligned:pre]
            t_chunk(params, caches_t, rest, aligned)
            d_chunk(draft_params, caches_d, rest, aligned)

        def probs(logits):
            return _filtered_probs(logits, temperature, top_k)

        def pick(p):
            if temperature == 0:
                return p.argmax(dim=-1)
            return _draw(p, generator)

        buf = torch.zeros((b, total + k + 1), dtype=prompt.dtype,
                          device=dev)
        buf[:, :tp] = prompt
        c_prev2, c_prev = prompt[:, -2], prompt[:, -1]
        pos, accepted, seen = tp, [], []
        while pos < total:
            pair = torch.stack([c_prev2, c_prev], dim=1)
            lg2, _ = d_chunk(draft_params, caches_d, pair, pos - 2)
            qs = [probs(lg2[:, 1])]
            ds = [pick(qs[0])]
            for i in range(1, k):
                lg, _ = d_fwd1(draft_params, caches_d, ds[-1], pos - 1 + i)
                qs.append(probs(lg))
                ds.append(pick(qs[-1]))
            ds_t = torch.stack(ds, dim=1).to(prompt.dtype)
            vlg, _ = t_chunk(params, caches_t,
                             torch.cat([c_prev[:, None], ds_t], dim=1),
                             pos - 1)
            u = torch.rand((b, k), generator=generator, device=dev)
            n_dev, ctok = _accept_round(probs(vlg), torch.stack(qs, dim=1),
                                        ds_t, u, pick)
            n = int(n_dev[0])  # the round's one host sync
            ctok = ctok.to(prompt.dtype)
            buf[:, pos:pos + n] = ds_t[:, :n]
            buf[:, pos + n] = ctok
            if return_logits:
                seen.append(vlg[:, :n + 1])
            # the token two behind the new cursor: d_n, or c_prev (n = 0)
            c_prev2 = ds_t[:, n - 1] if n else c_prev
            c_prev = ctok
            pos += n + 1
            accepted.append(n)
        out = [buf[:, :total]]
        if return_logits:
            out.append(torch.cat(seen, dim=1)[:, :max_new].transpose(0, 1))
        if return_stats:
            out.append({"rounds": len(accepted), "accepted": accepted})
        return out[0] if len(out) == 1 else tuple(out)

    return generate
