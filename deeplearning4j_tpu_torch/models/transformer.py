"""Decoder-only transformer LM — the serving slice of the port of
``deeplearning4j_tpu/models/transformer.py``.

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

Not in this slice: int8 decode (``decode_int8``) and MoE (``n_experts``)
raise ``NotImplementedError``; training, beam search, speculative decoding,
LoRA and tensor parallelism are later slices.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ops.attention import attention, dtype_scalar
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
from deeplearning4j_tpu_torch.ops.flash_decode import flash_decode_attention

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
    if cfg.decode_int8:
        raise NotImplementedError(
            "decode_int8 (int8 KV cache and the int8 mode of the decode "
            "kernel) comes with a later slice of the port"
        )
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


def params_from_jax(np_tree, cfg: TransformerConfig, device=None):
    """The reference's params pytree, given as nested dicts of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, params)``), as the port's
    tensors on ``device``. Shapes are checked against ``cfg``; int8 or MoE
    leaves raise ``NotImplementedError`` (later slices)."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(name, x, shape):
        a = np.asarray(x)
        if a.dtype == np.int8:
            raise NotImplementedError(
                f"int8-quantized leaf {name!r}: int8 decode comes with a "
                "later slice of the port"
            )
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {a.shape}, expected "
                             f"{shape}")
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    blocks_in = np_tree["blocks"]
    if "moe" in blocks_in:
        raise NotImplementedError("MoE params come with a later slice")
    shapes = _block_shapes(cfg)
    extra = set(blocks_in) - set(shapes)
    if extra:
        raise ValueError(f"unexpected block params {sorted(extra)}")
    d = cfg.d_model
    return {
        "embed": conv("embed", np_tree["embed"], (cfg.vocab_size, d)),
        "pos": conv("pos", np_tree["pos"], (cfg.max_len, d)),
        "blocks": {name: conv(name, blocks_in[name], shape)
                   for name, shape in shapes.items()},
        "lnf_scale": conv("lnf_scale", np_tree["lnf_scale"], (d,)),
        "lnf_bias": conv("lnf_bias", np_tree["lnf_bias"], (d,)),
        "head": conv("head", np_tree["head"], (d, cfg.vocab_size)),
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
    """Prompt lengths bulk prefill sends to the flash kernel (the
    reference's rule: 8-aligned and either <= 128 or a multiple of 128)."""
    return t % 8 == 0 and (t <= 128 or t % 128 == 0)


def _project_qkv(cfg: TransformerConfig, p, h_in):
    """h_in (B, T, D) -> q (B, H, T, K) and the unexpanded k, v
    (B, Hkv, T, K)."""
    b, t, d = h_in.shape
    kd = cfg.head_dim
    if cfg.kv_heads != cfg.n_heads:
        q = (h_in @ p["wq"].to(h_in.dtype).reshape(d, -1)).view(
            b, t, cfg.n_heads, kd).transpose(1, 2)
        kv = (h_in @ p["wkv"].to(h_in.dtype).reshape(d, -1)).view(
            b, t, 2, cfg.kv_heads, kd).permute(2, 0, 3, 1, 4)
        return q, kv[0], kv[1]
    qkv = (h_in @ p["wqkv"].to(h_in.dtype).reshape(d, -1)).view(
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
    h = h_in @ p["w1"].to(dt) + p["b1"].to(dt)
    h = F.gelu(h, approximate="tanh")
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


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


# -- chunked cached forward (dense attention against the cache) ----------------

def _block_chunk(cfg: TransformerConfig, x, p, kv_all, i: int, pos0):
    """One block over C consecutive cached positions (x: (B, C, D), rows
    pos0..pos0+C-1): projection, RoPE, cache write (in place), dense
    masked attention against the cache, MLP. ``pos0`` is an int or a (B,)
    tensor of per-row starts. Divides the logits by ``sqrt(kd)`` as the
    reference does (the kernels multiply by the scale instead)."""
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
    ]).to(kv_all.dtype)  # (2, B, C, Hkv*K)
    if vec_pos:
        bidx = torch.arange(b, device=x.device)[:, None]
        kv_all[i][:, bidx, _write_rows(positions, kv_all)] = rows
    else:
        kv_all[i, :, :, int(pos0):int(pos0) + c] = rows
    ck, cv = kv_all[i, 0], kv_all[i, 1]
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
    x = x + o_flat @ p["wo"].to(x.dtype).reshape(cfg.n_heads * kd, -1)
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
        return _head_logits(x, params["head"]), caches

    return forward_chunk


# -- KV-cached decode ----------------------------------------------------------

def _decode_builder(cfg: TransformerConfig):
    """Shared KV-cache decode machinery: ``(forward_one, init_caches,
    prefill, cast_params)``, as the reference's ``_decode_builder``
    (transformer.py:936) returns."""
    check_supported(cfg)
    kd = cfg.head_dim
    grp = cfg.n_heads // cfg.kv_heads

    def write_kv_rows(kv_all, i: int, pos, kv_row):
        """Write one decode step's rows ``kv_row`` (2, B, Hkv*K) into layer
        ``i`` of the stacked cache, in place. An int ``pos`` writes every
        row at that position (generate); a (B,) tensor scatters each row
        at its own position (the serving engine's per-slot depths)."""
        rows = kv_row.to(kv_all.dtype)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            bidx = torch.arange(rows.shape[1], device=rows.device)
            kv_all[i][:, bidx, _write_rows(pos, kv_all)] = rows
        else:
            kv_all[i, :, :, int(pos)] = rows
        return kv_all

    def block_decode(x, p, kv_all, i: int, pos):
        if not cfg.decode_kernel:
            # the dense path IS the C=1 chunk block (one code path)
            y, kv_all = _block_chunk(cfg, x[:, None, :], p, kv_all, i, pos)
            return y[:, 0], kv_all
        b, d = x.shape
        h_in = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
        if cfg.kv_heads != cfg.n_heads:
            q = (h_in @ p["wq"].to(x.dtype).reshape(d, -1)).view(
                b, cfg.n_heads, kd)
            kv = (h_in @ p["wkv"].to(x.dtype).reshape(d, -1)).view(
                b, 2, cfg.kv_heads, kd)
            k, v = kv[:, 0], kv[:, 1]
        else:
            qkv = (h_in @ p["wqkv"].to(x.dtype).reshape(d, -1)).view(
                b, 3, cfg.n_heads, kd)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        if cfg.rope:
            cos, sin = _rope_tables(pos, kd, x.dtype, x.device)
            if isinstance(pos, torch.Tensor) and pos.dim() == 1:
                cos, sin = cos[:, None, :], sin[:, None, :]
            q = _apply_rope(q, cos, sin)
            k = _apply_rope(k, cos, sin)
        write_kv_rows(kv_all, i, pos,
                      torch.stack([k.reshape(b, -1), v.reshape(b, -1)]))
        # query head h = kv*G + g: group into (B, G, Hkv*K), each group
        # packed head-major
        qp = (q.reshape(b, cfg.kv_heads, grp, kd).transpose(1, 2)
              .reshape(b, grp, cfg.kv_heads * kd).contiguous())
        # the kernel takes the WHOLE stacked cache and the layer index —
        # slicing here would copy a layer's cache per call
        o = flash_decode_attention(qp, kv_all, pos, cfg.kv_heads, layer=i)
        o_flat = (o.reshape(b, grp, cfg.kv_heads, kd).transpose(1, 2)
                  .reshape(b, cfg.n_heads * kd))
        x = x + o_flat @ p["wo"].to(x.dtype).reshape(cfg.n_heads * kd, -1)
        h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
        return x + _mlp(p, h_in), kv_all

    def forward_one(params, caches, token, pos):
        """One position through all layers -> (logits (B, V) f32, caches).
        ``pos`` is an int (every row at one depth) or a (B,) tensor."""
        x = (params["embed"][token] + _pos_rows(params, pos, cfg.max_len)
             ).to(cfg.compute_dtype)
        for i in range(cfg.n_layers):
            x, caches = block_decode(x, _layer(params, i), caches, i, pos)
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        return _head_logits(x, params["head"]), caches

    def cast_params(params):
        """One-time cast of the streamed weights (every block tensor and
        the head) to the compute dtype; embeddings, positions and the
        final norm stay f32."""
        out = dict(params)
        out["blocks"] = {name: a.to(cfg.compute_dtype)
                         for name, a in params["blocks"].items()}
        out["head"] = params["head"].to(cfg.compute_dtype)
        return out

    def init_caches(batch: int, total: int, device):
        """Zeroed stacked cache (nl, 2, batch, Tpad, Hkv*K): Tpad is
        ``total`` rounded up to 8 rows, or to 512 above 1024 rows."""
        if total <= 1024:
            tpad = -(-total // _DECODE_PAD_T) * _DECODE_PAD_T
        else:
            tpad = -(-total // 512) * 512
        return torch.zeros(
            (cfg.n_layers, 2, batch, tpad, cfg.kv_heads * kd),
            dtype=cfg.compute_dtype, device=device,
        )

    def prefill(params, caches, prompt, last_idx=None):
        """Bulk prefill: one causal forward over the prompt (B, Tp) writes
        rows 0..Tp-1 of every layer's cache (in place) and returns
        (caches, logits (B, V) f32) at ``last_idx`` (default Tp-1; an int
        or a (B,) tensor)."""
        b, tp = prompt.shape
        if tp == 0:
            return caches, torch.zeros((b, cfg.vocab_size),
                                       dtype=torch.float32,
                                       device=caches.device)
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
            caches[i, :, :, :tp] = torch.stack([
                k_r.transpose(1, 2).reshape(b, tp, -1),
                v_r.transpose(1, 2).reshape(b, tp, -1),
            ]).to(caches.dtype)
            k_h, v_h = _expand_kv(cfg, k_r, v_r)
            if use_flash:
                o = flash_attention(q, k_h, v_h, causal=True)
            else:
                o = attention(q, k_h, v_h, causal=True, layout="bhtd")
            x = x + o.transpose(1, 2).reshape(b, tp, -1) @ p["wo"].to(
                x.dtype).reshape(cfg.n_heads * kd, -1)
            h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
            x = x + _mlp(p, h_in)
        if last_idx is None:
            x_last = x[:, -1]
        elif isinstance(last_idx, torch.Tensor) and last_idx.dim() == 1:
            x_last = x[torch.arange(b, device=x.device), last_idx.long()]
        else:
            x_last = x[:, int(last_idx)]
        x_last = _layer_norm(x_last, params["lnf_scale"], params["lnf_bias"])
        return caches, _head_logits(x_last, params["head"])

    return forward_one, init_caches, prefill, cast_params


def _check_decode_len(cfg: TransformerConfig, tp: int, max_new: int) -> int:
    total = tp + max_new
    if total > cfg.max_len:
        raise ValueError(
            f"prompt+max_new ({total}) exceeds max_len ({cfg.max_len})"
        )
    return total


def _top_k_filter(logits, top_k: int | None):
    """Top-k threshold filter: logits below the k-th largest become -inf
    (ties at the threshold are kept, as the reference keeps them)."""
    if top_k is None:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def transformer_generate(cfg: TransformerConfig):
    """Autoregressive sampling with the KV cache. Returns
    ``generate(params, prompt, max_new, temperature=1.0, top_k=None,
    generator=None, return_logits=False) -> tokens (B, Tp + max_new)``
    (plus the (max_new, B, V) sampling logits with ``return_logits``).

    Runs on the device ``params`` live on. ``temperature=0`` decodes
    greedily (argmax, first index on ties, as the reference); sampled
    decoding draws with the explicit ``generator`` (a ``torch.Generator``
    on the params' device) — its stream is not the reference's threefry
    stream."""
    forward_one, init_caches, do_prefill, cast_params = _decode_builder(cfg)

    @torch.no_grad()
    def generate(params, prompt, max_new: int, temperature: float = 1.0,
                 top_k: int | None = None, generator=None,
                 return_logits: bool = False):
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
                probs = torch.softmax(filt / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            tok = tok.to(prompt.dtype)
            toks.append(tok)
            logits, caches = forward_one(params, caches, tok, tp + i)
        out = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1) if toks \
            else prompt
        if return_logits:
            return out, torch.stack(seen)
        return out

    return generate
