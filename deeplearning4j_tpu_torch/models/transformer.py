"""Decoder-only transformer LM — the port of
``deeplearning4j_tpu/models/transformer.py``: training (forward, loss,
optimizer, the train step on one device or a (data, model) mesh) and
serving (KV-cached decode and generate).

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

Batched LoRA (the reference's, for the serving engine):
:func:`init_lora_bank` stacks N adapters' low-rank factors for the q
projection and the MLP's w1 projection; the decode, chunk and prefill
passes take ``adapter`` (B,) int rows with the bank riding in
``params["lora"]`` and add each row's delta (:func:`_lora_delta`): the q
delta before RoPE, the MLP delta before the gelu, both outside attention,
so decode keeps the decode kernels. Rows with adapter 0 SELECT the base
activations (``torch.where``, never ``+ 0.0``, which would flip -0.0
bits), so adapter 0 is bitwise the base model.

Exact tensor-parallel serving (the reference's exact-TP layout,
transformer.py:366-660): :func:`serving_tp_shardings` splits every column
projection over a :class:`~..parallel.mesh.Mesh`'s model axis (wq/wqkv/wkv
on heads, w1/b1 on d_ff, the head on vocab, the LoRA B factors on their
output dim) and keeps the row projections wo and w2 replicated;
:func:`place_serving_tp_params` makes each split leaf a
:class:`~..parallel.mesh.Shards` of per-rank parts on the ranks' devices
(replicated leaves on the first device); :func:`serving_tp_cache_sharding`
splits the packed KV cache on its head-major minor dim and keeps the int8
row-scale plane whole on every rank. ``_decode_builder(cfg, tp_mesh)`` and
``_chunk_builder(cfg, tp_mesh)`` build the sharded programs. They are the
single-device programs run over the ranks' views (:func:`_views`; without
a mesh the one view is the params themselves): each rank projects its
heads and d_ff columns, writes and attends over its own KV heads (dense
attention: no kernel runs under TP, as in the reference), and every
sharded activation is gathered (:func:`_tp_replicate`, an exact
concatenation on the first device; the lone view's part as it is) before
a replicated row projection, so every reduction keeps the single-device
order: ``2 * n_layers + 1`` gathers a substep
(:func:`tp_collective_contract`). The head product runs in fixed-width
vocab column blocks (:func:`_head_cols`) at every width, so a rank's
logits are the whole product's blocks at the same shape. int8 KV rows
take one scale per row, the max over every rank's part. The LoRA B rows
a pass selects are gathered once and each delta is computed whole, in the
single-device order, then added shard-local: a small-K batched product
may pick its kernel by its output width (MKL does), so per-shard B
products would not be exact.

MoE (``n_experts > 0``): the blocks' dense MLP becomes a routed expert
FFN, params ``blocks["moe"]`` with the reference's ``MoEParams`` fields
(``wg (nl, D, E)``, ``w1 (nl, E, D, F)``, ``b1``, ``w2``, ``b2``) as a
dict. Every decode program (decode step, prefill, chunk: generate, beam,
speculative, the engine, the paged path) runs ``moe_reference`` with gelu,
dense over every expert (``parallel/expert_parallel``); training runs the
capacity-bucketed ``moe_ffn`` on a mesh, experts one a model rank, as the
reference requires.

Training on a (data, model) mesh (the reference's mesh branches,
transformer.py:726-934, 2074-2201), on one controller
(``parallel/mesh.DeviceMesh``): :func:`transformer_shardings` is the
Megatron layout (q/qkv column-parallel on heads, wo and w2 row-parallel,
w1/b1 on d_ff, embed/pos on d_model, head on vocab, experts on the model
axis) and :func:`fsdp_shardings` adds a data-axis split (ZeRO-3);
:func:`place_transformer_params` lays a tree out as
``parallel/mesh.MeshTensor`` leaves and :func:`gather_transformer_params`
makes it whole. The batch (or, with ``sequence_parallel``, the sequence)
is split over the data axis; each data row runs the block with its
replicated activations on the row's first rank and each model rank
projecting, attending (the flash kernels over its own heads) and
multiplying over its own columns; row-parallel products sum their
partials in rank order. A leaf split over the data axis is gathered at
use, and autograd hands each part its gradient; a leaf used by several
ranks sums their gradients. Sequence parallelism attends through the
data ring (``parallel/sequence_parallel``).

Generate reads a laid-out tree as it is (:class:`_MeshDecode`, the
reference's decode from its placed tree), float or int8
(:func:`place_transformer_params` lays the ``*_scale`` leaves out after
their weights): each data row decodes its prompt rows, each model rank
projects, caches and attends over its own heads (kernels #1 and #3 per
rank; with ``decode_int8`` an int8 cache a rank under the row's one
scale, and #3 under the row's q and softmax-weight scales), the
row-parallel partial products are summed in rank order and the
vocab-split logits gathered before the draw. Either axis may span
processes (``parallel/mesh.hybrid_mesh``): each process runs its own
ranks, a model axis across processes goes through the mesh module's
collectives inside the forward and backward, a leaf the data axis splits
is held in one process (ZeRO-3) and gathered at use, the ring crosses
the processes, and the train step averages the data column's gradients
and loss in one bucket. Generate gathers such a layout whole first.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from deeplearning4j_tpu_torch.device import (
    resolve_device,
    synchronize,
    upload,
)
from deeplearning4j_tpu_torch.ops import threefry
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
    _pos_vector,
    default_block_t,
    flash_decode_attention,
    flash_decode_attention_paged,
    flash_decode_int8_maxima,
)
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
from deeplearning4j_tpu_torch.parallel.expert_parallel import (
    MoEParams,
    gelu,
    moe_ffn_shard,
    moe_reference,
    moe_reference_shard,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    DeviceMesh,
    Mesh,
    MeshTensor,
    Shards,
    smap,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import ring_blocks

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


def _block_shapes(cfg: TransformerConfig) -> dict:
    """The block leaves' shapes; MoE configs nest the expert FFN under
    ``moe`` (the reference's ``MoEParams`` fields)."""
    d, h, k, f, nl = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.n_layers)
    if cfg.kv_heads == h:
        attn = {"wqkv": (nl, d, 3, h, k)}
    else:
        attn = {"wq": (nl, d, h, k), "wkv": (nl, d, 2, cfg.kv_heads, k)}
    if cfg.n_experts:
        e = cfg.n_experts
        ffn = {"moe": {"wg": (nl, d, e), "w1": (nl, e, d, f),
                       "b1": (nl, e, f), "w2": (nl, e, f, d),
                       "b2": (nl, e, d)}}
    else:
        ffn = {"w1": (nl, d, f), "b1": (nl, f), "w2": (nl, f, d),
               "b2": (nl, d)}
    return {
        "ln1_scale": (nl, d), "ln1_bias": (nl, d), **attn,
        "wo": (nl, h, k, d), "ln2_scale": (nl, d), "ln2_bias": (nl, d),
        **ffn,
    }


def param_shapes(cfg: TransformerConfig) -> dict:
    """The float params tree of ``cfg`` with a shape tuple at every leaf:
    a restore template that allocates nothing."""
    d, v = cfg.d_model, cfg.vocab_size
    return {"embed": (v, d), "pos": (cfg.max_len, d),
            "blocks": _block_shapes(cfg), "lnf_scale": (d,),
            "lnf_bias": (d,), "head": (d, v)}


def init_params(cfg: TransformerConfig, seed: int = 0, device=None):
    """Random params in the reference's tree and scales (normal weights,
    unit norm scales, zero biases), drawn from a numpy RNG so no JAX is
    needed. The draws differ from ``init_transformer``'s: hold weights
    across the frameworks with :func:`params_from_jax` instead."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    s_d, s_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(dev)

    def block_leaf(name, shape):
        if name.endswith("_scale"):
            return torch.ones(shape, device=dev)
        if name.endswith("_bias") or name in ("b1", "b2"):
            return torch.zeros(shape, device=dev)
        return normal(shape, s_f if name == "w2" else s_d)

    blocks = _tree((path, block_leaf(path[-1], shape))
                   for path, shape in _leaves(_block_shapes(cfg)))
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
    f32 ``*_scale`` siblings. The MoE leaves ``blocks["moe"]`` come as the
    reference's ``MoEParams`` (``jax.tree.map(np.asarray, ...)`` keeps the
    NamedTuple) or a dict, read by field name."""
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

    blocks_in = dict(np_tree["blocks"])
    blocks = {}
    for name, shape in _block_shapes(cfg).items():
        if name == "moe":
            if name not in blocks_in:
                raise ValueError("missing block params ['moe']")
            moe = blocks_in["moe"]
            if not isinstance(moe, dict):  # the reference's MoEParams
                moe = {f: getattr(moe, f) for f in MoEParams._fields}
            blocks["moe"] = {f: conv(f"moe.{f}", moe[f], shape[f])
                             for f in MoEParams._fields}
            continue
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


#: the batched-LoRA bank's leaves: (nl, N, in, rank) then (nl, N, rank, out)
_LORA_LEAVES = ("a_q", "b_q", "a_mlp", "b_mlp")


def _lora_shapes(cfg: TransformerConfig, n_adapters: int, rank: int):
    nl, d = cfg.n_layers, cfg.d_model
    hk = cfg.n_heads * cfg.head_dim
    return {"a_q": (nl, n_adapters, d, rank),
            "b_q": (nl, n_adapters, rank, hk),
            "a_mlp": (nl, n_adapters, d, rank),
            "b_mlp": (nl, n_adapters, rank, cfg.d_ff)}


def init_lora_bank(key, cfg: TransformerConfig, n_adapters: int, rank: int,
                   scale: float = 0.5, device=None):
    """The reference's ``init_lora_bank`` (transformer.py:661): N adapters'
    (A, B) factors for the q projection and the MLP's w1 projection of every
    layer, stacked so one decode step gathers each slot's rows by index::

        a_q   (nl, N, d_model, r)    b_q   (nl, N, r, n_heads*head_dim)
        a_mlp (nl, N, d_model, r)    b_mlp (nl, N, r, d_ff)

    f32 at rest; row 0 is the zero adapter; rows 1..N-1 are ``scale``
    times standard normals, both factors nonzero so adapters differ out of
    the box. ``key`` (a seed or key data) is split 4 ways, one key a
    leaf, and the normals are JAX's: sqrt(2) * erfinv(u), u uniform on
    [nextafter(-1, 0), 1) from the threefry bits. Bits and uniforms are
    bitwise ``jax.random``'s; erfinv is the library's, which can differ
    from XLA's in the last ulps."""
    if cfg.n_experts:
        raise ValueError("batched LoRA does not support MoE configs")
    if n_adapters < 2:
        raise ValueError(f"n_adapters must be >= 2 (index 0 is the zero "
                         f"adapter), got {n_adapters}")
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    dev = resolve_device(device)
    ks = threefry.split(threefry.as_key(key), 4)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    sqrt2 = float(np.float32(np.sqrt(2.0)))

    def factor(k, shape):
        u = threefry.uniform(k, shape, float(lo), 1.0)
        a = float(np.float32(scale)) * (sqrt2 * torch.erfinv(u))
        a[:, 0] = 0.0  # adapter 0 = the zero adapter
        return a.to(dev)

    return {name: factor(k, shape) for k, (name, shape) in zip(
        ks, _lora_shapes(cfg, n_adapters, rank).items())}


def lora_bank_from_jax(np_tree, cfg: TransformerConfig, device=None):
    """The reference's LoRA bank (``init_lora_bank``), given as a dict of
    numpy arrays, as the port's f32 tensors on ``device``; shapes are
    checked against ``cfg``."""
    dev = resolve_device(device)
    a = np.asarray(np_tree["a_q"])
    if a.ndim != 4:
        raise ValueError(f"lora a_q: expected (nl, N, D, r), got {a.shape}")
    want = _lora_shapes(cfg, a.shape[1], a.shape[3])
    out = {}
    for name in _LORA_LEAVES:
        x = np.asarray(np_tree[name], np.float32)
        if tuple(x.shape) != want[name]:
            raise ValueError(f"lora {name}: shape {x.shape}, expected "
                             f"{want[name]}")
        out[name] = torch.from_numpy(np.array(x)).to(dev)
    return out


def _lora_delta(h_in, a, b):
    """Per-row low-rank delta: activations ``h_in`` (B, T, D) through each
    row's gathered factors ``a`` (B, D, r) and ``b`` (B, r, O) -> (B, T, O):
    two thin batched products over rank r (the reference's two einsums,
    transformer.py:716)."""
    dt = h_in.dtype
    return torch.bmm(torch.bmm(h_in, a.to(dt)), b.to(dt))


def _lora_select(params, adapter, tp_mesh=None):
    """Each row's LoRA factors in every layer, gathered once a forward pass
    (``{leaf: (nl, B, ...)}``, one gather a leaf), and the rows that take a
    delta (adapter != 0); None without ``adapter`` or without a bank. A
    sharded B factor's rows are gathered whole on the mesh's first device
    (one :meth:`~..parallel.mesh.Mesh.gather` a factor)."""
    if adapter is None or "lora" not in params:
        return None
    idx = adapter.long()
    rows = {}
    for name, a in params["lora"].items():
        if isinstance(a, Shards):
            rows[name] = _tp_replicate([s[:, idx.to(s.device)] for s in a],
                                       tp_mesh)
        else:
            rows[name] = a[:, idx]
    return rows, adapter > 0


def _lora_q(cfg: TransformerConfig, q, h_in, lora, i: int):
    """Add each row's q delta (layer ``i`` of ``lora``, from
    :func:`_lora_select`) to ``q`` (B, H, T, K), before RoPE; adapter-0
    rows keep ``q``'s bits."""
    rows, sel = lora
    b, t = h_in.shape[:2]
    dq = _lora_delta(h_in, rows["a_q"][i], rows["b_q"][i]).view(
        b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    return torch.where(sel[:, None, None, None], q + dq, q)


def params_to(params, device):
    """The same tree with every tensor on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


# -- exact tensor-parallel serving: the layout ----------------------------------
#
# A layout is a tree of the params' (or the cache's) shape whose leaves are
# an int, the axis split over the mesh's model axis, or None, replicated.

def serving_tp_shardings(mesh: Mesh, cfg: TransformerConfig,
                         lora: bool = False):
    """The exact-TP serving layout (the reference's, transformer.py:366):
    every column projection split, every row projection replicated. wq,
    wqkv and wkv split on heads, w1 and b1 on d_ff, the head on vocab and,
    with ``lora``, the B factors on their output dim (b_q's packed heads
    head-major, as wq; b_mlp on d_ff, as w1); wo, w2, the norms, biases,
    embeddings and A factors stay whole. Raises ``ValueError`` unless tp
    divides n_heads and kv_heads, and for MoE."""
    tp = mesh.size
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"exact-TP serving needs tp ({tp}) dividing n_heads "
            f"({cfg.n_heads}) and kv_heads ({cfg.kv_heads})")
    if cfg.n_experts:
        raise ValueError("exact-TP serving does not support MoE configs")
    attn = ({"wq": 2, "wkv": 3} if cfg.kv_heads != cfg.n_heads
            else {"wqkv": 3})
    out = {
        "embed": None, "pos": None,
        "blocks": {"ln1_scale": None, "ln1_bias": None, **attn,
                   "wo": None, "ln2_scale": None, "ln2_bias": None,
                   "w1": 2, "b1": 1, "w2": None, "b2": None},
        "lnf_scale": None, "lnf_bias": None, "head": 1,
    }
    if lora:
        out["lora"] = {"a_q": None, "b_q": 3, "a_mlp": None, "b_mlp": 3}
    return out


def _quantized_leaf_sharding(axis, axes):
    """An int8 leaf's scale follows its weight's split, but on the
    quantized (size-1) axes (the reference's, transformer.py:326)."""
    return None if axis is None or axis in axes else axis


def _copy_to(x, device):
    """An independent contiguous copy of ``x`` on ``device``."""
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


def _split(x, axis: int, mesh: Mesh) -> Shards:
    """``x`` split over the mesh on ``axis``, a part on each rank."""
    return Shards(_copy_to(p, d) for p, d in zip(
        torch.tensor_split(x, mesh.size, dim=axis), mesh.devices))


def place_serving_tp_params(mesh: Mesh, params, cfg: TransformerConfig):
    """A float or int8-quantized params tree (a LoRA bank in
    ``params["lora"]`` included) placed with :func:`serving_tp_shardings`:
    every split leaf a :class:`Shards` of per-rank parts on the ranks'
    devices, every replicated leaf on the first device. int8 ``*_scale``
    leaves follow their weight (the reference's
    ``place_serving_tp_params``, transformer.py:447)."""
    specs = serving_tp_shardings(mesh, cfg, lora="lora" in params)
    blocks = specs["blocks"]
    for name, axes in _INT8_BLOCK_AXES.items():
        if name + "_scale" in params["blocks"]:
            blocks[name + "_scale"] = _quantized_leaf_sharding(
                blocks[name], axes)
    if "head_scale" in params:
        specs["head_scale"] = _quantized_leaf_sharding(specs["head"], (0,))

    def place(tree, spec, path):
        if isinstance(tree, dict):
            extra = set(tree) - set(spec)
            if extra:
                raise ValueError(f"no TP layout for {path}{sorted(extra)}")
            return {k: place(v, spec[k], f"{path}{k}/")
                    for k, v in tree.items()}
        if spec is None:
            return tree.to(mesh.devices[0])
        return _split(tree, spec, mesh)

    return place(params, specs, "")


def serving_tp_cache_sharding(mesh: Mesh, cfg: TransformerConfig):
    """The decode cache's layout under exact TP (the reference's,
    transformer.py:470): the packed (nl, 2, B, Tpad, Hkv*K) rows split on
    their head-major minor dim, each rank its own KV heads' rows; the int8
    row-scale plane (one scale across all heads of a row) whole on every
    rank."""
    del mesh  # one model axis: the split is the same for any width
    return {"kv": 4, "scale": None} if cfg.decode_int8 else 4


def shard_cache(mesh: Mesh, caches, spec):
    """An unsharded cache (a tensor or the int8 dict) placed with
    ``spec`` (:func:`serving_tp_cache_sharding`): split leaves as
    :class:`Shards`, replicated leaves as one copy on every rank."""
    if isinstance(caches, dict):
        return {k: shard_cache(mesh, caches[k], spec[k])
                for k in ("kv", "scale")}
    if spec is None:
        return Shards(_copy_to(caches, d) for d in mesh.devices)
    return _split(caches, spec, mesh)


def unshard_cache(caches):
    """A sharded cache whole again, on its first rank's device: the rows'
    parts concatenated on the minor dim (rank order is head order), rank
    0's copy of a scale plane. An unsharded cache comes back as it is."""
    if isinstance(caches, dict):
        sc = caches["scale"]
        return {"kv": unshard_cache(caches["kv"]),
                "scale": sc[0] if isinstance(sc, Shards) else sc}
    if isinstance(caches, Shards):
        return torch.cat([p.to(caches[0].device) for p in caches], dim=-1)
    return caches


def _tp_replicate(parts, tp_mesh: Mesh | None):
    """The exact-TP gather (the reference's, transformer.py:587): a sharded
    activation's rank parts concatenated on the first device, so the row
    projection after it contracts in the single-device order. Without a
    mesh the one view's part is the whole activation, returned as it
    is."""
    return parts[0] if tp_mesh is None else tp_mesh.gather(parts)


def tp_collective_contract(cfg: TransformerConfig, n_substeps: int = 1,
                           lora: bool = False) -> dict[str, int]:
    """The gathers one TP program of ``n_substeps`` decode substeps makes
    (the reference's ``tp_collective_contract``, transformer.py:606): the
    attention output and the gelu hidden of every layer and the logits,
    ``2 * n_layers + 1`` a substep; a pass whose slots use the LoRA bank
    gathers its two B factors' rows once more. Any other count changes a
    reduction's order."""
    per = 2 * cfg.n_layers + 1 + (2 if lora else 0)
    return {"gather": n_substeps * per}


def _rank(tree, r: int):
    """Rank ``r``'s view of a tree: each :class:`Shards` leaf its ``r``-th
    part, every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: _rank(v, r) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return tree[r]
    return tree


def _views(tree, tp_mesh: Mesh | None, device):
    """The (device, view) pairs one program runs over, rank order: under
    exact TP each rank's device and :func:`_rank` view; without a mesh
    the one view, ``tree`` itself on ``device``."""
    if tp_mesh is None:
        return [(device, tree)]
    return [(d, _rank(tree, r)) for r, d in enumerate(tp_mesh.devices)]


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


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, base: float, device: str) -> torch.Tensor:
    """``base ** (-i / half)`` for i < half in f32 on ``device``: the f32
    exponent's power taken in f64 and rounded once to f32, which is what
    XLA's f32 power gives (the reference's tables, bitwise). An f32
    ``torch.pow`` is off by an ulp at some i, and the angle multiplies that
    error by the position: at position 32,767 it moved cos and sin by up
    to ~1e-5. Built once per device on the host (no device f64 op); the
    upload does not block."""
    x = -np.arange(half, dtype=np.float32) / np.float32(half)
    freqs = (float(base) ** x.astype(np.float64)).astype(np.float32)
    dev = torch.device(device)
    if dev.type == "cuda":
        return upload(freqs, dev)
    return torch.from_numpy(freqs).to(dev)


def _rope_tables(positions, head_dim: int, dtype, device,
                 base: float = 10000.0):
    """(cos, sin) tables for RoPE at the given positions: (..., head_dim/2)."""
    if not isinstance(positions, torch.Tensor):
        # an int position, made on the device (no blocking upload)
        positions = torch.full((), int(positions), device=device)
    freqs = _rope_freqs(head_dim // 2, float(base), str(torch.device(device)))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _apply_rope(x, cos, sin):
    """Rotate pairs of head-dim channels (halves convention)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


#: KV caches are padded to a multiple of this row count
_DECODE_PAD_T = 8


def _cache_rows(total: int) -> int:
    """A KV cache's rows (Tpad) for ``total`` positions: rounded up to
    :data:`_DECODE_PAD_T`, or to 512 above 1024 rows."""
    if total <= 1024:
        return -(-total // _DECODE_PAD_T) * _DECODE_PAD_T
    return -(-total // 512) * 512


def _flash_seq_ok(t: int) -> bool:
    """Sequence lengths the flash kernels take from the training block
    (which raises otherwise) and bulk prefill (which falls back to dense):
    the reference's rule, 8-aligned and either <= 128 or a multiple of 128."""
    return t % 8 == 0 and (t <= 128 or t % 128 == 0)


def _project_qkv(cfg: TransformerConfig, p, h_in):
    """h_in (B, T, D) -> q (B, H, T, K) and the unexpanded k, v
    (B, Hkv, T, K). The head counts are the weights' own: a rank's part
    of a head-split weight projects that rank's heads."""
    b, t, d = h_in.shape
    kd = cfg.head_dim
    if cfg.kv_heads != cfg.n_heads:
        q = (h_in @ _w(p, "wq", h_in.dtype).reshape(d, -1)).view(
            b, t, -1, kd).transpose(1, 2)
        kv = (h_in @ _w(p, "wkv", h_in.dtype).reshape(d, -1)).view(
            b, t, 2, -1, kd).permute(2, 0, 3, 1, 4)
        return q, kv[0], kv[1]
    qkv = (h_in @ _w(p, "wqkv", h_in.dtype).reshape(d, -1)).view(
        b, t, 3, -1, kd).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _expand_kv(cfg: TransformerConfig, k_r, v_r):
    """GQA group-repeat (no-op for MHA): (B, Hkv, T, K) -> (B, H, T, K)."""
    g = cfg.n_heads // cfg.kv_heads
    if g == 1:
        return k_r, v_r
    return k_r.repeat_interleave(g, dim=1), v_r.repeat_interleave(g, dim=1)


def _mlp(p, h_in, lora=None, i: int = 0, tp_mesh: Mesh | None = None):
    """Dense FFN: tanh-approximated gelu, as ``jax.nn.gelu`` defaults.
    ``lora`` (the rows' factors from :func:`_lora_select`; layer ``i`` is
    read) adds each row's delta to the w1 projection before the gelu,
    computed whole (the single-device order); adapter-0 rows keep the base
    activations' bits. Under exact TP (the reference's ``_mlp`` with a
    mesh, transformer.py:632) each rank projects its d_ff columns of
    w1/b1 and takes those columns of the delta, and the hidden is gathered
    before the gelu and the replicated w2. The gelu runs on the gathered
    hidden (the reference's runs before the gather): an elementwise op
    gives the same bits either way on a card, but a CPU kernel computes a
    loop's vector-width tail in scalar code, and a rank's part puts other
    elements in that tail."""
    dt = h_in.dtype
    dm = sel = None
    if lora is not None:
        rows, sel = lora
        dm = _lora_delta(h_in, rows["a_mlp"][i], rows["b_mlp"][i])
        sel = sel[:, None, None]
    hs, f0 = [], 0
    for dev, p_r in _views(p, tp_mesh, h_in.device):
        h = h_in.to(dev) @ _w(p_r, "w1", dt) + p_r["b1"].to(dt)
        if dm is not None:
            fr = h.shape[-1]
            h = torch.where(sel.to(dev), h + dm[..., f0:f0 + fr].to(dev), h)
            f0 += fr
        hs.append(h)
    h = F.gelu(_tp_replicate(hs, tp_mesh), approximate="tanh")
    return h @ _w(p, "w2", dt) + p["b2"].to(dt)


def _ffn(cfg: TransformerConfig, p, h_in, lora=None, i: int = 0,
         tp_mesh: Mesh | None = None):
    """The block's FFN in the decode programs: :func:`_mlp`, or for an
    MoE config ``moe_reference`` with gelu over the flattened rows, the
    expert weights at the activations' dtype (the reference's decode
    MoE, transformer.py:1079, :1322, :1754). The batched-LoRA bank and
    exact TP refuse MoE configs, so neither reaches the MoE branch."""
    if not cfg.n_experts:
        return _mlp(p, h_in, lora, i, tp_mesh)
    moe = MoEParams(**{k: v.to(h_in.dtype) for k, v in p["moe"].items()})
    flat = h_in.reshape(-1, h_in.shape[-1])
    return moe_reference(moe, flat, k=cfg.moe_k,
                         activation=gelu).reshape(h_in.shape)


def _head_logits(x, head):
    """Head matmul with f32 accumulation over the (bf16) operands: the
    operands are upcast for this one product so the logits keep f32
    precision (a bf16-output product would quantize them and create ties)."""
    return x.float() @ head.float()


def _cat(xs, dim: int):
    """``torch.cat`` that returns a lone tensor as it is (no copy)."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)


def _head_cols(cfg: TransformerConfig) -> int:
    """The head product's column block: the vocab over g = gcd(n_heads,
    kv_heads), the widest block that divides the vocab part of every
    width the TP layout takes (every such tp divides g), or the whole
    vocab when g does not divide it."""
    g = math.gcd(cfg.n_heads, cfg.kv_heads)
    return cfg.vocab_size // g if cfg.vocab_size % g == 0 else (
        cfg.vocab_size)


def _head(cfg: TransformerConfig, params, x, tp_mesh: Mesh | None = None,
          rowwise: bool = False):
    """The logits (..., V) f32 of the normed ``x``: the head product
    (:func:`_head_logits`) in blocks of :func:`_head_cols` vocab columns,
    each block's operands contiguous, so the product runs at one shape
    whatever the width: each rank takes its own blocks and the gathered
    logits are the single-device ones (a library picks its kernel by the
    output width, and cuBLAS picks another for a rank's narrower part).
    ``rowwise`` takes each row at M 1 (see :func:`_last_row_logits`)."""
    w = _head_cols(cfg)
    leaves = {k: params[k] for k in ("head", "head_scale") if k in params}
    parts = []
    for dev, p in _views(leaves, tp_mesh, x.device):
        head = _w(p, "head", x.dtype)
        blocks = ([head[:, c:c + w].float().contiguous()
                   for c in range(0, head.shape[-1], w)]
                  if w < cfg.vocab_size else [head])
        xr = x.to(dev)
        rows = ([xr[j:j + 1] for j in range(xr.shape[0])]
                if rowwise and xr.shape[0] > 1 else [xr])
        parts.append(_cat([_cat([_head_logits(r, hb) for hb in blocks], -1)
                           for r in rows], 0))
    return _tp_replicate(parts, tp_mesh)


def _last_row_logits(cfg: TransformerConfig, params, x, last_idx,
                     rowwise: bool = False, tp_mesh: Mesh | None = None):
    """Logits (B, V) of each row's ``last_idx`` position of ``x`` (B, T, D):
    the final norm, then the head. ``last_idx`` is an int or a (B,)
    tensor. ``rowwise`` takes the head product one row at a time, at the
    M 1 a batch-1 call runs it at: a library may reduce an M 1 and an M B
    product in different orders (an M 1 product is a matrix-vector one),
    and the batched admission programs must give each row a batch-1
    prefill's bits."""
    b = x.shape[0]
    if isinstance(last_idx, torch.Tensor) and last_idx.dim() == 1:
        x = x[torch.arange(b, device=x.device), last_idx.long()]
    else:
        x = x[:, int(last_idx)]
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return _head(cfg, params, x, tp_mesh, rowwise)


def _layer(params, i: int):
    def at(a):
        if isinstance(a, dict):  # the MoE leaves
            return {k: at(v) for k, v in a.items()}
        return Shards(x[i] for x in a) if isinstance(a, Shards) else a[i]
    return {name: at(a) for name, a in params["blocks"].items()}


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
    """Raise for a configuration the training path refuses, with the
    reference's wording (transformer.py:740-769)."""
    if (cfg.n_experts or cfg.sequence_parallel) and mesh is None:
        raise ValueError("MoE / sequence-parallel modes need a mesh")
    if cfg.use_flash and cfg.sequence_parallel:
        raise ValueError(
            "use_flash and sequence_parallel are mutually exclusive: the "
            "sequence-parallel path attends via the ring, not the local "
            "flash kernel"
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
    if cfg.n_experts and cfg.n_experts != mesh.global_size(_MODEL):
        raise ValueError(
            f"n_experts ({cfg.n_experts}) must equal the mesh's model "
            f"axis size ({mesh.global_size(_MODEL)})"
        )


def _check_flash_seq(t: int) -> None:
    if not _flash_seq_ok(t):
        raise ValueError(
            f"use_flash needs a seq len that is a multiple of 8 and "
            f"either <= 128 or a multiple of 128, got {t}"
        )


def _train_block(cfg: TransformerConfig, x, p):
    """One block over the whole sequence (x: (B, T, D)) on one device,
    attention in the (B, H, T, K) layout: the reference's ``block``
    (transformer.py:776) without its MoE and sequence-parallel branches,
    which need a mesh (:func:`_mesh_block`)."""
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
        _check_flash_seq(t)
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


# -- training on a (data, model) mesh ------------------------------------------
#
# A layout is a tree of the params' shape whose leaves are spec tuples, one
# entry a dim: the mesh axis the dim is split over, or None (the reference's
# PartitionSpecs, padded to the leaf's rank).

_DATA, _MODEL = mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def transformer_shardings(mesh: DeviceMesh, cfg: TransformerConfig):
    """The Megatron training layout over the mesh's model axis (the
    reference's ``transformer_shardings``, transformer.py:261): wqkv and
    wq column-parallel on heads, wkv on its head dim when kv_heads divides
    the axis (else whole on every rank), wo and w2 row-parallel, w1 and b1
    on d_ff, embed and pos on d_model, the head on the vocab, the experts
    one a rank with the router whole. Raises ``ValueError`` unless the
    axis divides n_heads. Sizes are the global axes' (a model axis across
    processes splits over every process of the row)."""
    tp = mesh.global_size(_MODEL)
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads ({cfg.n_heads}) must be divisible by "
                         f"the mesh's model axis ({tp})")
    split = {
        ("embed",): 1, ("pos",): 1, ("head",): 1,
        ("blocks", "wqkv"): 3, ("blocks", "wq"): 2,
        ("blocks", "wkv"): 3 if cfg.kv_heads % tp == 0 else None,
        ("blocks", "wo"): 1, ("blocks", "w1"): 2, ("blocks", "b1"): 1,
        ("blocks", "w2"): 1,
        **{("blocks", "moe", f): 1 for f in ("w1", "b1", "w2", "b2")},
    }
    return _tree((path, tuple(_MODEL if i == split.get(path) else None
                              for i in range(len(shape))))
                 for path, shape in _leaves(param_shapes(cfg)))


def fsdp_shardings(mesh: DeviceMesh, cfg: TransformerConfig):
    """:func:`transformer_shardings` with each leaf also split over the
    data axis on its first dim that the axis divides and the model axis
    leaves whole (ZeRO-3; the reference's ``fsdp_shardings``,
    transformer.py:2074). A leaf of fewer than ``2 * dp`` elements stays
    whole. ``dp`` is the global data axis: across processes a split leaf's
    shards and their AdamW state live in one process each (ZeRO-3)."""
    dp = mesh.global_size(_DATA)
    base = transformer_shardings(mesh, cfg)

    def augment(spec, shape):
        if math.prod(shape) < 2 * dp:
            return spec
        for i, (n, s) in enumerate(zip(shape, spec)):
            if s is None and n % dp == 0 and n >= dp:
                return spec[:i] + (_DATA,) + spec[i + 1:]
        return spec

    return _tree((path, augment(_at(base, path), shape))
                 for path, shape in _leaves(param_shapes(cfg)))


def _scale_spec(spec, axes):
    """An int8 leaf's scale spec: its weight's, unsplit on the quantized
    (size-1) axes (the reference's ``_quantized_leaf_sharding``,
    transformer.py:326: a scale is one value over the whole reduction, so
    it is whole along an axis its weight splits there)."""
    return tuple(None if i in axes else a for i, a in enumerate(spec))


def layout_specs(mesh: DeviceMesh, params, cfg: TransformerConfig,
                 fsdp: bool = False):
    """The spec of every leaf of ``params``: :func:`transformer_shardings`
    (or :func:`fsdp_shardings`), and for a quantized tree
    (:func:`quantize_decode_params`) each ``name_scale`` leaf its weight's
    spec through :func:`_scale_spec` over ``_INT8_BLOCK_AXES`` (wo_scale
    and w2_scale whole, w1_scale on its d_ff split, the qkv scales on
    their heads), ``head_scale`` the head's unsplit on d_model."""
    specs = (fsdp_shardings if fsdp else transformer_shardings)(mesh, cfg)
    blocks = specs["blocks"]
    for name, axes in _INT8_BLOCK_AXES.items():
        if name + "_scale" in params["blocks"]:
            blocks[name + "_scale"] = _scale_spec(blocks[name], axes)
    if "head_scale" in params:
        specs["head_scale"] = _scale_spec(specs["head"], (0,))
    return specs


def place_transformer_params(mesh: DeviceMesh, params,
                             cfg: TransformerConfig, fsdp: bool = False):
    """A float or int8-quantized params tree laid out on ``mesh`` by
    :func:`layout_specs`: every leaf a
    :class:`~..parallel.mesh.MeshTensor` whose parts are independent
    copies on their ranks' devices (a laid-out leaf is gathered whole
    first). The reference's ``place_transformer_params``
    (transformer.py:339), so int8 decode runs on the layout bf16 does."""
    specs = layout_specs(mesh, params, cfg, fsdp)

    def put(path, leaf):
        if isinstance(leaf, MeshTensor):
            leaf = leaf.whole()
        mt = mesh_lib.place(mesh, leaf.detach(), _at(specs, path))
        return mt.like(p.clone(memory_format=torch.contiguous_format)
                       for p in mt.flat())

    return _tree((path, put(path, leaf)) for path, leaf in _leaves(params))


def gather_transformer_params(params, device=None):
    """A laid-out tree whole again: each :class:`MeshTensor` leaf gathered
    on ``device`` (its mesh's first device by default), detached; any
    other leaf as it is."""
    return _tree((path, leaf.whole(device).detach()
                  if isinstance(leaf, MeshTensor) else leaf)
                 for path, leaf in _leaves(params))


def layout_bytes(tree) -> dict[tuple[int, int], int]:
    """Bytes rank ``(d, m)`` holds of a laid-out tree (params or an
    optimizer moment): its part of a split leaf, the whole of a leaf the
    layout keeps whole on it. The ranks are this process's, keyed by
    their global coordinates: the values' sum is what the process
    holds."""
    out: dict[tuple[int, int], int] = {}
    for _, leaf in _leaves(tree):
        mesh = leaf.mesh
        dp, tp = mesh.axis_size(_DATA), mesh.axis_size(_MODEL)
        d0, m0 = mesh.offset(_DATA), mesh.offset(_MODEL)
        ds = leaf.dim_of(_DATA) is not None
        ms = leaf.dim_of(_MODEL) is not None
        for d in range(dp):
            for m in range(tp):
                p = leaf.parts[d if ds else 0][m if ms else 0]
                key = (d0 + d, m0 + m)
                out[key] = out.get(key, 0) + p.numel() * p.element_size()
    return out


def _held(mt: MeshTensor):
    """A leaf as ``(rows, data_dim, model_split)``: its parts
    ``rows[data part][model part]`` (every global data part: a data axis
    across processes gathers the others' shards here, ZeRO-3's gather at
    use), the dim its data parts concatenate on (None: one row) and
    whether the model axis splits it."""
    return (mesh_lib.global_rows(mt), mt.dim_of(_DATA),
            mt.dim_of(_MODEL) is not None)


def _layer_leaves(mt: MeshTensor, n_layers: int) -> list:
    """Per layer, the :func:`_held` form of a block leaf's layer slice: a
    leaf split over the data axis on its layer dim leaves each layer to
    one data part (whole there: no gather at use)."""
    rows, dd, msplit = _held(mt)
    unb = [[p.unbind(0) for p in row] for row in rows]
    if dd == 0:
        per = rows[0][0].shape[0]
        return [([[u[i % per] for u in unb[i // per]]], None, msplit)
                for i in range(n_layers)]
    dd = None if dd is None else dd - 1
    return [([[u[i] for u in row] for row in unb], dd, msplit)
            for i in range(n_layers)]


def _local(leaf, m: int, dev):
    """Model rank ``m``'s part of a :func:`_held` leaf, gathered over the
    data axis (an exact concatenation) on ``dev``."""
    rows, dd, msplit = leaf
    j = m if msplit else 0
    if dd is None:
        return rows[0][j].to(dev)
    return torch.cat([row[j].to(dev) for row in rows], dim=dd)


#: the block leaves each model rank multiplies with (and their int8 scales)
_RANK_LEAVES = frozenset({"wqkv", "wq", "wkv", "wo", "w1", "b1", "w2"})
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def _group_kv(q, k, v):
    """A rank's k, v repeated to its query heads (head = kv*G + g)."""
    g = q.shape[1] // k.shape[1]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)


def _mesh_layer(cfg: TransformerConfig, mesh: DeviceMesh, xs: dict,
                rank_lp, row_lp, positions, attend, moe):
    """One block over data rows ``xs`` (``xs[d]`` row d's (b, C, D)
    residual stream on its first rank's device), written once for the
    training step and the decode programs over the layout.

    ``rank_lp(d, m)`` is rank (d, m)'s block leaves on its device (its
    part of a split leaf, a whole one, any ``name_scale``; with experts,
    ``"experts"``: its ``(w1, b1, w2, b2)`` as ``moe`` takes them),
    ``row_lp(d)`` the row's replicated leaves (the norms, b2; with
    experts, the router ``"wg"``) on the row's device, ``positions[d]``
    the row's (C,) global positions. Each model rank projects its own heads (RoPE applied):
    ``heads[d, m] = (q (b, hs, C, K), k, v)`` with its own KV heads, or its
    query heads' expanded KV when the layout keeps wkv whole.
    ``attend(heads)`` turns them into each rank's (b, C, hs*K) output (a
    cache write is its business). wo and w2 are row-parallel: the ranks'
    partial products are added in rank order on the row's device. The FFN
    is each rank's d_ff columns, or ``moe(h_in, wg, experts, devices) ->
    (y, aux)`` over the ranks' experts (aux None when it has none).
    Returns ``(xs, auxes)``.

    The model ranks are this process's (``m`` local, global rank
    ``mesh.offset("model") + m``); where the model axis spans processes
    the replicated inputs of the column-parallel products and the
    row-parallel sums go through ``mesh_lib.model_inputs`` and
    ``mesh_lib.model_sum``, which keep the one-process order."""
    tp = mesh.global_size(_MODEL)
    tpl, m0 = mesh.axis_size(_MODEL), mesh.offset(_MODEL)
    hs = cfg.n_heads // tp
    lps = {(d, m): rank_lp(d, m) for d in xs for m in range(tpl)}
    rows = {d: row_lp(d) for d in xs}
    heads = {}
    for d, x in xs.items():
        h_in = _layer_norm(x, rows[d]["ln1_scale"], rows[d]["ln1_bias"])
        devs = [mesh.device(d, m) for m in range(tpl)]
        for m, h_m in enumerate(mesh_lib.model_inputs(mesh, h_in, devs)):
            dev = devs[m]
            q, k, v = _project_qkv(cfg, lps[d, m], h_m)
            if cfg.rope:
                cos, sin = _rope_tables(positions[d].to(dev), cfg.head_dim,
                                        q.dtype, dev)
                q = _apply_rope(q, cos, sin)
                k = _apply_rope(k, cos, sin)
            if k.shape[1] > cfg.kv_heads // tp:
                # a whole wkv projects every KV head: keep rank m's query
                # heads' expanded KV
                g = m0 + m
                k, v = _expand_kv(cfg, k, v)
                k = k[:, g * hs:(g + 1) * hs].contiguous()
                v = v[:, g * hs:(g + 1) * hs].contiguous()
            heads[d, m] = (q, k, v)
    outs = attend(heads)
    new_xs, auxes = {}, []
    for d, x in xs.items():
        dev0, dt, row = x.device, x.dtype, rows[d]
        devs = [mesh.device(d, m) for m in range(tpl)]
        parts = []
        for m in range(tpl):
            wo = _w(lps[d, m], "wo", dt)
            parts.append(outs[d, m] @ wo.reshape(-1, wo.shape[-1]))
        x = x + mesh_lib.model_sum(mesh, parts, dev0)
        h_in = _layer_norm(x, row["ln2_scale"], row["ln2_bias"])
        if cfg.n_experts:
            y, aux = moe(h_in, row["wg"].to(dt),
                         [lps[d, m]["experts"] for m in range(tpl)], devs)
            if aux is not None:
                auxes.append(aux)
        else:
            parts = []
            for m, h_m in enumerate(mesh_lib.model_inputs(mesh, h_in,
                                                          devs)):
                lp = lps[d, m]
                hid = gelu(h_m @ _w(lp, "w1", dt) + lp["b1"].to(dt))
                parts.append(hid @ _w(lp, "w2", dt))
            y = mesh_lib.model_sum(mesh, parts, dev0) + row["b2"].to(dt)
        new_xs[d] = x + y
    return new_xs, auxes


def _mesh_block(cfg: TransformerConfig, mesh: DeviceMesh, xs, lp,
                positions):
    """One training block over every data row of the mesh
    (:func:`_mesh_layer`). ``xs[d]`` is row d's (b, t, D) residual stream
    on its first rank's device, ``lp`` the layer's :func:`_held` leaves,
    ``positions[d]`` the row's global positions (t,). Each rank attends
    over its own heads with the flash kernels over its (b, H/tp, t, K),
    the ring over the data axis under sequence parallelism, dense
    otherwise; each rank runs its own expert over its capacity bucket
    (``moe_ffn_shard``). Returns ``(xs, auxes)``: the MoE aux loss of each
    row (empty for the dense MLP)."""
    dt = xs[0].dtype

    def rank_lp(d, m):
        dev = mesh.device(d, m)
        p = {n: _local(lp[n], m, dev) for n in lp
             if n.removesuffix("_scale") in _RANK_LEAVES}
        if cfg.n_experts:
            p["experts"] = tuple(_local(lp["moe"][f], m, dev)[0].to(dt)
                                 for f in _EXPERT_LEAVES)
        return p

    def row_lp(d):
        dev0 = mesh.device(d, 0)
        p = {n: _local(lp[n], 0, dev0) for n in lp if n != "moe"
             and n.removesuffix("_scale") not in _RANK_LEAVES}
        if cfg.n_experts:
            p["wg"] = _local(lp["moe"]["wg"], 0, dev0)
        return p

    def attend(heads):
        outs = {}
        if cfg.sequence_parallel:
            for m in range(mesh.axis_size(_MODEL)):
                per = [(q, *_group_kv(q, k, v)) for q, k, v in
                       (heads[d, m] for d in range(len(xs)))]
                qkv = [[t[j].transpose(1, 2) for t in per] for j in range(3)]
                for d, o in enumerate(ring_blocks(*qkv, causal=True,
                                                  mesh=mesh)):
                    outs[d, m] = o.reshape(*o.shape[:2], -1)
            return outs
        for (d, m), (q, k, v) in heads.items():
            k, v = _group_kv(q, k, v)
            if cfg.use_flash:
                _check_flash_seq(q.shape[2])
                o = flash_attention_trainable(q, k, v, causal=True,
                                              layout="bhtd")
            else:
                o = attention(q, k, v, causal=True, layout="bhtd")
            outs[d, m] = o.transpose(1, 2).reshape(q.shape[0], q.shape[2],
                                                   -1)
        return outs

    def moe(h_in, wg, experts, devs):
        return moe_ffn_shard(h_in, wg, experts, devs, k=cfg.moe_k,
                             capacity_factor=cfg.moe_capacity_factor,
                             activation=gelu, mesh=mesh)

    out, auxes = _mesh_layer(cfg, mesh, dict(enumerate(xs)), rank_lp, row_lp,
                             positions, attend, moe)
    return list(out.values()), auxes


def _mesh_body(cfg: TransformerConfig, mesh: DeviceMesh):
    """:func:`_mesh_block`, under ``torch.utils.checkpoint`` when
    ``cfg.remat`` (as :func:`_block_body`)."""
    block = functools.partial(_mesh_block, cfg, mesh)
    if not cfg.remat:
        return block
    if cfg.remat_policy == "full":
        return lambda *a: checkpoint(block, *a, use_reentrant=False)
    context = functools.partial(create_selective_checkpoint_contexts,
                                _dots_no_batch_policy)
    return lambda *a: checkpoint(block, *a, use_reentrant=False,
                                 context_fn=context)


def _token_dim(cfg: TransformerConfig) -> int:
    """The tokens' dim split over the data axis: the sequence under
    sequence parallelism, else the batch."""
    return 1 if cfg.sequence_parallel else 0


def _token_rows(cfg: TransformerConfig, mesh: DeviceMesh, tokens):
    """Each data row's tokens on its first rank's device: the parts of a
    ``shard_tokens`` MeshTensor, or a whole (B, T) array split."""
    if not isinstance(tokens, MeshTensor):
        spec = [None, None]
        spec[_token_dim(cfg)] = _DATA
        tokens = mesh_lib.place(mesh, torch.as_tensor(tokens).to(
            device=mesh.devices[0], dtype=torch.long), spec)
    return [row[0] for row in tokens.parts]


def _laid_out(mesh: DeviceMesh, params, cfg: TransformerConfig):
    """``params`` as the mesh programs read them: a laid-out tree as it
    is, a whole one split by :func:`transformer_shardings` (views, so
    gradients reach the whole leaves)."""
    leaves = list(_leaves(params))
    if all(isinstance(leaf, MeshTensor) for _, leaf in leaves):
        return params
    specs = transformer_shardings(mesh, cfg)
    return _tree((path, mesh_lib.place(mesh, leaf, _at(specs, path)))
                 for path, leaf in leaves)


def _mesh_forward(cfg: TransformerConfig, mesh: DeviceMesh,
                  upcast_logits: bool):
    """``run(params, rows) -> (logits rows, aux)``: the transformer over
    the mesh, ``rows[d]`` data row d's tokens, its logits (b, t, V) on
    the row's first device; ``aux`` the MoE loss, summed over layers of
    the mean over the data rows (0 without experts)."""
    body = _mesh_body(cfg, mesh)

    def run(params, rows):
        params = _laid_out(mesh, params, cfg)
        embed, pos = _held(params["embed"]), _held(params["pos"])
        dsizes = params["embed"].sizes(_MODEL) if embed[2] else None
        xs, positions = [], []
        for d, tok in enumerate(rows):
            devs = mesh.model_row(d).devices
            dev0 = devs[0]
            t = tok.shape[1]
            off = ((mesh.offset(_DATA) + d) * t if cfg.sequence_parallel
                   else 0)
            emb = mesh_lib.model_cat(mesh, [
                F.embedding(tok.to(dv), _local(embed, m, dv)).to(dev0)
                for m, dv in enumerate(devs)], -1, dsizes)
            prow = mesh_lib.model_cat(mesh, [
                _local(pos, m, dv)[off:off + t].to(dev0)
                for m, dv in enumerate(devs)], -1, dsizes)
            xs.append((emb + prow).to(cfg.compute_dtype))
            positions.append(off + torch.arange(t, device=dev0))
        layers = [(path, _layer_leaves(mt, cfg.n_layers))
                  for path, mt in _leaves(params["blocks"])]
        aux = torch.zeros((), device=mesh.devices[0])
        for i in range(cfg.n_layers):
            xs, auxes = body(xs, _tree((path, ls[i]) for path, ls in layers),
                             positions)
            if auxes:
                aux = aux + torch.stack([a.to(aux.device) for a in auxes]
                                        ).mean().float()
        head, lnf_s, lnf_b = (_held(params[n]) for n in
                              ("head", "lnf_scale", "lnf_bias"))
        vsizes = params["head"].sizes(_MODEL) if head[2] else None
        logits = []
        for d, x in enumerate(xs):
            dev0 = x.device
            x = _layer_norm(x, _local(lnf_s, 0, dev0), _local(lnf_b, 0, dev0))
            devs = mesh.model_row(d).devices
            lg = mesh_lib.model_cat(mesh, [
                (h_m @ _local(head, m, dv).to(x.dtype)).to(dev0)
                for m, (dv, h_m) in enumerate(zip(
                    devs, mesh_lib.model_inputs(mesh, x, devs)))], -1,
                vsizes)
            logits.append(lg.float() if upcast_logits else lg)
        return logits, aux

    return run


def transformer_apply(cfg: TransformerConfig, mesh: DeviceMesh | None = None,
                      upcast_logits: bool = True):
    """Build ``apply(params, tokens) -> (logits (B, T, V), aux_loss)``,
    causal: the reference's ``transformer_apply`` (transformer.py:726).
    Without a mesh it runs on one device (MoE and sequence parallelism
    need a mesh, as in the reference). On a ``(data, model)`` mesh the
    params are a laid-out tree (:func:`place_transformer_params`; a whole
    tree is split on the fly) and the tokens a whole (B, T) array or
    ``shard_tokens``' parts; the logits come back whole on the mesh's
    first device. ``upcast_logits=False`` keeps the logits in the compute
    dtype, for the fused CE. ``scan_layers`` is accepted and changes
    nothing: a Python loop over the layers is the only form here."""
    _check_trainable(cfg, mesh)
    if mesh is not None:
        run = _mesh_forward(cfg, mesh, upcast_logits)

        def mesh_apply(params, tokens):
            logits, aux = run(params, _token_rows(cfg, mesh, tokens))
            dev = mesh.devices[0]
            return torch.cat([lg.to(dev) for lg in logits],
                             dim=_token_dim(cfg)), aux

        return mesh_apply
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
        # dense blocks only (MoE needs a mesh), so the aux loss is zero
        return logits, torch.zeros((), device=x.device)

    return apply


def _mesh_loss(cfg: TransformerConfig, mesh: DeviceMesh):
    """The loss on a mesh: each data row's CE summed on its device, the
    rows' sums added in rank order and divided by the token count.
    Sequence parallelism keeps the model's T equal to the (divisible)
    input length: targets are the tokens rolled by one and the last
    position is masked (the reference's branch, transformer.py:913).

    Across processes each process sums its own rows: a batch-split loss
    is its rows' mean (the processes' mean is the global mean, rows being
    equal); a sequence-split one is its share of the global sum times the
    process count, so that the mean over the processes (the data bucket's
    average, ``all_reduce_mean``) is the global loss and gradient."""
    run = _mesh_forward(cfg, mesh, upcast_logits=False)
    dp = mesh.global_size(_DATA)
    d0, n_proc = mesh.offset(_DATA), mesh.dcn.get(_DATA, 1)

    def loss(params, tokens):
        dev = mesh.devices[0]
        if cfg.sequence_parallel:
            whole = (tokens.whole() if isinstance(tokens, MeshTensor)
                     else torch.as_tensor(tokens)).long()
            b, t = whole.shape
            if t % dp:
                raise ValueError(f"sequence parallelism needs the sequence "
                                 f"({t}) divisible by the data axis ({dp})")
            rows = _token_rows(cfg, mesh, whole)
            targets = _token_rows(cfg, mesh, torch.roll(whole, -1, dims=1))
            logits, aux = run(params, rows)
            total = None
            for d, (lg, tg) in enumerate(zip(logits, targets)):
                tl = tg.shape[1]
                ce_tok = cross_entropy_with_integer_labels(lg, tg)
                mask = ((d0 + d) * tl + torch.arange(tl, device=lg.device)
                        < t - 1).to(ce_tok.dtype)[None]
                s = (ce_tok * mask).sum().to(dev)
                total = s if total is None else total + s
            ce = total / ((t - 1) * b)
            if n_proc > 1:
                ce = ce * n_proc
        else:
            rows = _token_rows(cfg, mesh, tokens)
            logits, aux = run(params, [r[:, :-1] for r in rows])
            total, n = None, 0
            for lg, r in zip(logits, rows):
                s = cross_entropy_with_integer_labels(lg, r[:, 1:]).sum()
                total = s.to(dev) if total is None else total + s.to(dev)
                n += lg.shape[0] * lg.shape[1]
            ce = total / n
        return ce + cfg.aux_coef * aux

    return loss


def transformer_loss(cfg: TransformerConfig, mesh: DeviceMesh | None = None):
    """Next-token cross-entropy plus the MoE aux term: ``loss(params,
    tokens)`` with tokens (B, T+1) (under sequence parallelism (B, T),
    the last position masked), through the fused CE on compute-dtype
    logits (the reference's ``transformer_loss``, transformer.py:899)."""
    if mesh is not None:
        _check_trainable(cfg, mesh)
        return _mesh_loss(cfg, mesh)
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


def _parts(leaf) -> list[torch.Tensor]:
    """The tensors a leaf is held in: a MeshTensor's parts, else itself."""
    return leaf.flat() if isinstance(leaf, MeshTensor) else [leaf]


def _map_parts(fn, tree):
    """``tree`` with ``fn`` applied to every part of every leaf (a
    MeshTensor keeps its layout)."""
    return _tree((path, leaf.like(fn(p) for p in leaf.flat())
                  if isinstance(leaf, MeshTensor) else fn(leaf))
                 for path, leaf in _leaves(tree))


def value_and_grad(loss_fn, params, tokens):
    """``(loss, grads)``: the loss (a 0-dim tensor, detached) and its
    gradient with respect to every leaf of ``params``, as a tree of the same
    shape (``jax.value_and_grad`` of ``loss_fn``); a laid-out leaf's
    gradient comes back in its parts. Marks the leaves as requiring
    grad."""
    leaves = list(_leaves(params))
    flat = [q for _, p in leaves for q in _parts(p)]
    for q in flat:
        q.requires_grad_(True)
    loss = loss_fn(params, tokens)
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), _tree(
        (path, p.like([next(grads) for _ in p.flat()])
         if isinstance(p, MeshTensor) else next(grads))
        for path, p in leaves)


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


def _global_sq_sums(grads, sq) -> list[torch.Tensor]:
    """Every global part's squared sum, in the one-process order (leaf by
    leaf, each leaf's parts data-major), from this process's ``sq`` (its
    parts' sums, in its :func:`_parts` order): one all-gather over every
    process of the values and of which it holds; each part's value taken
    from the first process that holds it. Every process gets the same
    list, so the same norm, bit for bit."""
    slots, base = [], 0
    for _, g in _leaves(grads):
        cd, cm = g.counts()
        slots.extend(base + gi * cm + gj for gi, gj in (
            g.index(i, j) for i, row in enumerate(g.parts)
            for j in range(len(row))))
        base += cd * cm
    dev = sq[0].device
    val = torch.zeros(base, dtype=torch.float32, device=dev)
    have = torch.zeros(base, dtype=torch.float32, device=dev)
    idx = torch.tensor(slots, device=dev)
    val[idx] = torch.stack(sq).float()
    have[idx] = 1.0
    mesh = next(g for _, g in _leaves(grads)).mesh
    every = mesh_lib.process_gather(torch.stack([val, have]), mesh, None)
    out = [None] * base
    for blk in every:
        for k in torch.nonzero(blk[1] > 0).flatten().tolist():
            if out[k] is None:
                out[k] = blk[0, k]
    return out


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
        """Zero moments in the params' layout (a laid-out leaf's moments
        are laid out alike, so the state shards with the params)."""
        return {"count": 0, "mu": _map_parts(torch.zeros_like, params),
                "nu": _map_parts(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params, grads, state) -> None:
        """One update of ``params`` (and ``state``) in place from ``grads``,
        a tree of the params' shape; elementwise over every part of a
        laid-out leaf, the clip's global norm over all of them."""
        count = state["count"]
        leaves = list(_leaves(params))
        ps = [q for _, p in leaves for q in _parts(p)]
        gs = [q for _, g in _leaves(grads) for q in _parts(g)]
        mus = [q for _, m in _leaves(state["mu"]) for q in _parts(m)]
        nus = [q for _, n in _leaves(state["nu"]) for q in _parts(n)]
        flags = ([f for _, f in _leaves(self.mask(params))]
                 if self.mask is not None else [True] * len(leaves))
        decays = [f for f, (_, p) in zip(flags, leaves) for _ in _parts(p)]
        if self.clip_norm is not None:
            # optax scales by max_norm / g_norm only at g_norm >= max_norm,
            # with no epsilon (torch's clip_grad_norm_ adds 1e-6)
            dev = gs[0].device
            sq = [g.square().sum().to(dev) for g in gs]
            if any(isinstance(g, MeshTensor) and g.mesh.num_processes > 1
                   for _, g in _leaves(grads)):
                sq = _global_sq_sums(grads, sq)
            g_norm = torch.sqrt(sum(sq))
            keep = g_norm < self.clip_norm
            gs = [torch.where(keep.to(g.device), g,
                              (g / g_norm.to(g.device)) * self.clip_norm)
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


def transformer_train_step(mesh: DeviceMesh | None, cfg: TransformerConfig,
                           optimizer=None, fsdp: bool = False, device=None):
    """The reference's ``transformer_train_step`` (transformer.py:2157):
    on one device (``mesh=None``, on ``device``), or over a ``(data,
    model)`` mesh with the params and optimizer state laid out by
    :func:`transformer_shardings`, or by :func:`fsdp_shardings` with
    ``fsdp``. Returns ``(step, init_state, shard_tokens)``:

    - ``step(params, opt_state, tokens) -> (params, opt_state, loss)``
      updates params and optimizer state in place (the reference donates
      both) and returns them with the loss as a 0-dim tensor (no host sync);
    - ``init_state(seed=0) -> (params, opt_state)``, placed;
    - ``shard_tokens(tokens)`` puts a (B, T+1) int array on the device, or
      splits it over the mesh's data axis (by batch, or by sequence under
      sequence parallelism).

    On a mesh that spans processes (``parallel/mesh.hybrid_mesh`` under
    ``torch.distributed``) every process passes the same global batch to
    ``shard_tokens``, which keeps the process's rows (B, or T under
    sequence parallelism, divisible by the global data axis), and every
    process draws the same init from ``seed`` and keeps its own parts.
    A model axis across processes runs its collectives inside the
    forward and backward (``mesh_lib.model_sum`` and its kin), so the
    processes of a model row compute the same replicated gradients. Over
    a data axis across processes the gradients of the parts every process
    of a data column holds, and the loss, are averaged in one flattened
    bucket (``mesh_lib.all_reduce_mean``) before the AdamW update; a
    ZeRO-3 shard's gradient was already added over the column by the
    gather's backward and is divided by the column's size. AdamW's global
    norm adds every part's squares in the one-process order
    (:func:`_global_sq_sums`). ``step.stats`` then holds the last step's
    ``bucket_bytes``, ``host_bytes`` (gloo on a card goes through the
    host) and ``allreduce_s``, the host clock over the averaging with the
    device synced on both sides, and ``collectives``: the calls, bytes,
    bytes through the host and host seconds of the other cross-process
    collectives (``mesh_lib.collectives``) over the step.

    The default optimizer is ``AdamW(3e-4)``, as the reference defaults to
    ``optax.adamw(3e-4)``."""
    if fsdp and mesh is None:
        raise ValueError("fsdp splits over a mesh's data axis: pass a mesh")
    optimizer = optimizer or AdamW(3e-4)
    loss_fn = transformer_loss(cfg, mesh)
    nproc = mesh.num_processes if mesh is not None else 1
    if mesh is not None:
        tspec = (None, _DATA) if cfg.sequence_parallel else (_DATA, None)

        def init_state(seed: int = 0):
            params = place_transformer_params(
                mesh, init_params(cfg, seed=seed, device=mesh.devices[0]),
                cfg, fsdp)
            return params, optimizer.init(params)

        def shard_tokens(tokens):
            whole = torch.as_tensor(tokens)
            dim = _token_dim(cfg)
            if nproc > 1 and whole.shape[dim] % mesh.global_data_size:
                raise ValueError(
                    f"the {'sequence' if dim else 'batch'} "
                    f"({whole.shape[dim]}) must divide over the data axis "
                    f"across processes ({mesh.global_data_size})")
            whole = whole.to(device=mesh.devices[0], dtype=torch.long)
            return mesh_lib.place(mesh, whole, tspec)
    else:
        dev = resolve_device(device)

        def init_state(seed: int = 0):
            params = init_params(cfg, seed=seed, device=dev)
            return params, optimizer.init(params)

        def shard_tokens(tokens):
            return torch.as_tensor(tokens).to(device=dev, dtype=torch.long)

    def step(params, opt_state, tokens):
        if mesh is not None and not all(
                isinstance(p, MeshTensor) for _, p in _leaves(params)):
            raise TypeError("a mesh step takes params laid out on its mesh "
                            "(init_state or place_transformer_params)")
        if nproc > 1:
            mesh_lib.reset_collectives()
        loss, grads = value_and_grad(loss_fn, params, tokens)
        if nproc > 1:
            loss = loss.clone()
            zero3 = mesh.spans(_DATA)
            shards, parts = [], [loss.reshape(1)]
            for _, g in _leaves(grads):
                (shards if zero3 and g.dim_of(_DATA) is not None
                 else parts).extend(_parts(g))
            synchronize(loss.device)
            t0 = time.perf_counter()
            bucket, host = mesh_lib.all_reduce_mean(parts[1:] + parts[:1],
                                                    mesh)
            for g in shards:
                g.div_(mesh.dcn[_DATA])
            synchronize(loss.device)
            step.stats = {"bucket_bytes": bucket, "host_bytes": host,
                          "allreduce_s": time.perf_counter() - t0}
        optimizer.update_(params, grads, opt_state)
        if nproc > 1:
            step.stats["collectives"] = dict(mesh_lib.collectives)
        return params, opt_state, loss

    step.stats = {"bucket_bytes": 0, "host_bytes": 0, "allreduce_s": 0.0,
                  "collectives": dict(mesh_lib.collectives)}
    return step, init_state, shard_tokens


# -- KV caches: slab or int8 dict, slab or block pool ---------------------------

def kv_map(fn, *caches):
    """Apply ``fn`` leafwise over caches of one structure: a float cache
    tensor, or the int8 ``{"kv", "scale"}`` dict (``fn`` sees the int8
    rows, then their scale planes); under exact TP each leaf is a
    :class:`Shards` and ``fn`` sees rank by rank the parts of one rank.
    Returns the same structure."""
    if isinstance(caches[0], dict):
        return {k: _leaf_map(fn, [c[k] for c in caches])
                for k in ("kv", "scale")}
    return _leaf_map(fn, caches)


def _leaf_map(fn, leaves):
    """``fn`` over one leaf of caches of one structure, rank by rank when
    it is sharded."""
    if isinstance(leaves[0], Shards):
        if not all(isinstance(x, Shards) for x in leaves):
            raise TypeError("a sharded cache meets an unsharded one")
        return Shards(fn(*parts) for parts in zip(*leaves))
    return fn(*leaves)


def kv_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a cache or caches operand (a tensor, or nested dicts
    of them: rows then scales, blocks then tables), in key order, each
    sharded leaf's ranks in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Shards):
        return list(tree)
    return [t for k in sorted(tree) for t in kv_leaves(tree[k])]


def _kv_planes(caches):
    """(rows, scales) of a cache or pool: the int8 dict's two leaves, or a
    float tensor and None."""
    if isinstance(caches, dict):
        return caches["kv"], caches["scale"]
    return caches, None


def is_paged(caches) -> bool:
    """A block-paged cache ``{"blocks": pool, "tables": (B, bps)}``."""
    return isinstance(caches, dict) and "tables" in caches


def _row_values(caches, rows):
    """Per view, the (leaf, values) pairs writing float new cache rows
    into ``caches``: ``rows`` holds each view's rows (..., Hkv*K), or
    under exact TP each rank's (..., Hkv/tp*K) for its part of a sharded
    cache. The rows cast to the cache dtype, or int8 rows under ONE scale
    per row over all packed heads (the reference's ``quantize_kv_rows``,
    transformer.py:955; scale = max(max|row|, 1e-8) / 127, round half to
    even, as :func:`_quantize_int8`). Under TP the max runs over every
    rank's part, an exact cross-rank max, so the quantized rows and the
    scale plane (written alike on every rank) are the single-device
    bits."""
    kv, sc = _kv_planes(caches)
    if sc is None:
        return [[(_rank(kv, r), x.to(_rank(kv, r).dtype))]
                for r, x in enumerate(rows)]
    amax = None
    for x in rows:
        a = x.float().abs().amax(dim=-1, keepdim=True).to(rows[0].device)
        amax = a if amax is None else torch.maximum(amax, a)
    scale = _div127(amax.clamp_min(1e-8))
    out = []
    for r, x in enumerate(rows):
        s = scale.to(x.device)
        q8 = torch.clamp(torch.round(x.float() / s), -127, 127).to(
            torch.int8)
        out.append([(_rank(kv, r), q8), (_rank(sc, r), s)])
    return out


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

def _table_index(tables):
    """``device -> the flattened long block index`` of a table (a tensor,
    or under exact TP the :class:`Shards` of per-rank copies), each
    device's made once."""
    made = {}

    def on(dev):
        if dev not in made:
            t = tables
            if isinstance(t, Shards):
                t = next((p for p in t if p.device == dev), t[0])
            made[dev] = t.to(dev).reshape(-1).long()
        return made[dev]
    return on


def paged_gather(blocks, tables):
    """Contiguous (nl, 2, B, bps*bs, ...) slab of every table row's blocks,
    in table order (sentinel entries give zero rows)."""
    idx = _table_index(tables)
    rows, bps = (tables[0] if isinstance(tables, Shards) else tables).shape

    def g(x):
        nl, two, _, bs, w = x.shape
        return x[:, :, idx(x.device)].reshape(nl, two, rows, bps * bs, w)
    return kv_map(g, blocks)


def paged_scatter(blocks, tables, view):
    """Write a slab view back into the blocks its tables name, then re-zero
    the sentinel. Aliased blocks receive identical bytes from every
    writer."""
    idx = _table_index(tables)

    def s(x, v):
        nl, two, _, bs, w = x.shape
        ix = idx(x.device)
        x[:, :, ix] = v.reshape(nl, two, ix.numel(), bs, w)
        x[:, :, 0] = 0
        return x
    return kv_map(s, blocks, view)


def paged_slot_gather(blocks, table_row):
    """One slot's batch-1 slab: the blocks of one (bps,) table row."""
    return paged_gather(blocks, smap(lambda t: t[None], table_row))


def paged_slot_scatter(blocks, table_row, slab):
    """Land a batch-1 slab covering all Tpad rows (zeros past the prompt
    included, so a reused block keeps no stale row) in the blocks one
    table row names, then re-zero the sentinel."""
    return paged_scatter(blocks, smap(lambda t: t[None], table_row), slab)


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
    for x, v in _row_values(blocks, [rows])[0]:
        x[i][:, blk, row] = v
        x[i, :, 0] = 0


# -- chunked cached forward (dense attention against the cache) ----------------

def _chunk_positions(pos0, c: int, device):
    """(per-row starts?, positions): (C,) from an int ``pos0``, (B, C)
    from a (B,) tensor of per-row starts."""
    vec_pos = isinstance(pos0, torch.Tensor) and pos0.dim() == 1
    steps = torch.arange(c, device=device)
    positions = (pos0.long()[:, None] + steps) if vec_pos else (
        int(pos0) + steps)
    return vec_pos, positions


def _write_chunk(pairs, i: int, pos0, positions, vec_pos: bool) -> None:
    """Write one chunk's (leaf, values (2, B, C, ...)) pairs into layer
    ``i`` at its positions, in place."""
    for buf, vals in pairs:
        b, c = vals.shape[1], vals.shape[2]
        if vec_pos:
            bidx = torch.arange(b, device=vals.device)[:, None]
            buf[i][:, bidx, _write_rows(positions, buf)] = vals
        else:
            buf[i, :, :, int(pos0):int(pos0) + c] = vals


def _chunk_attention(q, kv_all, i: int, positions, vec_pos: bool, kd: int,
                     dtype):
    """Dense masked attention of ``q`` (B, H, C, K) against layer ``i`` of
    the (dequantized) cache, whose packed heads are the query heads' KV
    heads: -> (B, C, H*K), head-major. Divides the logits by ``sqrt(kd)``
    as the reference does (the kernels multiply by the scale instead)."""
    ck, cv = _layer_view(kv_all, i, dtype)
    b, hq, c, _ = q.shape
    tpad = ck.shape[1]
    hkv = ck.shape[2] // kd
    ck4 = ck.view(b, tpad, hkv, kd)
    cv4 = cv.view(b, tpad, hkv, kd)
    qg = q.reshape(b, hkv, hq // hkv, c, kd)  # head = kv*G + g
    att = torch.einsum("bhgck,bthk->bhgct", qg, ck4) / dtype_scalar(
        math.sqrt(kd), dtype)
    mask = torch.arange(tpad, device=q.device) <= positions[..., None]
    mask = mask[:, None, None] if vec_pos else mask[None, None, None]
    att = att.masked_fill(~mask, float("-inf"))
    w_att = torch.softmax(att, dim=-1)
    o = torch.einsum("bhgct,bthk->bhgck", w_att, cv4)
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, hq * kd)


def _qkv(cfg: TransformerConfig, p, h_in, lora, i: int, rope,
         tp_mesh: Mesh | None):
    """Each view's q (B, H/tp, T, K), k and v (B, Hkv/tp, T, K) from its
    wq/wqkv/wkv (tp 1 without a mesh), and its new KV rows (2, B, T,
    Hkv/tp*K): the LoRA q delta computed whole (the single-device order)
    and added to each view's heads before RoPE ``rope`` ((cos, sin) or
    None); adapter-0 rows keep the base bits."""
    b, t, _ = h_in.shape
    dq = sel = None
    if lora is not None:
        rows, sel = lora
        dq = _lora_delta(h_in, rows["a_q"][i], rows["b_q"][i]).view(
            b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    qs, kv_rows, h0 = [], [], 0
    for dev, p_r in _views(p, tp_mesh, h_in.device):
        q, k_r, v_r = _project_qkv(cfg, p_r, h_in.to(dev))
        if dq is not None:
            hr = q.shape[1]
            q = torch.where(sel.to(dev)[:, None, None, None],
                            q + dq[:, h0:h0 + hr].to(dev), q)
            h0 += hr
        if rope is not None:
            cos, sin = rope[0].to(dev), rope[1].to(dev)
            q = _apply_rope(q, cos, sin)
            k_r = _apply_rope(k_r, cos, sin)
        qs.append((q, k_r, v_r))
        kv_rows.append(torch.stack([k_r.transpose(1, 2).reshape(b, t, -1),
                                    v_r.transpose(1, 2).reshape(b, t, -1)]))
    return qs, kv_rows


def _block_chunk(cfg: TransformerConfig, x, p, kv_all, i: int, pos0,
                 lora=None, tp_mesh: Mesh | None = None):
    """One block over C consecutive cached positions (x: (B, C, D), rows
    pos0..pos0+C-1): projection, RoPE, cache write (in place; quantized
    rows into an int8 cache), dense masked attention against the
    (dequantized) cache, MLP. ``pos0`` is an int or a (B,) tensor of
    per-row starts. ``lora`` (the rows' factors from :func:`_lora_select`;
    layer ``i`` is read) adds each row's LoRA deltas. ``tp_mesh`` runs it
    over the ranks (the reference's ``_block_chunk`` with ``tp_mesh``,
    transformer.py:1642): the residual stream, norms and row projections
    on the first device; each rank projects, writes and attends over its
    own heads; the attention output and the gelu hidden are gathered
    before wo and w2."""
    b, c, _ = x.shape
    kd = cfg.head_dim
    vec_pos, positions = _chunk_positions(pos0, c, x.device)
    h_in = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    rope = None
    if cfg.rope:
        cos, sin = _rope_tables(positions, kd, x.dtype, x.device)
        # (B, C, hd/2) per-row tables over the head axis
        rope = (cos[:, None], sin[:, None]) if vec_pos else (cos, sin)
    qs, kv_rows = _qkv(cfg, p, h_in, lora, i, rope, tp_mesh)
    outs = []
    for r, ((q, _, _), pairs) in enumerate(zip(qs,
                                               _row_values(kv_all, kv_rows))):
        pr = positions.to(q.device)
        _write_chunk(pairs, i, pos0, pr, vec_pos)
        outs.append(_chunk_attention(q, _rank(kv_all, r), i, pr, vec_pos, kd,
                                     x.dtype))
    o_flat = _tp_replicate(outs, tp_mesh)
    x = x + o_flat @ _w(p, "wo", x.dtype).reshape(cfg.n_heads * kd, -1)
    h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    return x + _ffn(cfg, p, h_in, lora, i, tp_mesh), kv_all


def _chunk_builder(cfg: TransformerConfig, tp_mesh: Mesh | None = None):
    """``forward_chunk(params, caches, toks (B, C), pos0, last_idx=None,
    adapter=None)`` advances C positions from the int ``pos0`` through
    every layer against the cache (written in place) and returns (logits,
    caches): (B, C, V), or (B, V) at ``last_idx`` (int or (B,) tensor;
    ``rowwise_head`` takes the head product a row at a time, see
    :func:`_last_row_logits`). ``adapter`` (B,) rows apply the
    ``params["lora"]`` bank. ``tp_mesh`` builds the exact-TP program over
    params placed by :func:`place_serving_tp_params` and a sharded cache;
    its logits come back whole on the mesh's first device."""
    if tp_mesh is not None:
        serving_tp_shardings(tp_mesh, cfg)  # raises for a bad geometry

    def forward_chunk(params, caches, toks, pos0: int, last_idx=None,
                      adapter=None, rowwise_head: bool = False):
        lora = _lora_select(params, adapter, tp_mesh)
        b, c = toks.shape
        pos_rows = _pos_rows(
            params, int(pos0) + torch.arange(c, device=toks.device),
            cfg.max_len)
        x = (params["embed"][toks] + pos_rows[None]).to(cfg.compute_dtype)
        for i in range(cfg.n_layers):
            x, caches = _block_chunk(cfg, x, _layer(params, i), caches, i,
                                     pos0, lora, tp_mesh)
        if last_idx is not None:
            return _last_row_logits(cfg, params, x, last_idx, rowwise_head,
                                    tp_mesh), caches
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        return _head(cfg, params, x, tp_mesh), caches

    return forward_chunk


# -- KV-cached decode ----------------------------------------------------------

def _decode_builder(cfg: TransformerConfig, tp_mesh: Mesh | None = None):
    """Shared KV-cache decode machinery: ``(forward_one, init_caches,
    prefill, cast_params)``, as the reference's ``_decode_builder``
    (transformer.py:936) returns. ``forward_one`` also takes a block-paged
    cache (see the module doc).

    ``tp_mesh`` builds the exact-TP serving programs: params placed by
    :func:`place_serving_tp_params`, caches from ``init_caches`` sharded
    per :func:`serving_tp_cache_sharding`, every sharded activation
    gathered before its row projection, logits whole on the mesh's first
    device. It needs the dense decode (``decode_kernel=False``, as the
    reference: its Pallas kernel cannot be partitioned), and its prefill
    attention is dense too, so no kernel runs under TP."""
    kd = cfg.head_dim
    grp = cfg.n_heads // cfg.kv_heads
    if tp_mesh is not None:
        if cfg.decode_kernel:
            raise ValueError(
                "tensor-parallel decode requires decode_kernel=False (the "
                "decode kernel runs over the whole cache; the dense path "
                "is the same numerics)")
        serving_tp_shardings(tp_mesh, cfg)  # raises for a bad geometry

    def write_kv_rows(kv_all, i: int, pos, kv_row):
        """Write one decode step's rows ``kv_row`` (2, B, Hkv*K) into layer
        ``i`` of the stacked cache (quantized into an int8 cache), in
        place. An int ``pos`` writes every row at that position (generate);
        a (B,) tensor scatters each row at its own position (the serving
        engine's per-slot depths)."""
        for buf, vals in _row_values(kv_all, [kv_row])[0]:
            if isinstance(pos, torch.Tensor) and pos.dim() == 1:
                bidx = torch.arange(vals.shape[1], device=vals.device)
                buf[i][:, bidx, _write_rows(pos, buf)] = vals
            else:
                buf[i, :, :, int(pos)] = vals
        return kv_all

    def block_decode(x, p, kv_all, i: int, pos, where=None, lora=None):
        if not cfg.decode_kernel:
            # the dense path IS the C=1 chunk block (one code path)
            y, kv_all = _block_chunk(cfg, x[:, None, :], p, kv_all, i, pos,
                                     lora, tp_mesh)
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
        if lora is not None:
            # the q delta before RoPE; attention below is the decode
            # kernel's, unchanged (the delta lies outside it)
            q = _lora_q(cfg, q[:, :, None], h_in[:, None], lora, i)[:, :, 0]
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
        if lora is not None:
            return x + _mlp(p, h_in[:, None], lora, i)[:, 0], kv_all
        return x + _ffn(cfg, p, h_in), kv_all

    def forward_one(params, caches, token, pos, adapter=None):
        """One position through all layers -> (logits (B, V) f32, caches).
        ``pos`` is an int (every row at one depth) or a (B,) tensor;
        ``adapter`` (B,) rows apply the ``params["lora"]`` bank."""
        if is_paged(caches) and not cfg.decode_kernel:
            # the dense chunk block reads whole slabs: gather the view,
            # step it, scatter it back (the reference's make_paged_fwd1)
            view = paged_gather(caches["blocks"], caches["tables"])
            logits, view = forward_one(params, view, token, pos, adapter)
            paged_scatter(caches["blocks"], caches["tables"], view)
            return logits, caches
        lora = _lora_select(params, adapter, tp_mesh)
        x = (params["embed"][token] + _pos_rows(params, pos, cfg.max_len)
             ).to(cfg.compute_dtype)
        where = _paged_write_index(caches, pos) if is_paged(caches) else None
        for i in range(cfg.n_layers):
            x, caches = block_decode(x, _layer(params, i), caches, i, pos,
                                     where, lora)
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
        return _head(cfg, params, x, tp_mesh), caches

    def cast_params(params):
        """One-time cast of the streamed float weights (every block tensor
        and the head) to the compute dtype; embeddings, positions and the
        final norm stay f32. int8 leaves and their f32 scales (NOT the
        ``ln1_scale``/``ln2_scale`` norms) pass through untouched. A LoRA
        bank is cast too: its deltas take the factors at the compute dtype,
        and a cast before the row gather gives the bits of one after it."""
        def cast(name, a):
            if a.dtype == torch.int8 or name in _INT8_SCALES:
                return a
            return a.to(cfg.compute_dtype)
        out = dict(params)
        out["blocks"] = {
            name: ({k: v.to(cfg.compute_dtype) for k, v in a.items()}
                   if name == "moe" else smap(lambda a, n=name: cast(n, a),
                                              a))
            for name, a in params["blocks"].items()}
        out["head"] = smap(lambda a: cast("head", a), params["head"])
        if "lora" in params:
            out["lora"] = {name: smap(lambda a: a.to(cfg.compute_dtype), a)
                           for name, a in params["lora"].items()}
        return out

    def tp_caches(batch: int, tpad: int, device):
        """The zeroed cache sharded per :func:`serving_tp_cache_sharding`:
        each rank's (nl, 2, batch, Tpad, Hkv/tp*K) rows (and a whole scale
        plane) on its device, or all on ``device`` when that is the meta
        device (shapes only)."""
        tp = tp_mesh.size
        devs = ([torch.device("meta")] * tp
                if torch.device(device).type == "meta" else tp_mesh.devices)
        shape = (cfg.n_layers, 2, batch, tpad, cfg.kv_heads // tp * kd)
        if cfg.decode_int8:
            return {"kv": Shards(torch.zeros(shape, dtype=torch.int8,
                                             device=d) for d in devs),
                    "scale": Shards(torch.zeros(
                        shape[:4] + (1,), dtype=torch.float32, device=d)
                        for d in devs)}
        return Shards(torch.zeros(shape, dtype=cfg.compute_dtype, device=d)
                      for d in devs)

    def init_caches(batch: int, total: int, device):
        """Zeroed stacked cache (nl, 2, batch, Tpad, Hkv*K) at the compute
        dtype, or with ``decode_int8`` the dict ``{"kv": int8, "scale":
        f32 (nl, 2, batch, Tpad, 1)}``. Tpad is ``total`` rounded up to 8
        rows, or to 512 above 1024 rows. Under TP the cache is sharded on
        the mesh's devices (``device`` is read only as the meta device)."""
        tpad = _cache_rows(total)
        if tp_mesh is not None:
            return tp_caches(batch, tpad, device)
        shape = (cfg.n_layers, 2, batch, tpad, cfg.kv_heads * kd)
        if cfg.decode_int8:
            return {
                "kv": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.zeros(shape[:4] + (1,), dtype=torch.float32,
                                     device=device),
            }
        return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)

    def prefill(params, caches, prompt, last_idx=None, adapter=None,
                rowwise_head: bool = False):
        """Bulk prefill: one causal forward over the prompt (B, Tp) writes
        rows 0..Tp-1 of every layer's cache (in place; quantized rows into
        an int8 cache, while attention uses the float k/v) and returns
        (caches, logits (B, V) f32) at ``last_idx`` (default Tp-1; an int
        or a (B,) tensor; ``rowwise_head`` as :func:`_last_row_logits`).
        ``adapter`` (B,) rows apply the ``params["lora"]`` bank (attention
        stays the flash kernel's)."""
        b, tp = prompt.shape
        if tp == 0:
            return caches, torch.zeros((b, cfg.vocab_size),
                                       dtype=torch.float32,
                                       device=prompt.device)
        x = (params["embed"][prompt] + params["pos"][:tp]).to(
            cfg.compute_dtype)
        rope = None
        if cfg.rope:
            rope = _rope_tables(torch.arange(tp, device=x.device), kd,
                                cfg.compute_dtype, x.device)
        # the flash kernel runs over the whole head set: one view only
        use_flash = cfg.use_flash and _flash_seq_ok(tp) and tp_mesh is None
        lora = _lora_select(params, adapter, tp_mesh)
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            h_in = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
            qs, kv_rows = _qkv(cfg, p, h_in, lora, i, rope, tp_mesh)
            outs = []
            for (q, k_r, v_r), pairs in zip(qs, _row_values(caches,
                                                             kv_rows)):
                for buf, vals in pairs:
                    buf[i, :, :, :tp] = vals
                k_h, v_h = _expand_kv(cfg, k_r, v_r)
                if use_flash:
                    o = flash_attention(q, k_h, v_h, causal=True)
                else:
                    o = attention(q, k_h, v_h, causal=True, layout="bhtd")
                outs.append(o.transpose(1, 2).reshape(b, tp, -1))
            x = x + _tp_replicate(outs, tp_mesh) @ _w(
                p, "wo", x.dtype).reshape(cfg.n_heads * kd, -1)
            h_in = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
            x = x + _ffn(cfg, p, h_in, lora, i, tp_mesh)
        return caches, _last_row_logits(
            cfg, params, x, tp - 1 if last_idx is None else last_idx,
            rowwise_head, tp_mesh)

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


def _step_keys(key, n: int) -> list[threefry.Key]:
    """The subkeys of ``n`` steps of ``key, sub = split(key)``: the
    reference's per-step chain, on the host."""
    k, subs = threefry.as_key(key), []
    for _ in range(n):
        k, sub = threefry.split(k)
        subs.append(sub)
    return subs


# -- generate over the training layout --------------------------------------

def _is_laid_out(params) -> bool:
    return any(isinstance(leaf, MeshTensor) for _, leaf in _leaves(params))


class _MeshDecode:
    """Generate's programs over params laid out on a ``(data, model)``
    mesh (:func:`place_transformer_params`, float or int8, FSDP or not):
    the prompt's rows split over the data axis; in each data row the
    residual stream, the norms and the row-parallel products' sums live
    on the row's first rank, and each model rank projects its own heads,
    keeps its own KV cache (its KV heads, or its query heads' expanded KV
    when the layout keeps wkv whole), attends (kernel #1 in prefill where
    ``use_flash`` and :func:`_flash_seq_ok` hold, #3 in decode when
    ``decode_kernel``; dense otherwise), multiplies its wo rows, its d_ff
    columns (or runs its experts, ``moe_reference_shard``) and its vocab
    part of the head. wo and w2 are row-parallel: the ranks' partial
    products are added in rank order on the row's device; the head's
    vocab parts are concatenated. A leaf split over the data axis (FSDP)
    is gathered at its rank (an exact concatenation), as the reference's
    CLI gathers an FSDP tree before it samples. The leaves are cast once
    as ``cast_params`` casts them.

    With ``decode_int8`` each rank's cache is int8 beside f32 scales (nl,
    2, b, Tpad, 1). The reference quantizes a written row over its whole
    Hkv*K, one scale for every head; a rank holds only some heads, so each
    row's amax is the max of the ranks' amaxes (exact in any order) and
    every rank quantizes its part with that one scale row
    (:func:`_row_values`, as exact-TP serving does). The ranks' parts
    cover every KV head whether the layout splits wkv or keeps it whole
    (a rank's expanded KV holds its query heads' KV heads), so the scale
    is the single-device cache's, and so are the int8 rows. The int8
    attention over them takes the row's scales too
    (:meth:`decode_ranks`), so a rank's lanes are the single-device
    launch's lanes."""

    def __init__(self, cfg: TransformerConfig, params):
        leaves = dict(_leaves(params))
        self.cfg, self.mesh = cfg, next(iter(leaves.values())).mesh
        if not all(isinstance(v, MeshTensor) and v.mesh is self.mesh
                   for v in leaves.values()):
            raise TypeError("generate takes a tree laid out on one mesh "
                            "(every leaf a MeshTensor) or a whole tree")
        self.held = {path: _held(mt) for path, mt in leaves.items()}
        self.specs = {path: mt.spec for path, mt in leaves.items()}
        self.tp = self.mesh.axis_size(_MODEL)
        self.dp = self.mesh.axis_size(_DATA)
        self.hs = cfg.n_heads // self.tp
        kv_name = "wkv" if cfg.kv_heads != cfg.n_heads else "wqkv"
        #: the rank's cache holds its own KV heads (G query heads each),
        #: or, with wkv whole, its query heads' expanded KV (G = 1)
        self.kv_split = self.held[("blocks", kv_name)][2]
        self.kv_r = cfg.kv_heads // self.tp if self.kv_split else self.hs
        self.grp = self.hs // self.kv_r
        self._memo: dict = {}

    def _cast(self, path, t):
        name = path[-1]
        if path[0] == "blocks":
            if t.dtype == torch.int8 or (name in _INT8_SCALES
                                         and path[1] != "moe"):
                return t
            return t.to(self.cfg.compute_dtype)
        if path == ("head",) and t.dtype != torch.int8:
            return t.to(self.cfg.compute_dtype)
        return t

    def leaf(self, path, m: int, dev):
        """Model rank ``m``'s part of leaf ``path`` on ``dev``, gathered
        over the data axis and cast (made once a device)."""
        key = (path, m, torch.device(dev))
        if key not in self._memo:
            self._memo[key] = self._cast(path, _local(self.held[path], m,
                                                      dev))
        return self._memo[key]

    def whole(self, path, dev):
        """Leaf ``path`` whole on ``dev`` (its model parts concatenated)."""
        if not self.held[path][2]:
            return self.leaf(path, 0, dev)
        key = (path, "whole", torch.device(dev))
        if key not in self._memo:
            self._memo[key] = torch.cat(
                [self.leaf(path, m, dev) for m in range(self.tp)],
                dim=self.specs[path].index(_MODEL))
        return self._memo[key]

    def rank_layer(self, d: int, m: int, i: int) -> dict:
        """Rank (d, m)'s block leaves of layer ``i``: its part of a split
        leaf, a whole one (wkv kept whole, the row-parallel scales) on its
        device; with experts, its stacked experts."""
        dev = self.mesh.device(d, m)
        p = {path[-1]: self.leaf(path, m if self.held[path][2] else 0,
                                 dev)[i]
             for path in self.held if len(path) == 2
             and path[0] == "blocks"
             and path[-1].removesuffix("_scale") in _RANK_LEAVES}
        if self.cfg.n_experts:
            p["experts"] = tuple(self.leaf(("blocks", "moe", f), m, dev)[i]
                                 for f in _EXPERT_LEAVES)
        return p

    def row_layer(self, d: int, i: int) -> dict:
        """Data row d's replicated block leaves of layer ``i`` (norms, b2;
        the MoE router) on its first rank's device."""
        dev = self.mesh.device(d, 0)
        p = {path[-1]: self.leaf(path, 0, dev)[i] for path in self.held
             if len(path) == 2 and path[0] == "blocks"
             and path[-1].removesuffix("_scale") not in _RANK_LEAVES}
        if self.cfg.n_experts:
            p["wg"] = self.leaf(("blocks", "moe", "wg"), 0, dev)[i]
        return p

    def init_caches(self, sizes, total: int):
        """Per data row with ``sizes[d]`` rows (None for an empty row), its
        ranks' zeroed (nl, 2, b_d, Tpad, kv_r*K) caches (Tpad as
        ``init_caches``'s): a :class:`Shards` at the compute dtype, or with
        ``decode_int8`` the dict ``{"kv": int8 Shards, "scale": f32 Shards
        (nl, 2, b_d, Tpad, 1)}``."""
        cfg = self.cfg
        tpad = _cache_rows(total)

        def row(d, b):
            shape = (cfg.n_layers, 2, b, tpad, self.kv_r * cfg.head_dim)
            devs = [self.mesh.device(d, m) for m in range(self.tp)]
            if not cfg.decode_int8:
                return Shards(torch.zeros(shape, dtype=cfg.compute_dtype,
                                          device=dv) for dv in devs)
            return {"kv": Shards(torch.zeros(shape, dtype=torch.int8,
                                             device=dv) for dv in devs),
                    "scale": Shards(torch.zeros(shape[:4] + (1,),
                                                dtype=torch.float32,
                                                device=dv) for dv in devs)}

        return [row(d, b) if b else None for d, b in enumerate(sizes)]

    def _head(self, d: int, x):
        """Row d's logits (b, V) f32: each rank's vocab part, gathered."""
        parts = []
        for m in range(self.tp):
            dev = self.mesh.device(d, m)
            p = {"head": self.leaf(("head",), m, dev)}
            if ("head_scale",) in self.held:
                p["head_scale"] = self.leaf(("head_scale",), m, dev)
            parts.append(_head_logits(x.to(dev), _w(p, "head", x.dtype))
                         .to(x.device))
        return _cat(parts, -1)

    def _embed(self, d: int, toks, pos_rows):
        dev0 = self.mesh.device(d, 0)
        emb = self.whole(("embed",), dev0)
        return (emb[toks] + pos_rows).to(self.cfg.compute_dtype)

    def _moe(self, h_in, wg, experts, devs):
        """Every expert over every token on its rank, each token its top k
        (``moe_reference_shard``: no capacity, as the reference's decode)."""
        y = moe_reference_shard(h_in.reshape(-1, h_in.shape[-1]), wg,
                                experts, devs, k=self.cfg.moe_k,
                                activation=gelu)
        return y.reshape(h_in.shape), None

    def _layers(self, d: int, x, positions, attend):
        """Row d's (b, C, D) stream through every layer
        (:func:`_mesh_layer`); ``attend(i, m, q, k, v)`` is rank m's
        attention at layer ``i``, its cache write included."""
        for i in range(self.cfg.n_layers):
            out, _ = _mesh_layer(
                self.cfg, self.mesh, {d: x},
                lambda dd, m: self.rank_layer(dd, m, i),
                lambda dd: self.row_layer(dd, i), {d: positions},
                lambda heads: attend(i, [heads[d, m]
                                         for m in range(self.tp)]),
                self._moe)
            x = out[d]
        return self._final(d, x[:, -1])

    @staticmethod
    def _write(caches, i: int, at, heads) -> None:
        """Each rank's new K and V rows of layer ``i`` (``heads[m] = (q, k,
        v)``, k and v (b, kv_r, C, K)) written at rows ``at`` (a slice or
        a position) of its cache: cast, or quantized under the rows' one
        scale over every rank (:func:`_row_values`)."""
        rows = [torch.stack([k.transpose(1, 2).flatten(2),
                             v.transpose(1, 2).flatten(2)])
                for _, k, v in heads]
        for pairs in _row_values(caches, rows):
            for buf, vals in pairs:
                buf[i][:, :, at] = (vals if isinstance(at, slice)
                                    else vals[:, :, 0])

    def prefill(self, d: int, caches, prompt):
        """Row d's prompt (b, Tp) through every layer, each rank writing
        rows 0..Tp-1 of its cache; -> the last position's logits (b, V)."""
        cfg = self.cfg
        b, tp_len = prompt.shape
        dev0 = self.mesh.device(d, 0)
        x = self._embed(d, prompt, self.whole(("pos",), dev0)[:tp_len])
        use_flash = cfg.use_flash and _flash_seq_ok(tp_len)

        def attend(i, heads):
            # the float k and v attend; the cache keeps their rows
            self._write(caches, i, slice(0, tp_len), heads)
            outs = {}
            for m, (q, k, v) in enumerate(heads):
                k, v = _group_kv(q, k, v)
                if use_flash:
                    o = flash_attention(q, k, v, causal=True)
                else:
                    o = attention(q, k, v, causal=True, layout="bhtd")
                outs[d, m] = o.transpose(1, 2).reshape(b, tp_len, -1)
            return outs

        return self._layers(d, x, torch.arange(tp_len, device=dev0), attend)

    def _final(self, d: int, x):
        dev0 = self.mesh.device(d, 0)
        x = _layer_norm(x, self.whole(("lnf_scale",), dev0),
                        self.whole(("lnf_bias",), dev0))
        return self._head(d, x)

    def _lane_groups(self, dev) -> torch.Tensor:
        """The row's group of each rank's lanes, (tp * grp * kv_r,) on
        ``dev``: rank m's lane (g, j) is its query head j*grp + g, the
        row's head m*hs + j*grp + g, in the row's group (that) % G. With
        wkv whole a rank's one group holds lanes of every group of the
        row."""
        key = ("lane groups", torch.device(dev))
        if key not in self._memo:
            m, g, j = torch.meshgrid(torch.arange(self.tp),
                                     torch.arange(self.grp),
                                     torch.arange(self.kv_r), indexing="ij")
            g_row = self.cfg.n_heads // self.cfg.kv_heads
            self._memo[key] = ((m * self.hs + j * self.grp + g) % g_row
                               ).flatten().to(dev)
        return self._memo[key]

    def _q_scales(self, qps):
        """Each rank's (b, grp, kv_r) q scales from outside: the
        single-device launch's one scale per group over ALL heads, the max
        of the row's lanes in that group over the ranks (exact in any
        order), divided by 127 as kernel #3 divides it, on each lane of
        that group (:meth:`_lane_groups`)."""
        cfg = self.cfg
        b, dev0 = qps[0].shape[0], qps[0].device
        # |q| amax per (rank, b, g, j) lane, exact in q's dtype
        lanes = (torch.stack([qp.to(dev0) for qp in qps])
                 .unflatten(-1, (self.kv_r, cfg.head_dim)).abs().amax(-1))
        # the row's head h = kv*G + g, in order
        heads = lanes.permute(1, 0, 3, 2).reshape(b, cfg.kv_heads, -1)
        groups = _div127(heads.amax(1).float().clamp_min(1e-8))  # (b, G)
        per_lane = (groups.index_select(1, self._lane_groups(dev0))
                    .view(b, self.tp, self.grp, self.kv_r).transpose(0, 1)
                    .contiguous())
        return [s.to(qp.device) for s, qp in zip(per_lane, qps)]

    def decode_ranks(self, caches, layer: int, pos, qps) -> list:
        """Kernel #3 on each rank of a row at layer ``layer``, ``qps[m]``
        rank m's packed (b, grp, kv_r*K) queries -> each rank's output.
        int8: the row's q scales (:meth:`_q_scales`) and its weight scale
        a tile (the max of the ranks' maxima passes, divided by 127), over
        the single device's tile (the reference's default for the row's
        whole Hkv*K: a rank's narrower cache would default to fewer,
        longer tiles), so each rank's lanes are the single-device
        launch's."""
        kv, sc = _kv_planes(caches)
        if sc is None:
            return [flash_decode_attention(qp, kv[m], pos, self.kv_r,
                                           layer=layer)
                    for m, qp in enumerate(qps)]
        b, dev0 = qps[0].shape[0], qps[0].device
        bt = default_block_t(kv[0].shape[3],
                             self.cfg.kv_heads * self.cfg.head_dim, 1)
        # one position vector for the row's launches
        p = _pos_vector(pos, b, dev0)
        q_scales = self._q_scales(qps)
        pmax = torch.stack([flash_decode_int8_maxima(
            qp, kv[m], p, self.kv_r, layer, bt, sc[m], q_scales[m]
        ).to(dev0) for m, qp in enumerate(qps)]).amax(0)
        p_scales = _div127(pmax.clamp_min(1e-30))
        return [flash_decode_attention(qp, kv[m], p, self.kv_r, layer, bt,
                                       sc[m], q_scales[m],
                                       p_scales.to(qp.device))
                for m, qp in enumerate(qps)]

    def step(self, d: int, caches, token, *, pos: int):
        """Row d's tokens (b,) at position ``pos`` through every layer
        against the ranks' caches (written in place) -> logits (b, V)."""
        cfg = self.cfg
        kd = cfg.head_dim
        b = token.shape[0]
        dev0 = self.mesh.device(d, 0)
        pos_t = torch.full((1,), int(pos), device=dev0)
        x = self._embed(d, token, _pos_rows(
            {"pos": self.whole(("pos",), dev0)}, pos, cfg.max_len))

        def attend(i, heads):
            self._write(caches, i, int(pos), heads)
            if not cfg.decode_kernel:
                return {(d, m): _chunk_attention(
                    q, _rank(caches, m), i, pos_t.to(q.device), False, kd,
                    q.dtype) for m, (q, _, _) in enumerate(heads)}
            # query head h = kv*G + g: (b, G, kv_r*K), each group packed
            # head-major, as the single-device decode
            qps = [q[:, :, 0].reshape(b, self.kv_r, self.grp, kd)
                   .transpose(1, 2).reshape(b, self.grp, -1).contiguous()
                   for q, _, _ in heads]
            outs = self.decode_ranks(caches, i, int(pos), qps)
            return {(d, m): o.reshape(b, self.grp, self.kv_r, kd)
                    .transpose(1, 2).reshape(b, 1, -1)
                    for m, o in enumerate(outs)}

        return self._layers(d, x[:, None], pos_t, attend)


def _mesh_generate(cfg: TransformerConfig, params, prompt, max_new: int,
                   temperature: float, top_k, key, return_logits: bool):
    """``transformer_generate``'s loop over a laid-out tree
    (:class:`_MeshDecode`): each data row prefills and decodes its prompt
    rows; the rows' logits are gathered (an exact concatenation) on the
    mesh's first device, where the filter and the draw run over the whole
    batch with the single-device key stream, and each row's tokens go
    back to its row."""
    md = _MeshDecode(cfg, params)
    mesh = md.mesh
    dev = mesh.devices[0]
    b, tp_len = prompt.shape
    total = _check_decode_len(cfg, tp_len, max_new)
    prompt = prompt.to(dev)
    if temperature != 0:
        if key is None:
            raise ValueError("sampled decoding needs a key (an int seed or "
                             "threefry key data)")
        keys = threefry.device_keys(_step_keys(key, max_new), dev)
        temp = torch.full((), temperature, dtype=torch.float32, device=dev)
    sizes = [len(r) for r in torch.tensor_split(torch.arange(b), md.dp)]
    live = [d for d in range(md.dp) if sizes[d]]
    rows = torch.split(prompt, sizes)
    caches = md.init_caches(sizes, total)

    def gathered(fn, per_row):
        return _cat([fn(d, caches[d], per_row[d].to(mesh.device(d, 0)))
                     .to(dev) for d in live], 0)

    logits = gathered(md.prefill, rows)
    toks, seen = [], []
    for i in range(max_new):
        seen.append(logits)
        filt = _top_k_filter(logits, top_k)
        if temperature == 0:
            tok = filt.argmax(dim=-1)
        else:
            tok = threefry.categorical(filt / temp, keys[i])
        tok = tok.to(prompt.dtype)
        toks.append(tok)
        logits = gathered(functools.partial(md.step, pos=tp_len + i),
                          torch.split(tok, sizes))
    out = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1) if toks \
        else prompt
    if return_logits:
        return out, torch.stack(seen)
    return out


def transformer_generate(cfg: TransformerConfig):
    """Autoregressive sampling with the KV cache. Returns
    ``generate(params, prompt, max_new, temperature=1.0, top_k=None,
    key=None, return_logits=False, approx_top_k=False) -> tokens
    (B, Tp + max_new)`` (plus the (max_new, B, V) sampling logits with
    ``return_logits``).

    Runs on the device ``params`` live on. ``temperature=0`` decodes
    greedily (argmax, first index on ties, as the reference). Sampled
    decoding takes the reference's ``key`` (an int seed or (2,) uint32 key
    data; required) and consumes it as the reference does: ``key, sub =
    split(key)`` each step (on the host, uploaded once), then
    ``categorical(sub, filtered / temperature)`` over the (B, V) logits
    through the threefry draw kernel. ``approx_top_k`` is accepted and
    ignored: the exact threshold is the reference's function off the TPU
    (:func:`_top_k_filter`).

    ``params`` may be laid out on a ``(data, model)`` mesh
    (:func:`place_transformer_params`, float or int8 weights, FSDP or
    not), as the reference decodes straight from its placed tree: the
    programs then run over the layout (:class:`_MeshDecode`) and the
    tokens come back on the mesh's first device, drawn with the same key
    stream over the whole batch. A layout that spans processes is
    gathered whole in every process first (every process must call it)
    and decoded on one device."""
    forward_one, init_caches, do_prefill, cast_params = _decode_builder(cfg)

    @torch.no_grad()
    def generate(params, prompt, max_new: int, temperature: float = 1.0,
                 top_k: int | None = None, key=None,
                 return_logits: bool = False, approx_top_k: bool = False):
        if _is_laid_out(params):
            if any(leaf.spans() for _, leaf in _leaves(params)):
                # a layout across processes: every process gathers the
                # tree whole and decodes on its mesh's first device, as
                # the reference's CLI gathers an FSDP tree
                dev = next(leaf for _, leaf in _leaves(params)
                           ).mesh.devices[0]
                params = gather_transformer_params(params, dev)
            else:
                return _mesh_generate(cfg, params, prompt, max_new,
                                      temperature, top_k, key,
                                      return_logits)
        b, tp = prompt.shape
        total = _check_decode_len(cfg, tp, max_new)
        params = cast_params(params)
        dev = params["embed"].device
        prompt = prompt.to(dev)
        if temperature != 0:
            if key is None:
                raise ValueError("sampled decoding needs a key (an int seed "
                                 "or threefry key data)")
            keys = threefry.device_keys(_step_keys(key, max_new), dev)
            # a device scalar (a true division, as the reference's; made
            # on the device, no copy from the host)
            temp = torch.full((), temperature, dtype=torch.float32,
                              device=dev)
        caches, logits = do_prefill(params, init_caches(b, total, dev),
                                    prompt)
        toks, seen = [], []
        for i in range(max_new):
            seen.append(logits)
            filt = _top_k_filter(logits, top_k)
            if temperature == 0:
                tok = filt.argmax(dim=-1)
            else:
                tok = threefry.categorical(filt / temp, keys[i])
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
    temperature=1.0, top_k=None, approx_top_k=False, key=None,
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

    Sampling consumes the reference's ``key`` (an int seed or (2,) uint32
    key data) as it does: each round ``key, kd1, kdr, ku, kc = split(key,
    5)``; d_1 draws with kd1, draft step i with ``kdr, ks = split(kdr)``'s
    ks, u is ``uniform(ku, (B, k))``, the correction token draws with kc,
    each draw ``categorical(log(p + 1e-30))`` through the threefry draw
    kernel. The chain is computed on the host (u too: (1, k) floats) and
    uploaded; at temperature 0 the draws are argmaxes and only u is
    used."""
    draft_cfg = draft_cfg or cfg
    _, t_init, t_prefill, t_cast = _decode_builder(cfg)
    t_chunk = _chunk_builder(cfg)
    d_fwd1, d_init, d_prefill, d_cast = _decode_builder(draft_cfg)
    d_chunk = _chunk_builder(draft_cfg)

    @torch.no_grad()
    def generate(params, draft_params, prompt, max_new: int,
                 draft_k: int = 4, temperature: float = 1.0,
                 top_k: int | None = None, approx_top_k: bool = False,
                 key=None, return_stats: bool = False,
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

        def pick(p, kk):
            if temperature == 0:
                return p.argmax(dim=-1)
            return threefry.categorical(torch.log(p + 1e-30),
                                        threefry.device_keys(kk, dev))

        if temperature != 0 and key is None:
            raise ValueError("sampled decoding needs a key (an int seed or "
                             "threefry key data)")
        key = threefry.as_key(0 if key is None else key)

        buf = torch.zeros((b, total + k + 1), dtype=prompt.dtype,
                          device=dev)
        buf[:, :tp] = prompt
        c_prev2, c_prev = prompt[:, -2], prompt[:, -1]
        pos, accepted, seen = tp, [], []
        while pos < total:
            key, kd1, kdr, ku, kc = threefry.split(key, 5)
            pair = torch.stack([c_prev2, c_prev], dim=1)
            lg2, _ = d_chunk(draft_params, caches_d, pair, pos - 2)
            qs = [probs(lg2[:, 1])]
            ds = [pick(qs[0], kd1)]
            for i in range(1, k):
                kdr, ks = threefry.split(kdr)
                lg, _ = d_fwd1(draft_params, caches_d, ds[-1], pos - 1 + i)
                qs.append(probs(lg))
                ds.append(pick(qs[-1], ks))
            ds_t = torch.stack(ds, dim=1).to(prompt.dtype)
            vlg, _ = t_chunk(params, caches_t,
                             torch.cat([c_prev[:, None], ds_t], dim=1),
                             pos - 1)
            u = upload(threefry.uniform(ku, (b, k)).numpy(), dev)
            n_dev, ctok = _accept_round(probs(vlg), torch.stack(qs, dim=1),
                                        ds_t, u, lambda p: pick(p, kc))
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
