"""Operations and bytes, from shapes, and the card's published peaks.

Each input is counted as read once and each output as written once,
whatever a kernel reads again; a causal product counts the T(T+1)/2 pairs
it needs. Kernel numbers follow the port's kernel table: #1 the flash
forward, #2 the flash backward, #3 the flash decode over the slab.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, published dense peaks at the 700 W limit
PEAKS = {
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}

#: rows of Q a block of each forward kernel covers: its grid's x is
#: ceil(T / rows) and its y is B * H
FWD_TILE_ROWS = {"flash_fwd_wgmma_kernel": 128, "flash_fwd_kernel": 64}


def matmul_params(cfg: dict) -> int:
    """Weights that a token multiplies through: q, k, v and the output
    projection, the MLP, and the untied head (no embedding lookup)."""
    d, f, nl, v = (cfg["n_embd"], cfg["n_inner"], cfg["n_layer"],
                   cfg["vocab_size"])
    return nl * (4 * d * d + 2 * d * f) + d * v


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """Training FLOPs a token: 6 x the matmul params plus causal attention,
    6 T d a layer (QK^T and AV at T/2 visible on average, x3 for the
    backward)."""
    return 6.0 * matmul_params(cfg) + 6.0 * seq * cfg["n_embd"] * cfg["n_layer"]


def prefill_flops(cfg: dict, n: int) -> float:
    """Forward FLOPs of one prompt of n tokens: 2 x the matmul params a
    token (the head once: only the last row's logits are needed, but the
    program may take more, and the model needs one) and 4 d a visible pair
    a layer over the n(n+1)/2 causal pairs."""
    d, nl, v = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    body = 2.0 * (matmul_params(cfg) - d * v) * n
    return body + 2.0 * d * v + 4.0 * d * nl * n * (n + 1) / 2


def decode_flops(cfg: dict, ctx: int) -> float:
    """Forward FLOPs of one generated token that attends over ctx rows."""
    return 2.0 * matmul_params(cfg) + 4.0 * cfg["n_embd"] * cfg["n_layer"] * ctx


def flash_fwd(bh: int, t: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one causal #1 launch over (BH, T, D) bf16:
    reads q, k, v, writes o and the f32 lse."""
    pairs = t * (t + 1) // 2
    return 4.0 * bh * pairs * d, 4.0 * bh * t * d * 2 + bh * t * 4


def flash_bwd(bh: int, t: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one causal #2 launch: reads q, k, v, o, dO
    and lse, writes dQ, dK, dV; the five products a backward needs."""
    pairs = t * (t + 1) // 2
    return 10.0 * bh * pairs * d, 8.0 * bh * t * d * 2 + bh * t * 4


def flash_decode(rows: int, b: int, d: int, group: int = 1
                 ) -> tuple[float, float]:
    """(operations, bytes) of #3 over b slot rows that see ``rows`` cache
    rows in all (each slot its position + 1), width d = H_kv K a K and a V
    row, bf16: the rows read, q read and the output written, the int32
    positions read."""
    nbytes = 2.0 * rows * d * 2 + 2.0 * b * group * d * 2 + 4.0 * b
    return 4.0 * rows * d * group, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over HBM bandwidth."""
    return max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
