"""Long context in the port, held against the reference on the same numpy
inputs and weights:

- ``_rope_tables`` at positions 0-32,767 against the reference's (f32
  within 2 ulp; bf16 bitwise but at the positions named below);
- ``_cache_rows`` against the Tpad of the reference's ``init_caches`` for
  every total from 1 to 40,000;
- the row-blocked plain flash forward and backward (the plain versions
  ``chip_smoke.py`` holds the kernels to at T >= 8,192) against the
  unblocked ones: forward, lse and dQ bitwise, dK and dV within rel 1e-6;
- the plain flash forward and backward against the reference's
  ``flash_attention_trainable`` (interpret mode) at T 2,048 with the
  reference's ``_flash_blocks`` geometry;
- kernel #3's int8 plain version at the long-context serving width (Hkv*K
  256, G 3) over Tpad 8,704 and its two-tile default against the
  reference's Pallas kernel (interpret mode), and where the one lane that
  parts from it at a rounding tie comes from: not the scale divisions,
  which the reference's compiled body takes as reciprocal products, but
  XLA's fused exp;
- a small GQA + RoPE model (2 layers, 6 query heads over 2 KV heads,
  max_len 2,200): greedy ``transformer_generate`` from a 2,048-token
  prompt against the reference's, and the serving engine with that prompt
  among short ones, slab and paged, piggyback on and off.

The cases marked ``cuda`` run the same on the card through the
hand-written kernels (held against the plain versions or the port on the
CPU) and skip on a host without one. The reference is imported by
fixtures, so they also run where JAX is not installed (``pytest
--noconftest -m cuda`` on the card's machine).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import flash_decode as fd
from deeplearning4j_tpu_torch.serving import Request, ServingEngine

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

#: RoPE positions of the longest configuration (bench.py's
#: transformer-flash-32k) and its head dim
ROPE_POSITIONS = 32768
ROPE_HEAD_DIM = 128
#: (table, position) pairs whose bf16 entry differs from the reference's
#: at head dim 128: each f32 side is within 0.6 ulp of the true value and
#: the two differ by one ulp there, on either side of a bf16 rounding
#: boundary
ROPE_BF16_DIFFS = {("cos", 5819), ("cos", 13852), ("sin", 27582)}
# f32 on both sides: the frameworks sum in different orders
ATOL_F32 = 1e-5
# bf16: the reference's on-device gate for its flash backward
# (bench.py:392)
REL_BF16, ABS_BF16 = 0.02, 0.01
# int8 decode: the bar of tests/test_torch_int8_decode.py
INT8_ATOL = 1e-5
# f32 logits of the two frameworks over a 2,048-token prompt
LOGIT_ATOL = 1e-4
# a greedy token may differ only where the top-2 logit gap is this small
NEAR_TIE = 1e-4

LONG_PROMPT = 2048
NEW = 8
CFG = pt.TransformerConfig(
    vocab_size=128, d_model=96, n_heads=6, n_kv_heads=2, n_layers=2,
    d_ff=192, max_len=2200, rope=True, use_flash=True,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels)")
    return torch.device("cuda")


@pytest.fixture
def jt():
    """The reference's transformer module."""
    pytest.importorskip("jax")
    return pytest.importorskip("deeplearning4j_tpu.models.transformer")


@pytest.fixture
def pk():
    """The reference's Pallas kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    return pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")


# -- RoPE and the cache rows ---------------------------------------------------

def _ulps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|got - ref| in units of the f32 spacing at |ref|."""
    spacing = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    return np.abs(got.astype(np.float64) - ref.astype(np.float64)) / spacing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_tables_match_reference(jt, dtype):
    jnp = pytest.importorskip("jax.numpy")
    pos = np.arange(ROPE_POSITIONS, dtype=np.int32)
    got = pt._rope_tables(torch.from_numpy(pos), ROPE_HEAD_DIM,
                          getattr(torch, dtype), "cpu")
    ref = jt._rope_tables(jnp.asarray(pos), ROPE_HEAD_DIM,
                          getattr(jnp, dtype))
    diffs = set()
    for name, a, b in zip(("cos", "sin"), got, ref):
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            assert _ulps(a, b).max() <= 2, name
        else:
            rows = np.nonzero((a != b).any(-1))[0]
            diffs |= {(name, int(p)) for p in rows}
            # one bf16 step where they differ
            step = np.spacing(np.abs(b).astype(np.float32)) * 2 ** 16
            assert (np.abs(a - b) <= step).all(), name
    if dtype == "bfloat16":
        assert diffs == ROPE_BF16_DIFFS


def test_rope_tables_match_across_devices_on_card(cuda_device):
    """The tables the card computes against the host's, f32: the card's
    cos and sin differ from the CPU's in the last bits only."""
    pos = torch.arange(ROPE_POSITIONS)
    host = pt._rope_tables(pos, ROPE_HEAD_DIM, torch.float32, "cpu")
    card = pt._rope_tables(pos.to(cuda_device), ROPE_HEAD_DIM, torch.float32,
                           cuda_device)
    for a, b in zip(card, host):
        assert _ulps(a.cpu().numpy(), b.numpy()).max() <= 2


def test_cache_rows_match_reference_init_caches(jt, monkeypatch):
    """Tpad of the reference's ``init_caches`` (its own code, with the
    allocation replaced by a shape record) for every total to 40,000."""
    jcfg = jt.TransformerConfig(vocab_size=16, d_model=8, n_heads=2,
                                n_layers=1, d_ff=8, max_len=64)
    _, init, _, _ = jt._decode_builder(jcfg)
    monkeypatch.setattr(jt.jnp, "zeros",
                        lambda shape, dtype=None: types.SimpleNamespace(
                            shape=shape))
    for total in range(1, 40001):
        assert pt._cache_rows(total) == init(1, total).shape[3], total


# -- the row-blocked plain flash versions --------------------------------------

def _qkv(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _blocks_of(monkeypatch, rows: int) -> None:
    """Make the row-blocked plain versions take ``rows`` query rows a block
    at BH 2, T 2,048 (the last block ragged at 1,000)."""
    monkeypatch.setattr(fa, "PLAIN_BLOCK_ELEMS", rows * 2 * 2048)
    assert fa.plain_block_rows(2, 2048) == rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [256, 1000])
def test_blocked_plain_forward_is_bitwise(monkeypatch, dtype, causal, block):
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in _qkv((2, 2048, 16), 1 + causal, 3))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    _blocks_of(monkeypatch, block)
    ob, lseb = fa.flash_attention_fwd_plain_blocked(q, k, v, causal)
    assert torch.equal(ob, o) and torch.equal(lseb, lse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [256, 1000])
def test_blocked_plain_backward(monkeypatch, dtype, causal, block):
    """dQ bitwise; dK and dV (summed over the blocks in f32) within rel
    1e-6 of the gradient's scale in f32, and in bf16 within one bf16 step
    at that scale (the final cast rounds the reassociated sums)."""
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(tdt)
                   for x in _qkv((2, 2048, 16), 3 + causal, 4))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    _blocks_of(monkeypatch, block)
    bq, bk, bv = fa.flash_attention_bwd_plain_blocked(q, k, v, o, lse, do,
                                                      causal)
    assert torch.equal(bq, dq)
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    for got, ref in ((bk, dk), (bv, dv)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= rel * ref.float().abs().max().item(), err


def test_plain_block_rows_bound_the_scores():
    assert fa.plain_block_rows(2, 2048) == 2048
    # BH 4, T 32,768 (transformer-flash-32k): 2,048 rows a block
    assert fa.plain_block_rows(4, 32768) == 2048
    assert fa.plain_block_rows(96, 8192) * 96 * 8192 <= fa.PLAIN_BLOCK_ELEMS


def _ref_flash_blocks(jt, t):
    """The reference's flash geometry at T (training block and prefill):
    ``_flash_blocks`` and ``_flash_bwd_blocks``."""
    bq, bk = jt._flash_blocks(t)
    bbq, bbk = jt._flash_bwd_blocks(t)
    return dict(block_q=bq, block_k=bk, bwd_block_q=bbq, bwd_block_k=bbk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_reference_at_2048(jt, pk, dtype):
    """Forward and gradients of the plain versions (through the port's
    ``flash_attention_trainable`` on CPU tensors) against the reference's
    Pallas kernels in interpret mode at its own T 2,048 geometry."""
    import jax
    import jax.numpy as jnp

    t = 2048
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    q, k, v, do = _qkv((1, 2, t, 16), 7, 4)

    def fwd(q, k, v):
        return pk.flash_attention_trainable(
            q, k, v, interpret=True, causal=True, layout="bhtd",
            **_ref_flash_blocks(jt, t))

    out_ref, vjp = jax.vjp(fwd, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_ref = vjp(jnp.asarray(do, jdt))
    xs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention_trainable(*xs, causal=True, layout="bhtd")
    o.backward(torch.from_numpy(do).to(tdt))
    pairs = [(o.detach(), out_ref)] + [
        (x.grad, g) for x, g in zip(xs, grads_ref)]
    for got, ref in pairs:
        ref = np.asarray(ref, np.float32)
        tol = (ATOL_F32 if dtype == "float32"
               else REL_BF16 * np.abs(ref).max() + ABS_BF16)
        assert np.abs(got.float().numpy() - ref).max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t", [(2, 8192), (1, 32768)])
def test_flash_kernels_match_blocked_plain_on_card(cuda_device, bh, t):
    """#1 and #2 (bf16, D 128: the tensor-core bodies) past T 1,024
    against the row-blocked plain versions, at the bars of phase 2."""
    g = torch.Generator(device=cuda_device).manual_seed(t + bh)
    q, k, v, do = (torch.randn((bh, t, 128), generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain_blocked(q, k, v, True)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    refs = fa.flash_attention_bwd_plain_blocked(q, k, v, o, lse, do, True)
    for x, r in zip(grads, refs):
        tol = REL_BF16 * r.float().abs().max().item() + ABS_BF16
        assert (x.float() - r.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,d", [(2048, 2, 64), (4096, 2, 128)])
def test_reference_flash_gate_on_card(cuda_device, t, heads, d):
    """The reference's on-device gate for its flash backward (bench.py:339)
    on the card: f32 (the FMA bodies), B 1 in the (B, T, H, D) layout,
    gradients of sum(o * sin(o)) against dense attention's autograd in
    f32, ``err < 0.02 * scale + 0.01``."""
    from deeplearning4j_tpu_torch.ops.attention import attention

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(0)
        xs = [torch.from_numpy(rng.normal(size=(1, t, heads, d)).astype(
            np.float32) * 0.5).to(cuda_device) for _ in range(3)]

        def grads(fn):
            leaves = [x.clone().requires_grad_() for x in xs]
            o = fn(*leaves)
            (o * torch.sin(o)).sum().backward()
            return [x.grad for x in leaves]

        got = grads(lambda q, k, v: fa.flash_attention_trainable(
            q, k, v, causal=True))
        ref = grads(lambda q, k, v: attention(q, k, v, causal=True))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(got, ref):
        err = (a - b).abs().max().item()
        assert err < 0.02 * b.abs().max().item() + 0.01


# -- int8 decode at the long-context serving width -----------------------------

#: the long-context serving geometry: GPT-2-small widths with 6 query heads
#: over 2 KV heads of 128 (bench.py:579, gqa=True), 8,192 + 256 + 1
#: positions, so Tpad 8,704 and the reference's int8 tile 4,352 rows
LONG_TPAD = 8704
LONG_G, LONG_HKV, LONG_KD = 3, 2, 128


def _int8_long(seed: int, b: int = 1):
    rng = np.random.default_rng(seed)
    hk = LONG_HKV * LONG_KD
    q = rng.standard_normal((b, LONG_G, hk)).astype(np.float32)
    kv = rng.integers(-127, 128, (1, 2, b, LONG_TPAD, hk)).astype(np.int8)
    scales = (rng.random((1, 2, b, LONG_TPAD, 1)) * 0.02).astype(np.float32)
    return q, kv, scales


def test_int8_long_default_tile_is_two_tiles():
    assert fd.default_block_t(LONG_TPAD, LONG_HKV * LONG_KD, 1) == 4352


#: positions whose output differs from the reference's in one (group, KV
#: head) lane, and that lane: one quantized softmax weight sits at a
#: rounding tie there. At position 4,351 (row 3,956 of the first tile)
#: p * vsc / psc is 1.4999999 in the port (psc = pmax / 127 as one IEEE
#: division, PyTorch's exp) and 1.5 in the reference's kernel, which XLA
#: compiles with psc = pmax * f32(1 / 127) and a fused exp: the reference
#: rounds that weight to 2, the port to 1 (ROADMAP Queue 3)
INT8_TIE_LANES = {4351: (2, 0)}
#: the most one weight's step moves the output in that lane here
INT8_TIE_ATOL = 2e-4


@pytest.mark.parametrize("pos", [4351, 4352, 8447])
def test_int8_plain_two_tile_default_matches_reference(pk, pos):
    """B 1, one layer, Tpad 8,704: the port's plain int8 decode at its
    default tile against the reference's kernel at ITS default, with the
    position before, at and past the second tile's first row. Every lane
    agrees within 1e-5 but the one :data:`INT8_TIE_LANES` names."""
    import jax.numpy as jnp

    q, kv, scales = _int8_long(pos)
    p = np.array([pos], np.int32)
    out_ref = pk.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(p), LONG_HKV,
        interpret=True, kv_scales=jnp.asarray(scales))
    out = fd.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(p),
        LONG_HKV, kv_scales=torch.from_numpy(scales))
    err = np.abs(np.asarray(out_ref) - out.numpy()).reshape(
        LONG_G, LONG_HKV, LONG_KD)
    lane = INT8_TIE_LANES.get(pos)
    if lane is not None:
        assert err[lane].max() <= INT8_TIE_ATOL
        err[lane] = 0.0
    assert err.max() <= INT8_ATOL


#: the tied weight: row 3,956 of the first tile, lane (2, 0), at position
#: 4,351
TIE_POS, TIE_ROW = 4351, 3956


def _ref_int8_long(pk):
    """The reference's int8 decode at the long-context shape, its default
    tile, interpret mode."""
    def ref(q, kv, p, scales):
        return pk.flash_decode_attention(q, kv, p, LONG_HKV, interpret=True,
                                         kv_scales=scales)
    return ref


@pytest.mark.parametrize("pos", [4351, 4352, 8447])
def test_int8_tie_reference_eager_is_jitted(pk, pos):
    """The reference's int8 decode body runs compiled whether it is called
    eagerly or under ``jax.jit`` (interpret mode lowers it through XLA):
    the two calls give the same bits."""
    import jax
    import jax.numpy as jnp

    q, kv, scales = _int8_long(pos)
    args = [jnp.asarray(x) for x in (q, kv, np.array([pos], np.int32),
                                     scales)]
    ref = _ref_int8_long(pk)
    assert np.array_equal(np.asarray(ref(*args)),
                          np.asarray(jax.jit(ref)(*args)))


def test_int8_tie_reference_takes_scales_as_reciprocal_products(pk):
    """XLA's optimized body takes both scales, q's and the softmax
    weights', as max * f32(1/127), a multiplication by the reciprocal."""
    import re

    import jax
    import jax.numpy as jnp

    q, kv, scales = _int8_long(0)
    hlo = jax.jit(_ref_int8_long(pk)).lower(
        jnp.asarray(q), jnp.asarray(kv), jnp.zeros(1, jnp.int32),
        jnp.asarray(scales)).compile().as_text()
    assert "0.00787401572" in hlo
    assert len(re.findall(r"multiply\(%max[.\d]*, %constant[.\d]*\)",
                          hlo)) == 2


@pytest.mark.parametrize("pos", [4351, 4352, 8447])
def test_int8_tie_reciprocal_scales_change_no_bit(monkeypatch, pos):
    """The port's plain int8 decode with its two scales as x * f32(1/127),
    the reference's compiled form, is bitwise the port's IEEE division
    (``_div127``): the division does not decide the tie, and
    :data:`INT8_TIE_LANES` stays."""
    q, kv, scales = (torch.from_numpy(x) for x in _int8_long(pos))
    p = torch.tensor([pos])
    div = fd.flash_decode_attention(q, kv, p, LONG_HKV, kv_scales=scales)
    r127 = torch.tensor(np.float32(1 / 127))
    monkeypatch.setattr(fd, "_div127", lambda x: x * r127)
    mul = fd.flash_decode_attention(q, kv, p, LONG_HKV, kv_scales=scales)
    assert torch.equal(mul, div)


def test_int8_tie_is_decided_by_xlas_fused_exp():
    """At position 4,351 the first tile's largest p * vsc sits where
    s - m is 0 in PyTorch and -1.02e-7 in XLA's fusion of the scores with
    the max and exp (the kernel body's fusion), so XLA's psc is one ulp
    lower and the tied weight's p * vsc / psc exactly 1.5 (rounded to 2),
    where the port's is 1.4999999 (rounded to 1)."""
    import math

    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    tile = fd.default_block_t(LONG_TPAD, LONG_HKV * LONG_KD, 1)
    q, kv, sc = (torch.from_numpy(x) for x in _int8_long(TIE_POS))
    qf = q.float()
    qsc = fd._div127(qf.abs().amax(-1, keepdim=True).clamp_min(1e-8))
    qi = fd._quant8(qf / qsc).reshape(1, LONG_G, LONG_HKV, LONG_KD).double()
    k8 = kv[0, 0].reshape(1, LONG_TPAD, LONG_HKV, LONG_KD)[:, :tile]
    ksc = sc[0, 0, :, :tile, 0] * torch.tensor(1 / math.sqrt(LONG_KD),
                                               dtype=torch.float32)
    vsc = sc[0, 1, 0, :tile, 0].numpy()[:, None]
    dots = torch.einsum("bghk,bthk->bght", qi, k8.double())
    s = (dots.float() * ksc[:, None, None, :] * qsc[..., None])[0]
    p_torch = torch.exp(s - s.amax(-1, keepdim=True)).permute(2, 0, 1) \
        .reshape(tile, -1).numpy()
    lanes = LONG_G * LONG_HKV
    d_i = dots[0].permute(2, 0, 1).reshape(tile, lanes).numpy()

    @jax.jit
    def fused(d, ksc, qmax):
        lane = jnp.repeat(jnp.maximum(qmax, 1e-8) / 127.0, LONG_HKV)
        s = d.astype(jnp.float32) * (ksc * (1.0 / LONG_KD ** 0.5)) * lane
        s = jnp.where(jnp.arange(tile)[:, None] > TIE_POS, -jnp.inf, s)
        return jnp.exp(s - jnp.max(s, axis=0, keepdims=True))

    p_xla = np.asarray(fused(jnp.asarray(d_i.astype(np.int32)),
                             jnp.asarray(sc[0, 0, 0, :tile].numpy()),
                             jnp.asarray(qf.abs().amax(-1)[0].numpy())))
    lane = INT8_TIE_LANES[TIE_POS][0] * LONG_HKV + INT8_TIE_LANES[TIE_POS][1]
    tied = {}
    for name, pr in (("xla", p_xla), ("torch", p_torch)):
        pv = pr * vsc
        psc = np.float32(np.float32(pv.max()) / np.float32(127))
        tied[name] = np.float32(pv[TIE_ROW, lane] / psc)
    assert tied["xla"] == np.float32(1.5)
    assert tied["torch"] == np.nextafter(np.float32(1.5), np.float32(0))
    assert np.rint(tied["xla"]) == 2 and np.rint(tied["torch"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_at_long_tpad_on_card(cuda_device, int8):
    """#3 at B 16 over Tpad 8,704 (positions on either side of the int8
    tile edge, at the row before the last prompt row and at the last
    decode position) against its plain version, and #4 over bs-8 tables
    of 1,088 entries bitwise #3 over the gathered slab."""
    pos = [0, 4351, 4352, 8191, 8447] * 3 + [8447]
    b, hk = len(pos), LONG_HKV * LONG_KD
    g = torch.Generator(device=cuda_device).manual_seed(22 + int8)
    q = torch.randn((b, LONG_G, hk), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    shape = (1, 2, b, LONG_TPAD, hk)
    if int8:
        cache = torch.randint(-127, 128, shape, generator=g,
                              device=cuda_device, dtype=torch.int8)
        scales = torch.rand(shape[:4] + (1,), generator=g,
                            device=cuda_device) * 0.02
    else:
        cache = torch.randn(shape, generator=g, device=cuda_device,
                            dtype=torch.bfloat16)
        scales = None
    p = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    out = fd.flash_decode_attention(q, cache, p, LONG_HKV, kv_scales=scales)
    ref = fd.flash_decode_attention_plain(q, cache, p, LONG_HKV,
                                          kv_scales=scales)
    err = (out.float() - ref.float()).abs()
    if int8:
        step = torch.ldexp(torch.ones_like(ref.float()),
                           torch.frexp(ref.float()).exponent - 8)
        assert (err <= step).all()
    else:
        assert err.max().item() <= 2e-2
    bs = 8
    bps = LONG_TPAD // bs
    perm = torch.randperm(b * bps, generator=g, device=cuda_device) + 1
    tables = perm.reshape(b, bps).to(torch.int32).contiguous()
    blocks = torch.zeros((1, 2, b * bps + 1, bs, hk), dtype=cache.dtype,
                         device=cuda_device)
    blocks[0, :, tables.reshape(-1).long()] = cache[0].reshape(
        2, b * bps, bs, hk)
    bsc = None
    if int8:
        bsc = torch.zeros((1, 2, b * bps + 1, bs, 1), device=cuda_device)
        bsc[0, :, tables.reshape(-1).long()] = scales[0].reshape(
            2, b * bps, bs, 1)
    paged = fd.flash_decode_attention_paged(q, blocks, tables, p, LONG_HKV,
                                            block_scales=bsc)
    assert torch.equal(paged, out)


# -- a small GQA + RoPE model at a 2,048-token prompt --------------------------

_MODELS = {}


def _models(jt):
    """The reference's params for CFG (seed 0) and the port's copy."""
    if "ref" not in _MODELS:
        import jax

        jcfg = jt.TransformerConfig.from_json(CFG.to_json())
        jparams = jt.init_transformer(jax.random.key(0), jcfg)
        _MODELS["ref"] = (jcfg, jparams, pt.params_from_jax(
            jax.tree.map(np.asarray, jparams), CFG, device="cpu"))
    return _MODELS["ref"]


def _long_prompt(seed: int = 1, n: int = LONG_PROMPT) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (1, n)).astype(np.int32)


def _check_greedy(out, ref, seen, n_prompt):
    """Tokens identical, or the first difference at a near-tie of the
    port's logits (the streams part there)."""
    diff = np.nonzero(out[n_prompt:] != ref[n_prompt:])[0]
    if diff.size:
        i = int(diff[0])
        top2 = np.sort(seen[i])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (i, top2)


def test_generate_long_prompt_matches_reference(jt):
    import jax
    import jax.numpy as jnp

    jcfg, jparams, tparams = _models(jt)
    prompt = _long_prompt()
    # the prefill's last-row logits and its cache, then the greedy stream
    fwd, init, prefill, cast = jt._decode_builder(jcfg)
    jcache, jlogits = jax.jit(prefill)(cast(jparams),
                                       init(1, LONG_PROMPT + NEW + 1),
                                       jnp.asarray(prompt))
    _, tinit, tprefill, tcast = pt._decode_builder(CFG)
    tcache, tlogits = tprefill(tcast(tparams),
                               tinit(1, LONG_PROMPT + NEW + 1, "cpu"),
                               torch.from_numpy(prompt))
    assert tcache.shape == jcache.shape == (2, 2, 1, 2560, 32)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               atol=LOGIT_ATOL, rtol=0)
    ref = np.asarray(jt.transformer_generate(jcfg)(
        jparams, jnp.asarray(prompt), jax.random.key(0), max_new=NEW,
        temperature=0.0))[0]
    out, seen = pt.transformer_generate(CFG)(
        tparams, torch.from_numpy(prompt), NEW, temperature=0.0,
        return_logits=True)
    _check_greedy(out[0].numpy(), ref, seen[:, 0].numpy(), LONG_PROMPT)


@pytest.mark.cuda
def test_generate_long_prompt_on_card(cuda_device):
    """Flash prefill (#1 over the expanded KV heads) and the decode kernel
    at Tpad 2,560 on the card against the port on the CPU."""
    params = pt.init_params(CFG, seed=0, device="cpu")
    prompt = torch.from_numpy(_long_prompt())
    ref, _ = pt.transformer_generate(CFG)(params, prompt, NEW,
                                          temperature=0.0, return_logits=True)
    out, seen = pt.transformer_generate(CFG)(
        pt.params_to(params, cuda_device), prompt.to(cuda_device), NEW,
        temperature=0.0, return_logits=True)
    _check_greedy(out[0].cpu().numpy(), ref[0].numpy(),
                  seen[:, 0].float().cpu().numpy(), LONG_PROMPT)


def _engine_requests():
    """The long prompt at the third of 6 requests; the others short, two
    sharing a prefix."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, CFG.vocab_size, 96)
    reqs = []
    for i, n in enumerate((40, 130, LONG_PROMPT, 300, 128, 16)):
        if i == 2:
            prompt = _long_prompt()[0]
        elif i in (3, 4):
            prompt = np.concatenate([shared, rng.integers(
                0, CFG.vocab_size, n - 96)])
        else:
            prompt = rng.integers(0, CFG.vocab_size, n)
        reqs.append(Request(id=f"r{i}", prompt=prompt.astype(np.int32),
                            max_new=NEW))
    return reqs


def _engine_streams(params, device, paged, piggyback):
    engine = ServingEngine(
        CFG, params, n_slots=4, max_total=LONG_PROMPT + NEW + 1,
        decode_horizon=2, temperature=0.0, prefix_cache=True,
        prefill_max_bucket=512, piggyback=piggyback, paged=paged,
        block_size=8, device=device)
    assert engine.pool.tpad == 2560
    assert engine._paged == paged and engine._piggyback == piggyback
    reqs = _engine_requests()
    for r in reqs:
        engine.submit(r)
    results = engine.run()
    if paged:
        # every block came back but the cached segments'
        held = {b for seg in engine.prefix_cache._segments
                for b in seg.block_ids}
        assert engine.pool.n_blocks_in_use == len(held)
    return {r.id: np.asarray(results[r.id]) for r in reqs}


_STREAMS = {}


def _blocking_slab(params, device):
    key = str(device)
    if key not in _STREAMS:
        _STREAMS[key] = _engine_streams(params, device, False, False)
    return _STREAMS[key]


@pytest.mark.parametrize("paged,piggyback",
                         [(False, True), (True, False), (True, True)])
def test_engine_long_prompt_streams(jt, paged, piggyback):
    """Slab and paged, piggyback on and off: byte-identical to the
    blocking slab engine, whose long stream is generate's."""
    _, _, tparams = _models(jt)
    ref = _blocking_slab(tparams, "cpu")
    got = _engine_streams(tparams, "cpu", paged, piggyback)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    gen = pt.transformer_generate(CFG)(
        tparams, torch.from_numpy(_long_prompt()), NEW, temperature=0.0)
    np.testing.assert_array_equal(ref["r2"], gen[0].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("paged,piggyback",
                         [(False, False), (False, True), (True, False),
                          (True, True)])
def test_engine_long_prompt_streams_on_card(cuda_device, paged, piggyback):
    """The same runs on the card (#1 for the short prompts, #3 or #4 at
    Tpad 2,560), byte-identical to the card's blocking slab run: the
    card's kernels sum in other orders than the CPU's plain versions, so
    the streams are held to each other on the card."""
    params = pt.init_params(CFG, seed=0, device="cpu")
    ref = _blocking_slab(params, cuda_device)
    got = _engine_streams(params, cuda_device, paged, piggyback)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
