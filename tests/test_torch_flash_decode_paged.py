"""The port's paged flash decode (kernel #4) held against the reference's
``flash_decode_attention_paged`` (Pallas, interpret mode) on the same numpy
inputs, in f32 and in int8 mode, with shuffled tables and a block aliased
across rows; against the port's own slab version bitwise; and, on the card,
the CUDA kernel against its plain version and bitwise against kernel #3
over the gathered slab.

The reference is imported by a fixture, so the CUDA cases also run where
JAX is not installed (``pytest --noconftest -m cuda`` on the card's
machine).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_decode as fd

# f32 on both sides: only the summation order (and exp's last bit) differs
ATOL = 1e-5
# bf16 kernel vs plain on the card: the kernel rounds its softmax weights
# to bf16 against the running max of each 32-row stage of its split, the
# plain version against the row max
ATOL_BF16 = 2e-2
# int8 kernel vs plain on the card, in bf16 steps of the output: the same
# integer products, divisions and roundings in the same order; only l, the
# sum of a tile's softmax weights, is added up in another order, which can
# move the output's last f32 bit and so its bf16 rounding by one step
INT8_STEPS = 1


def bf16_steps(out, ref):
    """|out - ref| in units of one bf16 step (ulp) of ref's binade."""
    r = ref.float()
    step = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return (out.float() - r).abs() / step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


@pytest.fixture
def ref():
    """The reference Pallas decode kernels (slab and paged)."""
    jnp = pytest.importorskip("jax.numpy")
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    return jnp, pk


def _to_blocks(slab, tables, bs, n_blocks):
    """Pack a (nl, 2, B, T, W) slab into a block pool per (B, T/bs) tables
    (block 0 stays the zero sentinel)."""
    nl, two, b, t, w = slab.shape
    blocks = np.zeros((nl, two, n_blocks, bs, w), slab.dtype)
    for i in range(b):
        for j in range(t // bs):
            blocks[:, :, tables[i, j]] = slab[:, :, i, j * bs:(j + 1) * bs]
    return blocks


def _quantize_rows(raw):
    amax = np.maximum(np.abs(raw).max(-1, keepdims=True), 1e-8)
    scales = (amax / 127.0).astype(np.float32)
    return np.clip(np.round(raw / scales), -127, 127).astype(np.int8), scales


def _case(b, g, hkv, kd, t, bs, seed, int8, alias=True, nl=2):
    """q, slab (+ scales), shuffled 1-based tables with row 1's first block
    aliased to row 0's (the slab rows made equal accordingly), pools."""
    rng = np.random.default_rng(seed)
    bps = t // bs
    q = rng.standard_normal((b, g, hkv * kd)).astype(np.float32)
    raw = rng.standard_normal((nl, 2, b, t, hkv * kd)).astype(np.float32)
    tables = (rng.permutation(b * bps) + 1).reshape(b, bps).astype(np.int32)
    if alias and b > 1:
        tables[1, 0] = tables[0, 0]
        raw[:, :, 1, :bs] = raw[:, :, 0, :bs]
    n_blocks = b * bps + 1
    if int8:
        slab, scales = _quantize_rows(raw)
        return (q, slab, scales, tables, _to_blocks(slab, tables, bs, n_blocks),
                _to_blocks(scales, tables, bs, n_blocks))
    return q, raw, None, tables, _to_blocks(raw, tables, bs, n_blocks), None


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("layer", [0, 1])
def test_paged_plain_matches_pallas(ref, int8, layer):
    """The reference's paged-kernel cases (tests/test_pallas_kernels.py
    :252-348): the plain version at block_t = bs, as the reference tiles."""
    jnp, pk = ref
    b, g, hkv, t, bs = (2, 2, 2, 32, 8) if not int8 else (2, 1, 2, 24, 8)
    q, _, _, tables, blocks, sblocks = _case(b, g, hkv, 16, t, bs,
                                             seed=17 + layer, int8=int8)
    pos = np.array([t - 1, 13 if t > 13 else 7], np.int32)
    out_ref = pk.flash_decode_attention_paged(
        jnp.asarray(q), jnp.asarray(blocks), jnp.asarray(tables),
        jnp.asarray(pos), hkv, layer=layer, interpret=True,
        block_scales=None if sblocks is None else jnp.asarray(sblocks),
    )
    out = fd.flash_decode_attention_paged(
        _t(q), _t(blocks), _t(tables), _t(pos), hkv, layer=layer,
        block_t=bs, block_scales=_t(sblocks))
    assert out.shape == q.shape and out.dtype == torch.float32
    assert np.abs(np.asarray(out_ref) - out.numpy()).max() <= ATOL


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("block_t", [8, None], ids=["bt8", "bt_default"])
def test_paged_plain_is_slab_plain_bitwise(int8, block_t):
    q, slab, scales, tables, blocks, sblocks = _case(
        3, 3, 2, 16, 80, 8, seed=5, int8=int8)
    pos = torch.tensor([79, 0, 41], dtype=torch.int32)
    paged = fd.flash_decode_attention_paged(
        _t(q), _t(blocks), _t(tables), pos, 2, layer=1, block_t=block_t,
        block_scales=_t(sblocks))
    slab_out = fd.flash_decode_attention(
        _t(q), _t(slab), pos, 2, layer=1, block_t=block_t,
        kv_scales=_t(scales))
    assert torch.equal(paged, slab_out)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_sentinel_rows_are_invisible(int8):
    """Unallocated table entries name the sentinel (block 0); rows past
    pos are masked, so what the sentinel or an unreferenced block holds
    never reaches the output."""
    q, slab, scales, _, _, _ = _case(1, 1, 2, 16, 32, 8, seed=29, int8=int8,
                                     alias=False)
    tables = np.zeros((1, 4), np.int32)
    tables[0, 0] = 3
    blocks = np.zeros((2, 2, 8, 8, slab.shape[4]), slab.dtype)
    blocks[:, :, 3] = slab[:, :, 0, :8]
    sblocks = None
    if int8:
        sblocks = np.zeros((2, 2, 8, 8, 1), np.float32)
        sblocks[:, :, 3] = scales[:, :, 0, :8]
    pos = 5
    out = fd.flash_decode_attention_paged(
        _t(q), _t(blocks), _t(tables), pos, 2, block_scales=_t(sblocks))
    ref = fd.flash_decode_attention(_t(q), _t(slab), pos, 2,
                                    kv_scales=_t(scales))
    assert torch.equal(out, ref)
    dirty = blocks.copy()
    dirty[:, :, 0] = 77
    dirty[:, :, 5] = -77
    out2 = fd.flash_decode_attention_paged(
        _t(q), _t(dirty), _t(tables), pos, 2, block_scales=_t(sblocks))
    assert torch.equal(out, out2)


# -- on the card ----------------------------------------------------------------

def _card_case(device, int8, bs, seed=0, g=1, hkv=6):
    """GPT-2-small's decode shape: B 8, Hkv*K 768, 12 layers, Tpad 640,
    positions 0 and 639 among them; shuffled tables over a pool with spare
    blocks, one block aliased across rows 0 and 1."""
    b, kd, nl, t = 8, 128, 12, 640
    bps = t // bs
    gen = torch.Generator(device=device).manual_seed(seed + bs)
    q = torch.randn((b, g, hkv * kd), generator=gen, device=device,
                    dtype=torch.bfloat16)
    n_blocks = b * bps + 9
    perm = torch.randperm(n_blocks - 1, generator=gen, device=device) + 1
    tables = perm[:b * bps].reshape(b, bps).to(torch.int32).contiguous()
    tables[1, 0] = tables[0, 0]
    if int8:
        blocks = torch.randint(-127, 128, (nl, 2, n_blocks, bs, hkv * kd),
                               generator=gen, device=device,
                               dtype=torch.int8)
        scales = torch.rand((nl, 2, n_blocks, bs, 1), generator=gen,
                            device=device) * 0.02
    else:
        blocks = torch.randn((nl, 2, n_blocks, bs, hkv * kd), generator=gen,
                             device=device, dtype=torch.bfloat16)
        scales = None
    blocks[:, :, 0] = 0
    pos = torch.tensor([639, 0, 1, 63, 64, 65, 300, 511], dtype=torch.int32,
                       device=device)
    return q, blocks, scales, tables, pos, hkv


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_paged_kernel_on_card(cuda_device, int8, bs):
    """Kernel #4 against its plain version, and bitwise against kernel #3
    over the gathered slab."""
    q, blocks, scales, tables, pos, hkv = _card_case(cuda_device, int8, bs)
    before = fd.paged_launches
    out = fd.flash_decode_attention_paged(q, blocks, tables, pos, hkv,
                                          layer=7, block_scales=scales)
    assert fd.paged_launches == before + 1
    ref = fd.flash_decode_attention_paged_plain(q, blocks, tables, pos, hkv,
                                                layer=7, block_scales=scales)
    if int8:
        assert bf16_steps(out, ref).max().item() <= INT8_STEPS
    else:
        assert (out.float() - ref.float()).abs().max().item() <= ATOL_BF16
    slab = fd._gather_rows(blocks, tables, 7).contiguous()
    sslab = (None if scales is None
             else fd._gather_rows(scales, tables, 7).contiguous())
    slab_out = fd.flash_decode_attention(q, slab, pos, hkv, layer=0,
                                         kv_scales=sslab)
    assert torch.equal(out, slab_out)


@pytest.mark.cuda
def test_paged_kernel_rejects_other_tiles(cuda_device):
    """A tile that is not a multiple of 8 is refused; 8 (the reference's
    own paged tiling at block size 8) is honoured in both modes: within
    the tolerance of the plain version at that tile, and bitwise the slab
    kernel over the gathered slab at that tile."""
    for int8 in (False, True):
        q, blocks, scales, tables, pos, hkv = _card_case(cuda_device, int8, 8)
        with pytest.raises(ValueError, match="block_t"):
            fd.flash_decode_attention_paged(q, blocks, tables, pos, hkv,
                                            block_t=12, block_scales=scales)
        out = fd.flash_decode_attention_paged(q, blocks, tables, pos, hkv,
                                              layer=2, block_t=8,
                                              block_scales=scales)
        ref = fd.flash_decode_attention_paged_plain(
            q, blocks, tables, pos, hkv, layer=2, block_t=8,
            block_scales=scales)
        if int8:
            assert bf16_steps(out, ref).max().item() <= INT8_STEPS
        else:
            assert (out.float() - ref.float()).abs().max().item() <= ATOL_BF16
        slab = fd._gather_rows(blocks, tables, 2).contiguous()
        sslab = (None if scales is None
                 else fd._gather_rows(scales, tables, 2).contiguous())
        slab_out = fd.flash_decode_attention(q, slab, pos, hkv, layer=0,
                                             block_t=8, kv_scales=sslab)
        assert torch.equal(out, slab_out)
