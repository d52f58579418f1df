"""The port's flash decode attention held against the reference Pallas
kernel (interpret mode) on the same numpy inputs: MHA and GQA, scalar and
per-row positions (including 0), a layer > 0 of a multi-layer stack.

CPU tensors take the port's plain version; the CUDA case runs the
hand-written kernel and skips on a host without a card. The reference is
imported by a fixture, so the CUDA case also runs where JAX is not
installed (``pytest --noconftest -m cuda`` on the card's machine).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_decode as fd

# f32 on both sides: only the summation order differs
ATOL = 1e-5
# bf16 kernel vs plain on the card: the kernel rounds its softmax weights
# to bf16 against the running max of each 32-row stage of its split, the
# plain version against the row max
ATOL_BF16 = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


@pytest.fixture
def ref():
    """The reference: jax.numpy and the Pallas flash decode kernel."""
    jnp = pytest.importorskip("jax.numpy")
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    return jnp, pk.flash_decode_attention


def _inputs(b, g, hkv, kd, nl, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g, hkv * kd)).astype(np.float32)
    cache = rng.standard_normal((nl, 2, b, t, hkv * kd)).astype(np.float32)
    return q, cache


@pytest.mark.parametrize(
    "b,g,hkv,kd,pos",
    [
        (3, 1, 4, 16, 5),                              # MHA, scalar pos
        (3, 1, 4, 16, np.array([0, 9, 31], np.int32)),  # MHA, per-row
        (3, 3, 2, 16, 0),                              # GQA, scalar pos 0
        (3, 3, 2, 16, np.array([31, 0, 12], np.int32)),  # GQA, per-row
    ],
)
@pytest.mark.parametrize("layer", [0, 2])
def test_decode_matches_pallas(ref, b, g, hkv, kd, pos, layer):
    jnp, flash_decode_attention = ref
    q, cache = _inputs(b, g, hkv, kd, nl=3, t=32, seed=layer + g)
    out_ref = flash_decode_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(pos),
        n_kv_heads=hkv, layer=layer, interpret=True,
    )
    tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    out = fd.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(cache), tpos, hkv, layer)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert np.abs(np.asarray(out_ref) - out.numpy()).max() <= ATOL


def test_rows_past_pos_do_not_contribute():
    q, cache = _inputs(2, 1, 2, 16, nl=1, t=16, seed=3)
    pos = torch.tensor([4, 10], dtype=torch.int32)
    out = fd.flash_decode_attention(torch.from_numpy(q),
                                    torch.from_numpy(cache), pos, 2, 0)
    garbage = cache.copy()
    garbage[:, :, 0, 5:] = 1e3
    garbage[:, :, 1, 11:] = -1e3
    out2 = fd.flash_decode_attention(torch.from_numpy(q),
                                     torch.from_numpy(garbage), pos, 2, 0)
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("g,hkv", [(1, 6), (3, 2)])
def test_decode_kernel_matches_plain_on_card(cuda_device, g, hkv):
    gen = torch.Generator(device=cuda_device).manual_seed(g)
    b, kd, nl, t = 8, 128, 4, 640
    q = torch.randn((b, g, hkv * kd), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    cache = torch.randn((nl, 2, b, t, hkv * kd), generator=gen,
                        device=cuda_device, dtype=torch.bfloat16)
    pos = torch.tensor([0, 639, 1, 63, 64, 65, 300, 511],
                       dtype=torch.int32, device=cuda_device)
    before = fd.launches
    out = fd.flash_decode_attention(q, cache, pos, hkv, layer=3)
    ref = fd.flash_decode_attention_plain(q, cache, pos, hkv, layer=3)
    assert fd.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= ATOL_BF16


def _card_inputs(device, g, hkv, seed, b=8, nl=4, t=640, kd=128):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, g, hkv * kd), generator=gen, device=device,
                    dtype=torch.bfloat16)
    cache = torch.randn((nl, 2, b, t, hkv * kd), generator=gen,
                        device=device, dtype=torch.bfloat16)
    return q, cache


#: n = pos + 1 on either side of the kernel's split edges (rows per split a
#: multiple of 8 of n / 16: 8 -> 16 at n 129; one 32-row stage -> two at
#: n 513), and 0
SPLIT_EDGE_POS = [0, 7, 8, 127, 128, 511, 512, 639]


@pytest.mark.cuda
@pytest.mark.parametrize("g,hkv", [(1, 6), (3, 2)])
def test_decode_kernel_split_edges_on_card(cuda_device, g, hkv):
    q, cache = _card_inputs(cuda_device, g, hkv, seed=40 + g)
    pos = torch.tensor(SPLIT_EDGE_POS, dtype=torch.int32, device=cuda_device)
    out = fd.flash_decode_attention(q, cache, pos, hkv, layer=1)
    ref = fd.flash_decode_attention_plain(q, cache, pos, hkv, layer=1)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL_BF16
    # the tile changes nothing in this mode; a non-multiple of 8 is refused
    assert torch.equal(out, fd.flash_decode_attention(q, cache, pos, hkv,
                                                      layer=1, block_t=8))
    with pytest.raises(ValueError, match="block_t"):
        fd.flash_decode_attention(q, cache, pos, hkv, layer=1, block_t=12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_rows_are_batch_independent_on_card(cuda_device,
                                                           dtype):
    """Each row decodes bitwise the same alone (B 1) as in the batch of 8,
    and a second launch repeats the first bitwise."""
    q, cache = _card_inputs(cuda_device, 1, 6, seed=50)
    q, cache = q.to(dtype), cache.to(dtype)
    pos = torch.tensor(SPLIT_EDGE_POS, dtype=torch.int32, device=cuda_device)
    out = fd.flash_decode_attention(q, cache, pos, 6, layer=2)
    assert torch.equal(out, fd.flash_decode_attention(q, cache, pos, 6,
                                                      layer=2))
    for i in range(q.shape[0]):
        one = fd.flash_decode_attention(
            q[i:i + 1].contiguous(), cache[:, :, i:i + 1].contiguous(),
            pos[i:i + 1], 6, layer=2)
        assert torch.equal(one[0], out[i])
