"""The port's flash attention forward held against the reference Pallas
kernel (interpret mode) on the same numpy inputs.

CPU tensors take the port's plain version; the CUDA case runs the
hand-written kernel and skips on a host without a card. The reference is
imported by a fixture, so the CUDA case also runs where JAX is not
installed (``pytest --noconftest -m cuda`` on the card's machine).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as fa

# f32: the two sides differ only in summation order
ATOL_F32 = 1e-5
# bf16: outputs are bf16 (8 mantissa bits); one rounding step of a value
# of magnitude <= 2 is 2**-7
ATOL_BF16 = 2e-2

_DTYPE_NAMES = {"f32": "float32", "bf16": "bfloat16"}


@pytest.fixture
def ref():
    """The reference: jax.numpy and the Pallas flash forward."""
    jnp = pytest.importorskip("jax.numpy")
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    return jnp, pk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 64])
def test_flash_forward_matches_pallas(ref, dtype, causal, t):
    jnp, pk = ref
    jdt = getattr(jnp, _DTYPE_NAMES[dtype])
    tdt = getattr(torch, _DTYPE_NAMES[dtype])
    q, k, v = _inputs((2, 3, t, 16), seed=t + causal)
    out_ref = pk.flash_attention_trainable(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), block_q=t, block_k=t,
        interpret=True, causal=causal, layout="bhtd",
    )
    out = fa.flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal)
    assert out.dtype == tdt and out.shape == (2, 3, t, 16)
    err = np.abs(np.asarray(out_ref, np.float32) - out.float().numpy()).max()
    assert err <= (ATOL_F32 if dtype == "f32" else ATOL_BF16), err


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_pallas(ref, causal):
    jnp, pk = ref
    q, k, v = _inputs((4, 32, 16), seed=7)
    o_ref, lse_ref = pk._flash_fwd_call(
        *(jnp.asarray(x) for x in (q, k, v)), 32, 32, True, causal)
    o, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal)
    assert lse.shape == (4, 32, 1) and lse.dtype == torch.float32
    assert np.abs(np.asarray(lse_ref) - lse.numpy()).max() <= ATOL_F32
    assert np.abs(np.asarray(o_ref) - o.numpy()).max() <= ATOL_F32


def test_cpu_tensors_do_not_launch():
    fa.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _inputs((2, 8, 16), 1))
    fa.flash_attention_fwd(q, k, v, True)
    assert fa.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 64, 128])
def test_flash_kernel_matches_plain_on_card(cuda_device, t):
    g = torch.Generator(device=cuda_device).manual_seed(t)
    q, k, v = (torch.randn((6, t, 128), generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True)
    assert fa.launches == before + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= ATOL_BF16
    assert (lse - lse_ref).abs().max().item() <= 1e-3


# sequence lengths ragged for both 64- and 128-row tiles, within the flash
# rule of the transformer (8-aligned, <= 128 or a multiple of 128)
CARD_T = (8, 24, 72, 120, 128, 256, 384)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa._HEAD_DIMS)
@pytest.mark.parametrize("t", CARD_T)
def test_flash_kernel_bf16_every_head_dim_on_card(cuda_device, t, d, causal):
    """Every head dim the wrapper takes, BH 3 (a ragged tile that read the
    next head's rows would show), and a second call bitwise equal."""
    g = torch.Generator(device=cuda_device).manual_seed(7 * t + d + causal)
    q, k, v = (torch.randn((3, t, d), generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= ATOL_BF16
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_flash_forward_body_table_on_card(cuda_device):
    """The static (dtype, D) table: bf16 at D 64 and 128 on the tensor
    cores, everything else on the FMA body."""
    for d in fa._HEAD_DIMS:
        assert fa.fwd_body(torch.float32, d) == "fma"
        assert fa.fwd_body(torch.bfloat16, d) == (
            "wgmma" if d in (64, 128) else "fma")


@pytest.mark.cuda
def test_flash_kernel_rejects_misaligned_base_on_card(cuda_device):
    buf = torch.zeros(3 * 64 * 128 + 1, device=cuda_device,
                      dtype=torch.bfloat16)
    q = buf[1:].view(3, 64, 128)  # 2 bytes past an aligned base
    k = v = torch.zeros_like(q)
    with pytest.raises(ValueError, match="16-byte-aligned q"):
        fa.flash_attention_fwd(q, k, v, True)
