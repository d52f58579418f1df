"""Kernel #5 of the port, the fused embedding dot, held against the
reference Pallas kernel (interpret mode) on the same numpy inputs, and its
range flag against the raw dot.

CPU tensors take the port's plain version; the ``cuda`` cases run the
hand-written kernel against the plain version and skip on a host without a
card. The reference is imported by a fixture, so the CUDA cases also run
where JAX is not installed (``pytest --noconftest -m cuda`` on the card's
machine).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import emb_dot

# f32 on both sides: only the summation order of the dot differs (the
# reference's own test holds its kernel to XLA at 1e-5)
ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


@pytest.fixture
def ref():
    """The reference: jax.numpy and the Pallas fused embedding dot."""
    jnp = pytest.importorskip("jax.numpy")
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    return jnp, pk.fused_embedding_dot


def _inputs(b, L, d, seed, scale=1.0, mask_rows=()):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((b, d)) * scale).astype(np.float32)
    w = (rng.standard_normal((b, L, d)) * scale).astype(np.float32)
    mask = (rng.random((b, L)) > 0.3).astype(np.float32)
    mask[list(mask_rows)] = 0.0
    return h, w, mask


def _plant(h, w, targets):
    """Set w[b, l] so that <h[b], w[b, l]> lands on targets[b, l] (up to
    f32 rounding, far below the 1e-3 margins planted around 6)."""
    h64 = h.astype(np.float64)
    unit = h64 / (h64 * h64).sum(-1, keepdims=True)
    w[:] = (unit[:, None, :] * targets[:, :, None]).astype(np.float32)
    return w


def _boundary_dots(b, L, seed):
    """Dots at +-(6 - 1e-3) (in range) and +-(6 + 1e-3) (saturated), with
    ordinary values in between."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-4, 4, (b, L))
    sel = rng.integers(0, 5, (b, L))
    t[sel == 1], t[sel == 2] = 6 - 1e-3, -(6 - 1e-3)
    t[sel == 3], t[sel == 4] = 6 + 1e-3, -(6 + 1e-3)
    return t


@pytest.mark.parametrize(
    "b,L,d,block_b,scale",
    [
        (64, 7, 32, 32, 1.0),     # the reference test's shape
        (32, 16, 100, 16, 0.3),   # word2vec.c's D 100, the bench's L 16
        (16, 5, 30, 16, 1.0),     # D % 4 != 0
        (8, 1, 8, 8, 3.0),        # L 1, many saturated dots
    ],
)
def test_plain_matches_pallas(ref, b, L, d, block_b, scale):
    jnp, fused_embedding_dot = ref
    h, w, mask = _inputs(b, L, d, seed=b + d, scale=scale, mask_rows=(0,))
    out_ref = np.asarray(fused_embedding_dot(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(mask), block_b=block_b,
        interpret=True))
    f, in_range = emb_dot.fused_embedding_dot_range(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(mask))
    assert f.shape == (b, L) and f.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), out_ref, atol=ATOL, rtol=0)
    dot = np.einsum("bd,bld->bl", h.astype(np.float64), w.astype(np.float64))
    np.testing.assert_array_equal(in_range.numpy(),
                                  (np.abs(dot) < 6).astype(np.float32))
    np.testing.assert_array_equal(f.numpy()[0], 0.0)  # a masked-out row
    # the public function is the reference's: f alone
    for fn in (emb_dot.fused_embedding_dot, emb_dot.fused_embedding_dot_plain):
        assert torch.equal(fn(torch.from_numpy(h), torch.from_numpy(w),
                              torch.from_numpy(mask)), f)


def test_boundary_flags_match_pallas(ref):
    """Dots planted at 6 -+ 1e-3: f clips (the reference's function), the
    flag says which side of 6 the raw dot fell."""
    jnp, fused_embedding_dot = ref
    b, L, d = 32, 8, 100
    h, w, mask = _inputs(b, L, d, seed=3)
    t = _boundary_dots(b, L, seed=4)
    w = _plant(h, w, t)
    out_ref = np.asarray(fused_embedding_dot(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(mask), block_b=32,
        interpret=True))
    f, in_range = emb_dot.fused_embedding_dot_range(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_allclose(f.numpy(), out_ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(in_range.numpy(),
                                  (np.abs(t) < 6).astype(np.float32))
    sat = np.abs(t) > 6
    assert sat.any() and (~sat).any()
    # saturated dots clip: f is sigmoid(+-6) there
    np.testing.assert_allclose(
        f.numpy()[sat], (mask / (1 + np.exp(-6 * np.sign(t))))[sat],
        atol=ATOL)


def test_unsupported_device_raises():
    x = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        emb_dot.fused_embedding_dot(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,L,d,seed",
    [(4096, 16, 100, 0), (4096, 27, 100, 1), (64, 7, 32, 2), (100, 5, 30, 3),
     (3, 1, 1, 4)],
)
def test_kernel_matches_plain(cuda_device, b, L, d, seed):
    """The CUDA kernel against the plain version on the card: f within
    ATOL, the flag equal (no dot lies within rounding of 6), one launch
    counted per call."""
    h, w, mask = _inputs(b, L, d, seed=seed, scale=0.5, mask_rows=(0,))
    h, w, mask = (torch.from_numpy(x).to(cuda_device) for x in (h, w, mask))
    emb_dot.reset_launches()
    f, in_range = emb_dot.fused_embedding_dot_range(h, w, mask)
    f_ref, in_ref = emb_dot.fused_embedding_dot_range_plain(h, w, mask)
    torch.cuda.synchronize()
    assert emb_dot.launches == 1
    assert (f - f_ref).abs().max().item() <= ATOL
    assert torch.equal(in_range, in_ref)
    assert torch.equal(f[0], torch.zeros_like(f[0]))


@pytest.mark.cuda
def test_kernel_boundary_flags(cuda_device):
    b, L, d = 512, 16, 100
    h, w, mask = _inputs(b, L, d, seed=5)
    t = _boundary_dots(b, L, seed=6)
    w = _plant(h, w, t)
    h, w, mask = (torch.from_numpy(x).to(cuda_device) for x in (h, w, mask))
    f, in_range = emb_dot.fused_embedding_dot_range(h, w, mask)
    f_ref, in_ref = emb_dot.fused_embedding_dot_range_plain(h, w, mask)
    torch.cuda.synchronize()
    assert (f - f_ref).abs().max().item() <= ATOL
    assert torch.equal(in_range, in_ref)
    assert torch.equal(in_range.cpu(),
                       torch.from_numpy((np.abs(t) < 6).astype(np.float32)))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    h = torch.zeros((4, 8), device=cuda_device)
    w = torch.zeros((4, 3, 8), device=cuda_device)
    m = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(TypeError, match="f32"):
        emb_dot.fused_embedding_dot(h.double(), w.double(), m.double())
    with pytest.raises(ValueError, match="contiguous"):
        emb_dot.fused_embedding_dot(h, w.transpose(0, 1).contiguous()
                                    .transpose(0, 1), m)
    with pytest.raises(ValueError, match="match"):
        emb_dot.fused_embedding_dot(h, w[:, :2], m)
