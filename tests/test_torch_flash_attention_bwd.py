"""The port's differentiable flash attention held against the reference's
``flash_attention_trainable`` (Pallas forward and fused backward in
interpret mode) through ``jax.vjp``, on the same numpy inputs.

CPU tensors take the port's plain versions; the CUDA cases run the
hand-written kernels and skip on a host without a card. The reference is
imported by a fixture, so the CUDA cases also run where JAX is not
installed (``pytest --noconftest -m cuda`` on the card's machine).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops.attention import attention

# f32: the two sides differ only in summation order
ATOL_F32 = 1e-5
# bf16: the reference's on-device gate for its flash backward (bench.py:392);
# gradients are bf16 and the two sides sum their products in other orders
REL_BF16, ABS_BF16 = 0.02, 0.01

_DTYPE_NAMES = {"f32": "float32", "bf16": "bfloat16"}


@pytest.fixture
def ref():
    """The reference: jax, jax.numpy and the Pallas flash kernels."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    return jax, jnp, pk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels)")
    return torch.device("cuda")


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _tol(dtype, ref_grad):
    if dtype == "f32":
        return ATOL_F32
    return REL_BF16 * np.abs(ref_grad).max() + ABS_BF16


def _port_grads(q, k, v, do, tdt, causal, layout):
    qt, kt, vt = (torch.from_numpy(x).to(tdt).requires_grad_() for x in
                  (q, k, v))
    o = fa.flash_attention_trainable(qt, kt, vt, causal=causal,
                                     layout=layout)
    o.backward(torch.from_numpy(do).to(tdt))
    return o, (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("t,block", [(16, 16), (64, 64), (64, 32)])
def test_flash_grads_match_pallas(ref, dtype, causal, layout, t, block):
    """Blocks of 32 at T 64 take the reference's multi-block path (two dq
    partial planes)."""
    jax, jnp, pk = ref
    jdt = getattr(jnp, _DTYPE_NAMES[dtype])
    tdt = getattr(torch, _DTYPE_NAMES[dtype])
    shape = (2, 3, t, 16) if layout == "bhtd" else (2, t, 3, 16)
    q, k, v, do = _inputs(shape, seed=t + block + causal)

    def fwd(q, k, v):
        return pk.flash_attention_trainable(
            q, k, v, block_q=block, block_k=block, interpret=True,
            causal=causal, layout=layout)

    out_ref, vjp = jax.vjp(fwd, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_ref = vjp(jnp.asarray(do, jdt))
    o, grads = _port_grads(q, k, v, do, tdt, causal, layout)
    assert o.dtype == tdt and o.shape == shape
    o_ref = np.asarray(out_ref, np.float32)
    assert np.abs(o_ref - o.detach().float().numpy()).max() <= _tol(
        dtype, o_ref)
    for name, g, g_ref in zip("qkv", grads, grads_ref):
        g_ref = np.asarray(g_ref, np.float32)
        assert g.dtype == tdt and g.shape == shape, name
        err = np.abs(g_ref - g.float().numpy()).max()
        assert err <= _tol(dtype, g_ref), (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_dense_autograd(causal):
    """The plain backward against PyTorch autograd through dense f32
    attention (the port's ``attention``) on the same inputs."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((6, 48, 32), 3))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    dense = attention(*(x[None] for x in leaves), causal=causal,
                      layout="bhtd")[0]
    dense.backward(do)
    assert (dense.detach() - o).abs().max().item() <= ATOL_F32
    for name, g, leaf in zip("qkv", grads, leaves):
        assert (g - leaf.grad).abs().max().item() <= ATOL_F32, name


def test_forward_saves_o_and_lse_and_matches_serving_forward():
    q, k, v = (torch.from_numpy(x) for x in _inputs((2, 3, 32, 16), 5, 3))
    o = fa.flash_attention_trainable(q, k, v, causal=True, layout="bhtd")
    assert torch.equal(o, fa.flash_attention(q, k, v, causal=True))
    with pytest.raises(ValueError, match="layout"):
        fa.flash_attention_trainable(q, k, v, layout="tbhd")


def test_cpu_tensors_do_not_launch_the_backward():
    fa.reset_launches()
    q, k, v, do = (torch.from_numpy(x).requires_grad_() for x in
                   _inputs((1, 2, 16, 16), 1))
    fa.flash_attention_trainable(q, k, v, causal=True,
                                 layout="bhtd").backward(do.detach())
    assert fa.launches == 0 and fa.bwd_launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(128, 128), (100, 64), (64, 256)])
def test_flash_backward_kernel_matches_plain_on_card(cuda_device, dtype,
                                                     causal, t, d):
    tdt = getattr(torch, _DTYPE_NAMES[dtype])
    g = torch.Generator(device=cuda_device).manual_seed(t + d)
    q, k, v, do = (torch.randn((6, t, d), generator=g, device=cuda_device,
                               dtype=tdt) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    before = fa.bwd_launches
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 2
    for name, x, x_ref, x2 in zip("qkv", grads, refs, again):
        assert torch.equal(x, x2), f"d{name} is not reproducible"
        r = x_ref.float()
        tol = (1e-4 * r.abs().max().item() + 1e-5 if dtype == "f32"
               else REL_BF16 * r.abs().max().item() + ABS_BF16)
        assert (x.float() - r).abs().max().item() <= tol, name
