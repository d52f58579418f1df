"""The port's fused cross-entropy held against the reference's custom-VJP
``cross_entropy_with_integer_labels`` on the same numpy logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_ce as jce
from deeplearning4j_tpu_torch.ops import fused_ce as tce

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed=0, shape=(3, 5, 40)):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    targets = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    g = rng.standard_normal(shape[:-1]).astype(np.float32)
    return logits, targets, g


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_values_and_dlogits_match_reference(dtype):
    jdt, tdt = _DTYPES[dtype]
    logits, targets, g = _case()
    ce_ref, vjp = jax.vjp(
        lambda x: jce.cross_entropy_with_integer_labels(x, targets),
        jnp.asarray(logits, jdt))
    (dl_ref,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).to(tdt).requires_grad_()
    ce = tce.cross_entropy_with_integer_labels(x, torch.from_numpy(targets))
    ce.backward(torch.from_numpy(g))
    assert ce.dtype == torch.float32 and ce.shape == targets.shape
    assert x.grad.dtype == tdt and x.grad.shape == logits.shape
    # the f32 reductions sum in other orders; the bf16 dlogits may land one
    # rounding step apart
    assert np.abs(np.asarray(ce_ref) - ce.detach().numpy()).max() <= 1e-5
    tol = 1e-6 if dtype == "f32" else 2 ** -8 * np.abs(g).max()
    err = np.abs(np.asarray(dl_ref, np.float32) - x.grad.float().numpy())
    assert err.max() <= tol


def test_row_chunks_do_not_change_the_arithmetic(monkeypatch):
    logits, targets, g = _case(seed=1, shape=(4, 7, 33))
    x = torch.from_numpy(logits).to(torch.bfloat16)
    t, gt = torch.from_numpy(targets), torch.from_numpy(g)

    def run():
        leaf = x.clone().requires_grad_()
        ce = tce.cross_entropy_with_integer_labels(leaf, t)
        ce.backward(gt)
        return ce.detach(), leaf.grad

    whole = run()
    monkeypatch.setattr(tce, "_CHUNK_ELEMS", 5 * 33)  # 5 rows per chunk
    chunked = run()
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
