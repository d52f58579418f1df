"""Kernel #5's fused mode (``fused_hs_rows``): one HS batch's gathers,
dots, g, grad_in and g ⊗ h delta rows in one pass.

The plain version is held against the JAX package's HS formulas
(deeplearning4j_tpu/models/word2vec.py `_hs_math_merged`, run in jnp on the
same numpy inputs) with dots planted at 6 -+ 1e-3 and masked rows; the
card's HS step (`_hs_sorted_update`: scatter plan, deltas written at their
sorted positions, apply) is run here on CPU tensors against the CPU's
index_add_ step, with the entries the card leaves unwritten filled with
NaN. The ``cuda`` cases
hold the hand-written kernel against the plain version and skip on a host
without a card; the reference is imported by a fixture, so they also run
where JAX is not installed (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import word2vec as w2v
from deeplearning4j_tpu_torch.ops import emb_dot

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# f32 on both sides: the dots and the grad_in sums are added up in other
# orders (XLA's einsum vs an elementwise product summed; the kernel's
# fmaf chain and shuffle tree), as for one batch update in
# tests/test_torch_word2vec.py
ATOL = 1e-5
# a whole HS batch through the scatter: runs of up to B entries summed in
# other orders (tests/test_torch_word2vec.py's scatter bar)
STEP_ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


@pytest.fixture
def jax():
    return pytest.importorskip("jax")


def _batch(b, L, d, seed, v=None, n1=None, plant=False):
    """One HS batch on a merged table S = inputs | syn1: (S, v, inputs,
    codes, points, mask, lr, t). A quarter of the rows are masked out
    whole, the others keep a random prefix of their path; with ``plant``
    each path entry has its own syn1 row and the dot of every entry is
    planted at a target t: 6 -+ 1e-3 (in range, saturated, both signs) or
    ordinary values."""
    rng = np.random.default_rng(seed)
    v = v or b
    n1 = n1 or (b * L if plant else 3 * L)
    S = rng.normal(0, 0.3, (v + n1, d)).astype(np.float32)
    inputs = rng.integers(0, v, b)
    inputs[: b // 8] = 0  # a repeated input row
    codes = rng.integers(0, 2, (b, L)).astype(np.float32)
    if plant:
        points = rng.permutation(b * L).reshape(b, L)
    else:
        points = rng.integers(0, n1, (b, L))
        points[:, 0] = 0  # the root is on every path
    lens = rng.integers(1, L + 1, b)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    mask[rng.permutation(b)[: b // 4]] = 0.0
    t = None
    if plant:
        t = rng.uniform(-4, 4, (b, L))
        sel = rng.integers(0, 5, (b, L))
        t[sel == 1], t[sel == 2] = 6 - 1e-3, -(6 - 1e-3)
        t[sel == 3], t[sel == 4] = 6 + 1e-3, -(6 + 1e-3)
        h64 = S[inputs].astype(np.float64)
        unit = h64 / (h64 * h64).sum(-1, keepdims=True)
        S[v + points] = (unit[:, None, :] * t[:, :, None]).astype(np.float32)
    return S, v, inputs, codes, points, mask, np.float32(0.05), t


def _torch(S, v, inputs, codes, points, mask, lr, device="cpu"):
    """The batch as tensors on ``device``; S is copied (the HS step updates
    its table in place)."""
    return (torch.from_numpy(S.copy()).to(device), v,
            torch.from_numpy(inputs).to(device),
            torch.from_numpy(codes).to(device),
            torch.from_numpy(points).to(device),
            torch.from_numpy(mask).to(device), float(lr))


def _reference_rows(jax, S, v, inputs, codes, points, mask, lr):
    """The JAX package's HS formulas (word2vec.py:66-84) up to its scatter:
    (grad_in, delta rows)."""
    jnp = jax.numpy
    S = jnp.asarray(S)
    h = S[jnp.asarray(inputs)]
    w1 = S[v + jnp.asarray(points)]
    dot = jnp.einsum("bd,bld->bl", h, w1)
    f = jax.nn.sigmoid(dot)
    in_range = (jnp.abs(dot) < 6.0).astype(f.dtype)
    g = (1.0 - jnp.asarray(codes) - f) * lr * jnp.asarray(mask) * in_range
    grad_in = jnp.einsum("bl,bld->bd", g, w1)
    deltas = (g[:, :, None] * h[:, None, :]).reshape(-1, S.shape[1])
    return np.asarray(grad_in), np.asarray(deltas)


@pytest.mark.parametrize("d", [16, 30, 100])
def test_plain_matches_reference_formulas(jax, d):
    """grad_in and the delta rows against the reference's HS formulas,
    within ATOL, with masked rows and dots planted on both sides of 6;
    saturated and masked entries give exact-zero delta rows, in-range ones
    do not."""
    b, L = 64, 8
    S, v, inputs, codes, points, mask, lr, t = _batch(b, L, d, seed=d,
                                                      plant=True)
    grad_ref, deltas_ref = _reference_rows(jax, S, v, inputs, codes, points,
                                           mask, lr)
    out = emb_dot.fused_hs_rows_plain(*_torch(S, v, inputs, codes, points,
                                              mask, lr))
    assert out.shape == (b + b * L, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out[:b].numpy(), grad_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[b:].numpy(), deltas_ref, atol=ATOL,
                               rtol=0)
    zero = (out[b:] == 0).all(-1).numpy().reshape(b, L)
    live = (mask > 0) & (np.abs(t) < 6)
    np.testing.assert_array_equal(zero, ~live)
    assert live.any() and ((mask > 0) & (np.abs(t) > 6)).any()
    # the public entry takes the plain version for CPU tensors
    assert torch.equal(emb_dot.fused_hs_rows(*_torch(
        S, v, inputs, codes, points, mask, lr)), out)


def test_plain_writes_at_dest_and_into_out():
    b, L, d = 32, 6, 12
    S, v, inputs, codes, points, mask, lr, _ = _batch(b, L, d, seed=1)
    args = _torch(S, v, inputs, codes, points, mask, lr)
    dense = emb_dot.fused_hs_rows_plain(*args)
    dest = torch.from_numpy(np.random.default_rng(2).permutation(b + b * L))
    moved = emb_dot.fused_hs_rows_plain(*args, dest=dest)
    assert torch.equal(moved[dest], dense)
    buf = torch.full_like(dense, float("nan"))
    assert emb_dot.fused_hs_rows_plain(*args, out=buf) is buf
    assert torch.equal(buf, dense)


def _unwritten_nan(S, v, inputs, codes, points, mask, lr, dest=None,
                   out=None):
    """The plain fused mode with NaN at the positions of the masked entries
    (mask 0), which the kernel leaves unwritten when given ``dest``."""
    out = emb_dot.fused_hs_rows_plain(S, v, inputs, codes, points, mask, lr,
                                      dest, out)
    out[dest[len(inputs):][mask.reshape(-1) == 0]] = float("nan")
    return out


@pytest.mark.parametrize("d", [16, 30])
def test_card_step_matches_cpu_step(monkeypatch, d):
    """The card's step (word2vec.py `_hs_sorted_update`: plan, deltas at
    their sorted positions, apply), run on CPU tensors with NaN where the
    kernel writes nothing, equals the CPU's index_add_ step within
    STEP_ATOL and reads no NaN; untouched rows keep their bits."""
    b, L = 64, 8
    S, v, inputs, codes, points, mask, lr, _ = _batch(b, L, d, seed=7 + d)
    want = w2v._hs_math_merged(*_torch(S, v, inputs, codes, points, mask,
                                       lr))
    monkeypatch.setattr(w2v, "fused_hs_rows", _unwritten_nan)
    got, *rest = _torch(S, v, inputs, codes, points, mask, lr)
    w2v._hs_sorted_update(got, *rest)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=STEP_ATOL,
                               rtol=0)
    touched = np.zeros(len(S), bool)
    touched[inputs] = True
    touched[v + points[mask > 0]] = True
    np.testing.assert_array_equal(got.numpy()[~touched], S[~touched])


# -- on the card ----------------------------------------------------------------

def _kernel_vs_plain(dev, b, L, d, seed, plant=False, v=None, n1=None):
    """The kernel with ``dest`` the list's own order (the card writes only
    at a dest), into a NaN-filled buffer, and the plain version: (args,
    dest, out, ref, kept, mask, t), ``kept`` the entries the scatter keeps
    (every input, the path entries with mask > 0)."""
    S, v, inputs, codes, points, mask, lr, t = _batch(
        b, L, d, seed=seed, plant=plant, v=v, n1=n1)
    args = _torch(S, v, inputs, codes, points, mask, lr, device=dev)
    n = b + b * L
    dest = torch.arange(n, device=dev)
    emb_dot.reset_launches()
    out = emb_dot.fused_hs_rows(*args, dest=dest, out=torch.full(
        (n, d), float("nan"), device=dev))
    ref = emb_dot.fused_hs_rows_plain(*args)
    torch.cuda.synchronize()
    assert emb_dot.launches == 1
    kept = torch.cat([torch.ones(b, dtype=torch.bool),
                      torch.from_numpy(mask.reshape(-1) > 0)]).to(dev)
    return args, dest, out, ref, kept, mask, t


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,L,d,seed",
    [(4096, 22, 100, 0),   # the full-width fit's batch and longest path
     (4096, 16, 100, 1),
     (300, 40, 100, 2),    # a path longer than one 32-entry window
     (64, 8, 16, 3),
     (100, 5, 30, 4),      # D % 4 != 0: float chunks
     (256, 12, 300, 5),    # D 300: three float4 chunks a lane
     (64, 7, 600, 6),      # wider than the register rows: streamed
     (64, 7, 131, 7),      # scalar and streamed
     (3, 1, 1, 8)],
)
def test_kernel_matches_plain(cuda_device, b, L, d, seed):
    """Every kept entry within ATOL of the plain version and the masked
    ones left unwritten (NaN); the zero pattern of the kept entries
    (saturated dots) equal; a second launch bitwise equal to the first."""
    args, dest, out, ref, kept, _, _ = _kernel_vs_plain(cuda_device, b, L,
                                                        d, seed)
    assert (out[kept] - ref[kept]).abs().max().item() <= ATOL
    assert bool(torch.isnan(out[~kept]).all())
    assert torch.equal((out[kept] == 0).all(-1), (ref[kept] == 0).all(-1))
    assert torch.equal(emb_dot.fused_hs_rows(*args, dest=dest)[kept],
                       out[kept])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 30])
def test_kernel_planted_edges(cuda_device, d):
    """Dots planted at 6 -+ 1e-3 with masked rows: of the kept path
    entries, the in-range ones and only they carry nonzero deltas, as in
    the plain version."""
    b, L = 512, 16
    _, _, out, ref, kept, mask, t = _kernel_vs_plain(cuda_device, b, L, d,
                                                     seed=9, plant=True)
    assert (out[kept] - ref[kept]).abs().max().item() <= ATOL
    valid = torch.from_numpy(mask > 0).to(cuda_device)
    live = torch.from_numpy(np.abs(t) < 6).to(cuda_device)
    rows = out[b:].view(b, L, d)
    assert torch.equal((rows[valid] != 0).any(-1), live[valid])


@pytest.mark.cuda
def test_kernel_fills_nan_buffer_and_writes_at_dest(cuda_device):
    """Into a NaN-filled buffer at ``dest`` (the scatter plan's): every
    kept entry is written where the plain version puts it, with the bits
    it has in the list's own order, and the masked ones are left NaN; the
    apply reads no NaN and matches the CPU step; a repeat is bitwise
    equal."""
    b, L, d = 4096, 22, 100
    S, v, inputs, codes, points, mask, lr, _ = _batch(
        b, L, d, seed=11, v=20000, n1=20000)
    args = _torch(S, v, inputs, codes, points, mask, lr, device=cuda_device)
    n = b + b * L
    St, _, inp, _, pts, msk, _ = args
    rows = torch.cat([inp, (v + pts).reshape(-1)])
    keep = torch.cat([torch.ones_like(inp, dtype=torch.bool),
                      msk.reshape(-1) > 0])
    plan = w2v._scatter_plan(rows, keep, St.shape[0], inverse=True)
    buf = torch.full((n, d), float("nan"), device=cuda_device)
    moved = emb_dot.fused_hs_rows(*args, dest=plan.dest, out=buf)
    assert moved is buf
    own = emb_dot.fused_hs_rows(*args, dest=torch.arange(
        n, device=cuda_device))
    assert torch.equal(moved[plan.dest[keep]], own[keep])
    assert bool(torch.isnan(moved[plan.dest[~keep]]).all())
    ref = emb_dot.fused_hs_rows_plain(*args, dest=plan.dest)
    assert (moved[plan.dest[keep]] - ref[plan.dest[keep]]).abs().max() <= ATOL
    outs = []
    for _ in range(2):
        S2 = St.clone()
        w2v._hs_math_merged(S2, v, inp, args[3], pts, msk, lr)
        outs.append(S2)
    assert torch.equal(outs[0], outs[1]) and bool(torch.isfinite(
        outs[0]).all())
    want = w2v._hs_math_merged(*_torch(S, v, inputs, codes, points, mask,
                                       lr))
    np.testing.assert_allclose(outs[0].cpu().numpy(), want.numpy(),
                               atol=STEP_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    S, v, inputs, codes, points, mask, lr, _ = _batch(8, 3, 8, seed=0)
    args = list(_torch(S, v, inputs, codes, points, mask, lr,
                       device=cuda_device))
    dest = torch.arange(8 + 8 * 3, device=cuda_device)
    with pytest.raises(ValueError, match="dest"):
        emb_dot.fused_hs_rows(*args)
    with pytest.raises(TypeError, match="int64"):
        emb_dot.fused_hs_rows(*args[:2], args[2].int(), *args[3:], dest=dest)
    with pytest.raises(ValueError, match="contiguous"):
        emb_dot.fused_hs_rows(*args[:4], args[4].t().contiguous().t(),
                              *args[5:], dest=dest)
    with pytest.raises(ValueError, match="match"):
        emb_dot.fused_hs_rows(*args[:3], args[3][:, :2], *args[4:],
                              dest=dest)
    with pytest.raises(ValueError, match="dest"):
        emb_dot.fused_hs_rows(*args, dest=torch.zeros(
            3, dtype=torch.int64, device=cuda_device))


_TRAP = """
import os
import sys
import torch
sys.path.insert(0, {root!r})
from deeplearning4j_tpu_torch.ops import emb_dot
b, L, d, v = 8, 3, 8, 8
S = torch.randn((v + 2 * L, d), device="cuda")
inputs = torch.arange(b, device="cuda")
points = torch.arange(L, device="cuda").repeat(b, 1)
codes = torch.zeros((b, L), device="cuda")
mask = torch.ones((b, L), device="cuda")
mask[:, -1] = 0.0
dest = torch.arange(b + b * L, device="cuda")
{bad}
try:
    emb_dot.fused_hs_rows(S, v, inputs, codes, points, mask, 0.1, dest=dest)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised", e)
else:
    print("ok")
sys.stdout.flush()
os._exit(0)  # no teardown on a context the trap has poisoned
"""


@pytest.mark.cuda
@pytest.mark.parametrize("bad,want", [
    ("", "ok"),
    ("inputs[3] = v + 2 * L", "raised"),          # an input past S
    ("points[5, 1] = 2 * L", "raised"),           # a valid path row past S
    ("points[5, 2] = 10 ** 9", "ok"),             # a masked entry: not read
    ("dest[b + 4] = b + b * L", "raised"),        # a dest past the buffer
])
def test_kernel_traps_on_an_index_out_of_range(cuda_device, bad, want):
    """An index the kernel would read or write past its tables traps (a
    sticky launch failure, so each case runs in its own process) and the
    caller gets a RuntimeError, as PyTorch's device-side index assert
    gives; the index of a masked entry is never read."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    r = subprocess.run(
        [sys.executable, "-c", _TRAP.format(root=root, bad=bad)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[0] == want, r.stdout
