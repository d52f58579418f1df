"""The port's threefry key stream (``ops/threefry.py``) held against
``jax.random`` under its defaults (threefry2x32, partitionable counters):
keys, splits, folds, raw bits and uniforms bitwise; Gumbel noise within a
stated tolerance (XLA's ``log`` and PyTorch's differ in the last bits);
``categorical`` tokens equal except at stated near-ties, in both of its
modes. The host key chains (the cipher on Python ints) and the tensor
rows agree bitwise. The draw kernel is held against its plain version on
the card (``cuda``)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import threefry

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# Gumbel noise vs jax.random.gumbel: -log(-log(u)) of bitwise-equal
# uniforms, through two logs that may each round one or two ulps apart
GUMBEL_ATOL = 2e-6
# a token may differ from JAX's only where JAX's perturbed top-2 margin is
# below this (a few ulps of the noise, at the perturbed values' scale)
NEAR_TIE = 1e-5
SEED = 42


@pytest.fixture
def jax():
    """The reference, for the CPU cases (the card's machine has no JAX)."""
    return pytest.importorskip("jax")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written draw kernel)")
    return torch.device("cuda")


def _jkey(jax, seed=SEED):
    return jax.random.key(seed)


def _u32(k) -> np.ndarray:
    """Port key words or bits (keys, or an int64 tensor) as uint32."""
    return np.asarray(k, dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 + 5,
                                  2**40 + 3, 2**63 - 1, -2**31 - 1, -2**40])
def test_key_matches_jax(jax, seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(_u32(threefry.key(seed)), want)
    assert all(type(w) is int for w in threefry.key(seed))


@pytest.mark.parametrize("seed", [2**63, -2**63 - 1])
def test_key_out_of_range_raises_as_jax(jax, seed):
    with pytest.raises(OverflowError):
        jax.random.key(seed)
    with pytest.raises(OverflowError):
        threefry.key(seed)


@pytest.mark.parametrize("n", [2, 5])
def test_split_matches_jax(jax, n):
    want = np.asarray(jax.random.key_data(jax.random.split(_jkey(jax), n)))
    np.testing.assert_array_equal(_u32(threefry.split(SEED, n)), want)
    # key, sub = split(key): row 0 the new key, row 1 the subkey
    k, sub = threefry.split(threefry.key(SEED))
    jk, jsub = jax.random.split(_jkey(jax))
    np.testing.assert_array_equal(_u32(k),
                                  np.asarray(jax.random.key_data(jk)))
    np.testing.assert_array_equal(_u32(sub),
                                  np.asarray(jax.random.key_data(jsub)))


@pytest.mark.parametrize("data", [0, 1, 639, 2**31 - 1, 2**32 - 1])
def test_fold_in_matches_jax(jax, data):
    want = np.asarray(jax.random.key_data(jax.random.fold_in(_jkey(jax),
                                                             data)))
    np.testing.assert_array_equal(_u32(threefry.fold_in(SEED, data)), want)


@pytest.mark.parametrize("data", [2**32, -1])
def test_fold_in_out_of_range_raises_as_jax(jax, data):
    """Data outside [0, 2^32) is refused as JAX refuses it (64-bit types
    off), not masked into range."""
    with pytest.raises(OverflowError):
        jax.random.fold_in(_jkey(jax), data)
    with pytest.raises(OverflowError):
        threefry.fold_in(SEED, data)


@pytest.mark.parametrize("shape", [(7,), (50304,), (3, 50304)])
def test_bits_and_uniform_match_jax(jax, shape):
    bits = np.asarray(jax.random.bits(_jkey(jax), shape))
    np.testing.assert_array_equal(_u32(threefry.random_bits(SEED, shape)),
                                  bits)
    u = np.asarray(jax.random.uniform(_jkey(jax), shape))
    np.testing.assert_array_equal(
        threefry.uniform(SEED, shape).numpy().view(np.uint32),
        u.view(np.uint32))
    tiny = np.finfo(np.float32).tiny
    g = np.asarray(jax.random.uniform(_jkey(jax), shape, minval=tiny,
                                      maxval=1.0))
    np.testing.assert_array_equal(
        threefry.uniform(SEED, shape, tiny, 1.0).numpy().view(np.uint32),
        g.view(np.uint32))


def test_torch_side_matches_host_bitwise():
    """The tensor rows give the host key chains' bits (the cipher on Python
    ints): fold_in over rows, bits over per-row counters (rows mode) and
    over flat counters r * V + v (one key), uniforms from the bits."""
    keys = [threefry.split(s)[1] for s in range(5)]
    pos = [0, 1, 639, 2**31 - 1, 77]
    folded = threefry.fold_in_rows(torch.tensor(keys), torch.tensor(pos))
    want = torch.tensor([threefry.fold_in(k, p) for k, p in zip(keys, pos)])
    assert torch.equal(folded, want)
    rows = threefry.random_bits_rows(folded, 1000)
    assert torch.equal(rows, torch.stack([threefry.random_bits(k, (1000,))
                                          for k in want]))
    k = torch.tensor(threefry.key(SEED))
    flat = threefry.random_bits_rows(k.reshape(1, 2).expand(3, 2), 1000,
                                     torch.arange(3) * 1000)
    assert torch.equal(flat, threefry.random_bits(SEED, (3, 1000)))
    assert torch.equal(threefry.uniform_from_bits(flat),
                       threefry.uniform(SEED, (3, 1000)))


def test_gumbel_within_tolerance(jax):
    shape = (8, 50304)
    want = np.asarray(jax.random.gumbel(_jkey(jax), shape))
    got = threefry.gumbel_from_bits(threefry.random_bits(SEED,
                                                         shape)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def _perturbed_margin(jax, key, logits):
    """JAX's perturbed top-2 margin of each row of a (V,) draw under
    ``key``."""
    g = np.asarray(jax.random.gumbel(key, logits.shape[-1:]))
    top2 = np.sort(g + logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("mode", ["rows", "flat"])
def test_categorical_matches_jax(jax, mode):
    """Both modes' tokens equal ``jax.random.categorical``'s, except at
    rows whose perturbed top-2 margin is below NEAR_TIE (counted and
    reported)."""
    jnp = jax.numpy
    rng = np.random.default_rng(0)
    r, v = 32, 50304
    logits = (rng.standard_normal((r, v)) * 2).astype(np.float32)
    logits[3, 10:] = -np.inf  # a grammar-style mask: 10 tokens allowed
    if mode == "rows":
        keys = torch.tensor([threefry.split(s)[1] for s in range(r)])
        pos = rng.integers(0, 640, r).astype(np.int32)
        jkeys = jax.vmap(jax.random.fold_in)(
            jax.random.wrap_key_data(_u32(keys)), jnp.asarray(pos))
        want = np.asarray(jax.vmap(jax.random.categorical)(
            jkeys, jnp.asarray(logits)))
        got = threefry.categorical(torch.from_numpy(logits), keys,
                                   torch.from_numpy(pos)).numpy()
        margins = np.array([_perturbed_margin(jax, k, row)
                            for k, row in zip(jkeys, logits)])
    else:
        want = np.asarray(jax.random.categorical(_jkey(jax),
                                                 jnp.asarray(logits)))
        got = threefry.categorical(torch.from_numpy(logits), torch.tensor(
            threefry.key(SEED))).numpy()
        g = np.asarray(jax.random.gumbel(_jkey(jax), (r, v)))
        top2 = np.sort(g + logits, axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
    assert got.dtype == np.int32
    diff = np.nonzero(got != want)[0]
    print(f"{mode}: {len(diff)} of {r} rows differ, margins there "
          f"{margins[diff].tolist()}")
    assert (margins[diff] < NEAR_TIE).all(), (diff, margins[diff])
    assert got[3] < 10


def test_categorical_plain_ties_masks_and_values():
    """First index of the maximum on an exact tie (two tokens at 1e30, where
    the noise vanishes), a row of -inf but 3 allowed tokens, and the
    winning value is the perturbed maximum (-0.0 as +0.0)."""
    r, v = 3, 5000
    logits = torch.randn((r, v), generator=torch.Generator().manual_seed(0))
    logits[1] = float("-inf")
    logits[1, [5, 700, 4000]] = 0.0
    logits[2, [100, 4000]] = 1e30
    keys = torch.tensor([threefry.split(s)[1] for s in range(r)])
    pos = torch.tensor([0, 9, 639], dtype=torch.int32)
    tok, val = threefry.draw(logits, keys, pos)
    assert int(tok[2]) == 100 and float(val[2]) == float(np.float32(1e30))
    assert int(tok[1]) in (5, 700, 4000)
    pert = threefry.gumbel_from_bits(threefry.random_bits_rows(
        threefry.fold_in_rows(keys, pos), v)) + logits
    assert torch.equal(val, pert.max(dim=-1).values + 0.0)


def test_unsupported_device_raises():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        threefry.draw(x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,flat", [(1, 50304, True), (4, 50304, True),
                                      (8, 50304, False), (3, 1000, False),
                                      (2, 1, True)])
def test_kernel_matches_plain(cuda_device, r, v, flat):
    """Tokens and winning values bitwise the plain version's on the same
    card tensors, with a masked row and a planted tie in rows mode."""
    gen = torch.Generator(device=cuda_device).manual_seed(r + v)
    logits = torch.randn((r, v), generator=gen, device=cuda_device) * 3
    if flat:
        keys = threefry.device_keys(threefry.key(11), cuda_device)
        pos = None
    else:
        keys = threefry.device_keys(
            [threefry.split(s)[1] for s in range(r)], cuda_device)
        pos = torch.arange(r, dtype=torch.int32, device=cuda_device) * 91
        logits[1] = float("-inf")
        logits[1, [3, v // 2, v - 1]] = 1.0
        logits[0, [2, v - 2]] = 1e30
    tok, val = threefry.draw(logits, keys, pos)
    tok_ref, val_ref = threefry.categorical_plain(logits, keys, pos)
    assert torch.equal(tok, tok_ref)
    assert torch.equal(val.view(torch.int32), val_ref.view(torch.int32))
    if not flat:
        assert int(tok[0]) == 2


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 8), device=cuda_device)
    keys = torch.zeros((2, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        threefry.draw(x.double(), keys, torch.zeros(2, dtype=torch.int32,
                                                    device=cuda_device))
    with pytest.raises(ValueError):
        threefry.draw(x, keys)  # flat mode takes one (2,) key
    with pytest.raises(ValueError):
        threefry.draw(x[:, ::2], keys[0])
