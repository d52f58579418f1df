"""Sampled streams of the port held against the reference's on the same
weights and the same threefry keys: ``transformer_generate`` (T 0.8,
top-k 40 and none), speculative decoding with the int8 self-draft, and the
serving engine (the same ``rng_seed`` and request order, K 1 and 4).

The bar is phase 7's rule carried to sampling: the streams are identical,
or at the first divergence the reference's perturbed top-2 margin (the
Gumbel noise of that draw's key plus its filtered, scaled logits, by the
reference's own forward pass) is at most 2 x the largest difference
between the two sides' logits there, plus 1e-5 (the Gumbel noise's
last-bit difference). The reference's Pallas kernels run in interpret
mode; the port's kernels take their plain versions (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.serving import Request, ServingEngine

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

#: the Gumbel noise's cross-framework difference (tests/test_torch_threefry)
NOISE_TOL = 1e-5
TEMP, TOP_K = 0.8, 40

JCFG = jt.TransformerConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_len=64, rope=True, decode_kernel=False,
)
_PARAMS = {}


def _pair(int8=False):
    """(reference params, port cfg, port params) of the grammar tests'
    small model; ``int8`` the int8-weight copy (the self-draft)."""
    if int8 not in _PARAMS:
        jp = jt.init_transformer(jax.random.key(0), JCFG)
        if int8:
            jp = jt.quantize_decode_params(jp, JCFG)
        tcfg = pt.TransformerConfig.from_json(JCFG.to_json())
        _PARAMS[int8] = (jp, tcfg, pt.params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return _PARAMS[int8]


def _u32(k) -> np.ndarray:
    """Port key words (a key, or an int64 tensor) as the uint32 key data
    JAX takes."""
    return np.asarray(k, dtype=np.int64).astype(np.uint32)


def _ref_logits(seq) -> np.ndarray:
    """The reference's f32 next-token logits after ``seq`` (its forward
    pass over the whole sequence)."""
    jp = _pair()[0]
    lg, _ = jt.transformer_apply(JCFG)(jp, jnp.asarray(seq)[None])
    return np.asarray(lg[0, -1], np.float32)


def _filtered_scaled(lg, top_k):
    out = np.asarray(jt._top_k_filter(jnp.asarray(lg), top_k, False))
    return out / np.float32(TEMP)


def _margin(noise, scaled) -> float:
    top2 = np.sort(noise + scaled)[-2:]
    return float(top2[1] - top2[0])


def _check_near_tie(ref, got, first_logits, noise_of, top_k, tp):
    """The bar above for one stream pair: ``first_logits(j)`` the port's
    logits of generated step j, ``noise_of(j)`` the reference's Gumbel
    noise of that draw."""
    diff = np.nonzero(ref != got)[0]
    if not diff.size:
        return None
    i = int(diff[0])
    lg_ref = _ref_logits(ref[:i])
    delta = float(np.abs(first_logits(i - tp) - lg_ref).max())
    m = _margin(noise_of(i - tp), _filtered_scaled(lg_ref, top_k))
    assert m <= 2 * delta / TEMP + NOISE_TOL, (i, m, delta)
    return i, m, delta


@pytest.mark.parametrize("top_k", [TOP_K, None])
def test_generate_sampled_matches_reference(top_k):
    jp, tcfg, tp_ = _pair()
    prompt = np.random.default_rng(1).integers(0, 128, (3, 6)).astype(
        np.int32)
    new, seed = 24, 7
    ref = np.asarray(jt.transformer_generate(JCFG)(
        jp, jnp.asarray(prompt), jax.random.key(seed), new, TEMP, top_k))
    got, seen = pt.transformer_generate(tcfg)(
        tp_, torch.from_numpy(prompt).long(), new, TEMP, top_k, key=seed,
        return_logits=True)
    got = got.numpy()
    subs = pt._step_keys(seed, new)
    for b in range(3):
        _check_near_tie(
            ref[b], got[b], lambda j: seen[j, b].numpy(),
            lambda j: np.asarray(jax.random.gumbel(
                jax.random.wrap_key_data(_u32(subs[j])),
                (3, 128)))[b], top_k, 6)


def test_speculative_sampled_matches_reference():
    """The same key through the reference's and the port's speculative
    decoding (int8 self-draft, k 4): every draft pick, acceptance uniform
    and correction draw takes the reference's key, so the streams are
    identical (no near-tie exemption is stated: the acceptance test
    compares probabilities, where a last-bit difference would flip a
    token only at a probability tie)."""
    jp, tcfg, tp_ = _pair()
    jq, _, tq = _pair(int8=True)
    cfg = dataclasses.replace(JCFG, decode_int8=False)
    prompt = np.random.default_rng(5).integers(0, 128, (1, 8)).astype(
        np.int32)
    for seed in (3, 4):
        ref = np.asarray(jt.transformer_speculative_generate(cfg)(
            jp, jq, jnp.asarray(prompt), jax.random.key(seed), 24,
            draft_k=4, temperature=TEMP, top_k=TOP_K))
        got = pt.transformer_speculative_generate(tcfg)(
            tp_, tq, torch.from_numpy(prompt).long(), 24, draft_k=4,
            temperature=TEMP, top_k=TOP_K, key=seed).numpy()
        np.testing.assert_array_equal(got, ref)


def _engine_reqs(cls, n=6):
    rng = np.random.default_rng(1)
    return [cls(id=f"r{i}", prompt=rng.integers(0, 127, int(
        rng.integers(3, 20))).astype(np.int32), max_new=10)
        for i in range(n)]


@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_sampled_matches_reference(horizon):
    """The port's engine against the reference engine: the same master
    key and request order give every slot the reference's key, and token
    i of a slot is drawn with fold_in(slot key, position)."""
    _engine_against_reference(horizon, seed=3)


def test_engine_sampled_matches_reference_wide_seed():
    """A master seed past 2^32: JAX (64-bit types off) keeps only its low
    word, and so does the port's ``key``."""
    _engine_against_reference(1, seed=2**32 + 5)


def _engine_against_reference(horizon, seed):
    jp, tcfg, tp_ = _pair()
    kw = dict(n_slots=4, max_total=64, temperature=TEMP, top_k=TOP_K,
              decode_horizon=horizon, rng_seed=seed)
    je = JEngine(JCFG, jp, adaptive_horizon=False, **kw)
    te = ServingEngine(tcfg, tp_, device="cpu", **kw)
    a, b = _engine_reqs(JRequest), _engine_reqs(Request)
    for r in a:
        je.submit(r)
    for r in b:
        te.submit(r)
    ref, got = je.run(), te.run()
    # the slots' keys in admission order (FIFO: request order)
    k, keys = threefry.key(seed), []
    for _ in a:
        k, sub = threefry.split(k)
        keys.append(sub)
    for r, s, kd in zip(a, b, keys):
        x, y = np.asarray(ref[r.id]), got[s.id]
        tp = len(r.prompt)
        diff = np.nonzero(x != y)[0]
        if diff.size:
            i = int(diff[0])
            lg_ref = _ref_logits(x[:i])
            # the port's logits there, from its own forward pass
            lg_port = pt.transformer_apply(tcfg)(
                tp_, torch.from_numpy(x[:i][None]).long())[0][0, -1]
            delta = float(np.abs(lg_port.numpy() - lg_ref).max())
            noise = np.asarray(jax.random.gumbel(
                jax.random.fold_in(jax.random.wrap_key_data(
                    _u32(kd)), i), (128,)))
            m = _margin(noise, _filtered_scaled(lg_ref, TOP_K))
            assert m <= 2 * delta / TEMP + NOISE_TOL, (r.id, i - tp, m)
