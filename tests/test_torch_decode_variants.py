"""The port's beam search, speculative decoding and ``approx_top_k`` filter
held against the reference's at f32 on the same inputs, with the
reference's params carried over by ``params_from_jax``.

The reference's Pallas kernels run in interpret mode (its own CPU default);
the port's run their plain versions (CPU tensors).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.serving import Request, ServingEngine

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# f32 beam scores: sums of a few f32 log-probs, each within the decode
# tests' logit tolerance of the reference's
SCORE_ATOL = 1e-4
# tokens may differ only after a candidate or logit gap this small (the
# decode tests' near-tie bar)
NEAR_TIE = 1e-4

_BASE = jt.TransformerConfig(
    vocab_size=96, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
)
CONFIGS = {
    "mha": dataclasses.replace(_BASE, use_flash=True),
    "gqa_rope": dataclasses.replace(_BASE, use_flash=True, n_kv_heads=2,
                                    rope=True),
}


def _pair(name, seed=0, int8=False):
    """(reference cfg, reference params, port cfg, port params); ``int8``
    quantizes the weights on the reference side (the port takes the same
    int8 leaves) and turns on the int8 KV cache."""
    jcfg = dataclasses.replace(CONFIGS[name], decode_int8=int8)
    jparams = jt.init_transformer(jax.random.key(seed), jcfg)
    if int8:
        jparams = jt.quantize_decode_params(jparams, jcfg)
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    tparams = pt.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(b, tp, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, tp)).astype(
        np.int32)


# -- the top-k filter ---------------------------------------------------------

def test_top_k_filter_approx_matches_reference():
    """At V 50,304 and k 40 on the CPU the reference's filter gives the
    same logits with its approx_top_k flag on and off, and the port's
    exact filter equals both, keeping logits equal to the k-th."""
    x = np.random.default_rng(0).standard_normal((4, 50304)).astype(
        np.float32)
    # plant ties at each row's 40th largest value
    kth = np.sort(x, axis=-1)[:, -40]
    x[:, :3] = kth[:, None]
    out = pt._top_k_filter(torch.from_numpy(x), 40).numpy()
    for approx in (True, False):
        ref = np.asarray(jt._top_k_filter(jnp.asarray(x), 40, approx))
        np.testing.assert_array_equal(out, ref)
    # the 39 above the threshold, the 40th and its three planted copies
    assert (np.isfinite(ref).sum(axis=-1) == 43).all()


@pytest.mark.parametrize("temperature,top_k", [(0.0, 5), (0.7, 5),
                                               (1.3, None)])
def test_filtered_probs_matches_reference(temperature, top_k):
    x = np.random.default_rng(1).standard_normal((3, 96)).astype(np.float32)
    ref = np.asarray(jt._filtered_probs(jnp.asarray(x), temperature, top_k))
    out = pt._filtered_probs(torch.from_numpy(x), temperature, top_k)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-7, rtol=1e-6)


def test_engine_approx_top_k_flag():
    """``ServingEngine`` takes the reference's ``approx_top_k`` flag and
    samples from the exact threshold either way: its streams equal the
    flag's off streams."""
    cfg = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                               n_layers=1, d_ff=64, max_len=32)
    params = pt.init_params(cfg, seed=2, device="cpu")
    streams = []
    for approx in (False, True):
        eng = ServingEngine(cfg, params, n_slots=2, temperature=1.0,
                            top_k=4, approx_top_k=approx, decode_horizon=2,
                            rng_seed=5, device="cpu")
        reqs = [Request(prompt=np.arange(3 + i), max_new=6)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        res = eng.run()
        streams.append([res[r.id].tolist() for r in reqs])
    assert streams[0] == streams[1]


# -- beam search --------------------------------------------------------------

def _beam_near_tie(jcfg, jparams, prompt, w, max_new, tbeam, tparams):
    """The first step m at which the two searches keep other beams, and the
    smallest gap between adjacent ones of the reference's top W+1
    candidate scores there: its beams after m-1 steps, their log-probs
    from its own decode path (the prompt prefilled, the beam's tokens
    decoded one by one; an int8 cache in int8 mode)."""
    jbeam = jax.jit(jt.transformer_beam_search(jcfg), static_argnums=(2, 3))
    for m in range(1, max_new + 1):
        jt_, _ = jbeam(jparams, jnp.asarray(prompt), w, m)
        tt, _ = tbeam(tparams, torch.from_numpy(prompt), w, m)
        if not np.array_equal(np.asarray(jt_), tt.numpy()):
            break
    else:
        raise AssertionError("no step keeps other beams")
    b, tp = prompt.shape
    if m == 1:
        seqs = prompt[:, None].astype(np.int32)
        scores = np.zeros((b, 1), np.float32)
    else:
        seqs, scores = jbeam(jparams, jnp.asarray(prompt), w, m - 1)
        seqs, scores = np.asarray(seqs), np.asarray(scores)
    nb = seqs.shape[1]
    flat = jnp.asarray(seqs.reshape(b * nb, -1))
    fwd, init, prefill, cast = jt._decode_builder(jcfg)
    p = cast(jparams)
    caches, logits = prefill(p, init(b * nb, tp + max_new), flat[:, :tp])
    for i in range(m - 1):
        logits, caches = fwd(p, caches, flat[:, tp + i], tp + i)
    logp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    cand = (scores[..., None] + logp.reshape(b, nb, -1)).reshape(b, -1)
    top = -np.sort(-cand, axis=-1)[:, :w + 1]
    return m, float(np.min(top[:, :-1] - top[:, 1:]))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_beam_search_matches_reference(name, int8):
    jcfg, jparams, tcfg, tparams = _pair(name, seed=4, int8=int8)
    prompt = _prompt(2, 5, jcfg.vocab_size, seed=6)
    w, max_new = 3, 6
    jtoks, jscores = jax.jit(jt.transformer_beam_search(jcfg),
                             static_argnums=(2, 3))(
        jparams, jnp.asarray(prompt), w, max_new)
    tbeam = pt.transformer_beam_search(tcfg)
    ttoks, tscores = tbeam(tparams, torch.from_numpy(prompt), w, max_new)
    assert ttoks.shape == (2, w, 5 + max_new) and tscores.shape == (2, w)
    assert (torch.diff(tscores, dim=1) <= 0).all()
    np.testing.assert_array_equal(ttoks[:, :, :5].numpy(),
                                  np.broadcast_to(prompt[:, None], (2, w, 5)))
    if np.array_equal(ttoks.numpy(), np.asarray(jtoks)):
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                                   atol=SCORE_ATOL, rtol=0)
    else:
        m, gap = _beam_near_tie(jcfg, jparams, prompt, w, max_new, tbeam,
                                tparams)
        assert gap < NEAR_TIE, (m, gap)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_beam_width_one_is_greedy(int8):
    _, _, tcfg, tparams = _pair("gqa_rope", seed=5, int8=int8)
    prompt = torch.from_numpy(_prompt(2, 6, tcfg.vocab_size, seed=2))
    toks, scores = pt.transformer_beam_search(tcfg)(tparams, prompt, 1, 10)
    greedy, seen = pt.transformer_generate(tcfg)(
        tparams, prompt, 10, temperature=0.0, return_logits=True)
    assert torch.equal(toks[:, 0], greedy)
    # the score is the greedy chain's summed log-probs
    logp = torch.log_softmax(seen, dim=-1).gather(
        -1, greedy[:, 6:].T[..., None])[..., 0].sum(0)
    torch.testing.assert_close(scores[:, 0], logp, atol=1e-5, rtol=0)


# -- speculative decoding -----------------------------------------------------

def _drafts(name, jcfg, jparams):
    """The reference test's two drafts: an unrelated random model, and the
    target's own weights in int8 (cache not int8)."""
    if name == "unrelated":
        return jt.init_transformer(jax.random.key(99), jcfg)
    return jt.quantize_decode_params(jparams, jcfg)


@pytest.mark.parametrize("draft", ["unrelated", "int8_self"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_speculative_greedy_matches_reference(name, draft):
    jcfg, jparams, tcfg, tparams = _pair(name)
    jdraft = _drafts(draft, jcfg, jparams)
    tdraft = pt.params_from_jax(jax.tree.map(np.asarray, jdraft), tcfg,
                                device="cpu")
    prompt = _prompt(1, 8, jcfg.vocab_size, seed=11)
    new = 20
    ref = np.asarray(jax.jit(functools.partial(
        jt.transformer_speculative_generate(jcfg), max_new=new, draft_k=3,
        temperature=0.0))(jparams, jdraft, jnp.asarray(prompt),
                          jax.random.key(2)))
    out, stats = pt.transformer_speculative_generate(tcfg)(
        tparams, tdraft, torch.from_numpy(prompt), new, draft_k=3,
        temperature=0.0, return_stats=True)
    out = out.numpy()
    assert out.shape == (1, 8 + new)
    np.testing.assert_array_equal(out[:, :8], prompt)
    assert sum(n + 1 for n in stats["accepted"]) >= new
    assert stats["rounds"] == len(stats["accepted"])
    diff = np.nonzero(out[0] != ref[0])[0]
    if diff.size:
        first = int(diff[0])
        logits, _ = jt.transformer_apply(jcfg)(jparams,
                                               jnp.asarray(ref[:, :first]))
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (first, top2)


def test_speculative_greedy_logits_are_the_verify_programs():
    """``return_logits`` gives, for each emitted token, the verify logits
    it was taken from: at temperature 0 each token is their argmax, and
    they agree with the serial decode's logits on the same chain."""
    _, _, tcfg, tparams = _pair("gqa_rope", seed=1)
    draft = pt.quantize_decode_params(tparams, tcfg)
    prompt = torch.from_numpy(_prompt(1, 9, tcfg.vocab_size, seed=3))
    out, logits = pt.transformer_speculative_generate(tcfg)(
        tparams, draft, prompt, 13, draft_k=4, temperature=0.0,
        return_logits=True)
    greedy, seen = pt.transformer_generate(tcfg)(
        tparams, prompt, 13, temperature=0.0, return_logits=True)
    assert logits.shape == seen.shape == (13, 1, tcfg.vocab_size)
    assert torch.equal(logits.argmax(-1)[:, 0], out[0, 9:])
    assert torch.equal(out, greedy)
    torch.testing.assert_close(logits, seen, atol=1e-4, rtol=0)


def test_speculative_identical_draft_accepts_everything():
    """Draft == target on the dense path both sides: every round accepts
    all k tokens, so ``new`` tokens take ceil(new / (k+1)) rounds (the
    catch-up chunk keeps the draft cache whole)."""
    cfg = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_len=96, n_kv_heads=2,
                               rope=True, decode_kernel=False)
    params = pt.init_params(cfg, seed=0, device="cpu")
    k, new = 4, 30
    out, stats = pt.transformer_speculative_generate(cfg)(
        params, params, torch.from_numpy(_prompt(1, 8, 64, seed=5)), new,
        draft_k=k, temperature=0.0, return_stats=True)
    assert out.shape == (1, 38)
    assert stats["rounds"] == -(-new // (k + 1))
    assert stats["accepted"][:-1] == [k] * (stats["rounds"] - 1)


def test_speculative_sampled_determinism_and_guards():
    cfg = pt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_len=96)
    params = pt.init_params(cfg, seed=7, device="cpu")
    qdraft = pt.quantize_decode_params(params, cfg)
    sg = functools.partial(pt.transformer_speculative_generate(cfg),
                           max_new=24, draft_k=4, temperature=1.0, top_k=8)
    prompt = torch.from_numpy(_prompt(1, 6, 64, seed=7))
    a, b, c = (sg(params, qdraft, prompt, key=s) for s in (1, 1, 2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (1, 30)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    assert torch.equal(a[:, :6], prompt)
    with pytest.raises(ValueError, match="B=1"):
        sg(params, qdraft, torch.from_numpy(_prompt(2, 6, 64)))
    with pytest.raises(ValueError, match=">= 2 tokens"):
        sg(params, qdraft, prompt[:, :1])


def test_acceptance_round_gives_the_target_distribution():
    """Draft d ~ q, accept iff u q[d] < p[d], else the residual's token:
    the emitted token's marginal is p (Leviathan et al., theorem 1), by
    Monte Carlo through the port's acceptance step (k = 1)."""
    rng = np.random.default_rng(0)
    v, n = 6, 200_000
    p = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
    kd, ku, kc = (threefry.device_keys(k, torch.device("cpu"))
                  for k in threefry.split(0, 3))
    d = threefry.categorical(torch.log(q + 1e-30).expand(n, v).contiguous(),
                             kd).long()
    u = threefry.uniform(ku, (n, 1))
    ps = p.expand(n, 2, v)
    acc, ctok = pt._accept_round(
        ps, q.expand(n, 1, v), d[:, None], u,
        lambda r: threefry.categorical(torch.log(r + 1e-30), kc).long())
    out = torch.where(acc == 1, d, ctok)
    emp = torch.bincount(out, minlength=v).double() / n
    assert (emp - p.double()).abs().sum() < 0.02, (emp, p)
    # an accepted draft is followed by a bonus token drawn from p
    bonus = torch.bincount(ctok[acc == 1], minlength=v).double()
    assert (bonus / bonus.sum() - p.double()).abs().sum() < 0.03
