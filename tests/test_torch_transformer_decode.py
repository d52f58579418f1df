"""The port's KV-cached decode held against the reference
``_decode_builder`` / ``_chunk_builder`` / ``transformer_generate`` at f32,
with the reference's params carried over by ``params_from_jax``.

The reference's Pallas kernels run in interpret mode (its own CPU default);
the port's run their plain versions (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu_torch.models import transformer as pt

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# f32 logits: the frameworks' matmuls sum in different orders
LOGIT_ATOL = 1e-4
# greedy tokens must agree unless the reference's top-2 gap is this small
NEAR_TIE = 1e-4

_BASE = jt.TransformerConfig(
    vocab_size=96, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
)
CONFIGS = {
    "mha_flash": dataclasses.replace(_BASE, use_flash=True),
    "mha_dense": _BASE,
    "gqa_rope_flash": dataclasses.replace(
        _BASE, use_flash=True, n_kv_heads=2, rope=True),
}


def _pair(name, seed=0):
    jcfg = CONFIGS[name]
    jparams = jt.init_transformer(jax.random.key(seed), jcfg)
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    tparams = pt.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_decode(jcfg):
    """The reference's decode functions, jitted (its interpret-mode Pallas
    kernels run far faster traced once than op by op)."""
    fwd, init, prefill, cast = jt._decode_builder(jcfg)
    return jax.jit(fwd), init, jax.jit(prefill), cast


def _prompt(b, tp, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, tp)).astype(
        np.int32)


def test_config_json_roundtrip():
    jcfg = dataclasses.replace(CONFIGS["gqa_rope_flash"],
                               compute_dtype=jnp.bfloat16)
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    assert tcfg.compute_dtype == torch.bfloat16
    assert tcfg.kv_heads == 2 and tcfg.rope and tcfg.use_flash
    assert jt.TransformerConfig.from_json(tcfg.to_json()) == jcfg
    # unknown keys are ignored, as the reference's from_json does
    d = dict(**__import__("json").loads(jcfg.to_json()), future_knob=3)
    assert pt.TransformerConfig.from_json(__import__("json").dumps(d)) == tcfg


def test_unsupported_configs_name_the_later_slice():
    """MoE configs decode now (dense over every expert); what stays
    refused is what the reference refuses, in its words: int8 weights for
    the experts."""
    cfg = pt.TransformerConfig(n_experts=2)
    pt._decode_builder(cfg)
    params = pt.init_params(cfg, seed=0, device="cpu")
    assert set(params["blocks"]["moe"]) == {"wg", "w1", "b1", "w2", "b2"}
    with pytest.raises(NotImplementedError, match="MoE experts"):
        pt.quantize_decode_params(params, cfg)


def test_cast_params_keeps_embeddings_f32():
    cfg = dataclasses.replace(pt.TransformerConfig(),
                              compute_dtype=torch.bfloat16)
    params = pt.init_params(cfg, seed=0, device="cpu")
    cast = pt._decode_builder(cfg)[3](params)
    assert cast["embed"].dtype == cast["pos"].dtype == torch.float32
    assert cast["head"].dtype == torch.bfloat16
    assert all(a.dtype == torch.bfloat16 for a in cast["blocks"].values())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_and_cache_rows(name):
    jcfg, jparams, tcfg, tparams = _pair(name)
    prompt = _prompt(2, 16, jcfg.vocab_size)
    _, jinit, jprefill, jcast = _jax_decode(jcfg)
    jcache, jlogits = jprefill(jcast(jparams), jinit(2, 24),
                              jnp.asarray(prompt))
    _, tinit, tprefill, tcast = pt._decode_builder(tcfg)
    tcache, tlogits = tprefill(tcast(tparams), tinit(2, 24, "cpu"),
                              torch.from_numpy(prompt))
    assert tcache.shape == jcache.shape
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               atol=LOGIT_ATOL, rtol=0)
    # per-row last index (right-padded prompts of different true lengths)
    last = np.array([5, 15], np.int32)
    _, jl = jprefill(jcast(jparams), jinit(2, 24), jnp.asarray(prompt),
                     jnp.asarray(last))
    _, tl = tprefill(tcast(tparams), tinit(2, 24, "cpu"),
                     torch.from_numpy(prompt), torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_one_steps(name):
    """Several decode steps at a scalar position, then one at per-row
    positions, through the decode kernel's plain version."""
    jcfg, jparams, tcfg, tparams = _pair(name)
    prompt = _prompt(2, 8, jcfg.vocab_size)
    jfwd, jinit, jprefill, jcast = _jax_decode(jcfg)
    tfwd, tinit, tprefill, tcast = pt._decode_builder(tcfg)
    jp, tp_ = jcast(jparams), tcast(tparams)
    jcache, _ = jprefill(jp, jinit(2, 16), jnp.asarray(prompt))
    tcache, _ = tprefill(tp_, tinit(2, 16, "cpu"), torch.from_numpy(prompt))
    toks = _prompt(2, 4, jcfg.vocab_size, seed=5)
    for i in range(4):
        jl, jcache = jfwd(jp, jcache, jnp.asarray(toks[:, i]), 8 + i)
        tl, tcache = tfwd(tp_, tcache, torch.from_numpy(toks[:, i]), 8 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
    pos = np.array([12, 3], np.int32)
    jl, jcache = jfwd(jp, jcache, jnp.asarray(toks[:, 0]), jnp.asarray(pos))
    tl, tcache = tfwd(tp_, tcache, torch.from_numpy(toks[:, 0]),
                      torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               atol=LOGIT_ATOL, rtol=0)


def test_forward_one_dense_path():
    """decode_kernel=False: the dense chunk block at C=1."""
    jcfg = dataclasses.replace(CONFIGS["gqa_rope_flash"],
                               decode_kernel=False)
    jparams = jt.init_transformer(jax.random.key(2), jcfg)
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    tparams = pt.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    assert not tcfg.decode_kernel
    prompt = _prompt(2, 8, jcfg.vocab_size)
    jfwd, jinit, jprefill, jcast = _jax_decode(jcfg)
    tfwd, tinit, tprefill, tcast = pt._decode_builder(tcfg)
    jp, tp_ = jcast(jparams), tcast(tparams)
    jcache, _ = jprefill(jp, jinit(2, 16), jnp.asarray(prompt))
    tcache, _ = tprefill(tp_, tinit(2, 16, "cpu"), torch.from_numpy(prompt))
    pos = np.array([8, 5], np.int32)
    tok = np.array([3, 7], np.int32)
    jl, _ = jfwd(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = tfwd(tp_, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["mha_dense", "gqa_rope_flash"])
def test_forward_chunk(name):
    jcfg, jparams, tcfg, tparams = _pair(name)
    prompt = _prompt(2, 8, jcfg.vocab_size)
    _, jinit, jprefill, jcast = _jax_decode(jcfg)
    _, tinit, tprefill, tcast = pt._decode_builder(tcfg)
    jp, tp_ = jcast(jparams), tcast(tparams)
    jcache, _ = jprefill(jp, jinit(2, 24), jnp.asarray(prompt))
    tcache, _ = tprefill(tp_, tinit(2, 24, "cpu"), torch.from_numpy(prompt))
    chunk = _prompt(2, 8, jcfg.vocab_size, seed=9)
    jchunk = jax.jit(jt._chunk_builder(jcfg), static_argnames="last_idx")
    tchunk = pt._chunk_builder(tcfg)
    jl, jcache = jchunk(jp, jcache, jnp.asarray(chunk), 8)
    tl, tcache = tchunk(tp_, tcache, torch.from_numpy(chunk), 8)
    assert tl.shape == (2, 8, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    jl1, _ = jchunk(jp, jcache, jnp.asarray(chunk[:, :4]), 16, last_idx=2)
    tl1, _ = tchunk(tp_, tcache, torch.from_numpy(chunk[:, :4]), 16,
                    last_idx=2)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["mha_flash", "gqa_rope_flash"])
def test_greedy_generate_tokens(name):
    jcfg, jparams, tcfg, tparams = _pair(name, seed=3)
    prompt = _prompt(2, 8, jcfg.vocab_size, seed=4)
    max_new = 12
    ref = np.asarray(jt.transformer_generate(jcfg)(
        jparams, jnp.asarray(prompt), jax.random.key(0), max_new=max_new,
        temperature=0.0))
    out, seen = pt.transformer_generate(tcfg)(
        tparams, torch.from_numpy(prompt), max_new, temperature=0.0,
        return_logits=True)
    out = out.numpy()
    np.testing.assert_array_equal(out[:, :8], prompt)
    for row in range(2):
        diff = np.nonzero(out[row, 8:] != ref[row, 8:])[0]
        if diff.size:
            # only a near-tie in the reference's logits may flip a token;
            # the streams diverge from there on
            i = int(diff[0])
            top2 = np.sort(seen[i, row].numpy())[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (row, i, top2)


def test_sampled_generate_follows_its_generator():
    """Sampled decoding draws only from its explicit threefry key: equal
    keys give equal streams, and every token stays inside the top-k
    filter."""
    cfg = pt.TransformerConfig(vocab_size=32, d_model=32, n_heads=2,
                               n_layers=1, d_ff=64, max_len=32)
    params = pt.init_params(cfg, seed=1, device="cpu")
    gen = pt.transformer_generate(cfg)
    prompt = torch.arange(4)[None]
    outs = [gen(params, prompt, 10, temperature=1.0, top_k=4,
                key=s,
                return_logits=True) for s in (7, 7, 8)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[2][0])
    toks, logits = outs[0]
    top4 = torch.topk(logits[:, 0], 4).indices
    assert (top4 == toks[0, 4:, None]).any(dim=1).all()
