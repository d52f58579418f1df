"""Generate straight from the training mesh's layout, held against the
reference's GSPMD programs on the CPU (its 8 virtual devices; the port's
mesh over ``["cpu"] * 8``), the reference's own mesh decode test's
geometry (``tests/test_transformer.py:331``: vocab 64, d 32, 4 heads over
2 KV heads, RoPE, 2 layers):

- the int8 tree's layout, leaf by leaf, against the reference's
  ``place_transformer_params`` specs;
- greedy tokens in f32 and int8 weights over a (4, 2) mesh against the
  reference's jitted generate over its placed tree: identical, or the
  first mismatch at a near-tie of the port's logits (top-2 gap below
  ``NEAR_TIE``); int8 against the float weights' tokens at the reference's
  bar (0.5); the int8 KV cache on the layout at the same bar, its logits
  within the f32 sums' order of single-device int8-cache generate's;
- the layout against the port's single-device generate (f32 and bf16
  compute, GQA whole or split, MQA), a sampled stream with a key, an FSDP
  tree and an MoE tree (the reference decodes a placed MoE tree; so does
  the port, experts on their ranks).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

#: f32 programs that sum in other orders: a token flips only where the
#: top two logits are this close
NEAR_TIE = 1e-3
INT8_AGREE = 0.5
PROMPT, NEW = 24, 8

CFG = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                           d_ff=64, max_len=96, n_kv_heads=2, rope=True)


def _prompt(b=4, seed=7):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (b, PROMPT)).astype(np.int32)


def _port(jcfg, jparams):
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    return tcfg, pt.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")


def _held(toks, ref, logits, near_tie=NEAR_TIE):
    """Each row identical to ``ref``, or its first mismatch at a near-tie
    of ``logits`` (max_new, B, V) there."""
    toks, ref = np.asarray(toks), np.asarray(ref)
    for r in range(toks.shape[0]):
        diff = np.nonzero(toks[r, PROMPT:] != ref[r, PROMPT:])[0]
        if diff.size:
            i = int(diff[0])
            top2 = torch.topk(logits[i, r], 2).values
            assert float(top2[0] - top2[1]) < near_tie, (r, i, toks, ref)


@pytest.fixture(scope="module")
def reference(devices):
    """The reference's greedy tokens over its (4, 2) mesh, f32 and int8
    weights, and the float and quantized params."""
    mesh = jmesh.dp_mp_mesh(4, 2)
    params = jt.init_transformer(jax.random.key(0), CFG)
    qparams = jt.quantize_decode_params(params, CFG)
    gen = jax.jit(functools.partial(jt.transformer_generate(CFG),
                                    max_new=NEW, temperature=0.0))
    placed = {"f32": jt.place_transformer_params(mesh, params, CFG),
              "int8": jt.place_transformer_params(mesh, qparams, CFG)}
    toks = {k: np.asarray(gen(p, _prompt(), jax.random.key(1)))
            for k, p in placed.items()}
    return params, qparams, placed, toks


def _port_mesh(dp=4, tp=2):
    return pmesh.dp_mp_mesh(dp, tp, ["cpu"] * (dp * tp))


def test_int8_layout_matches_reference_specs(reference):
    _, qparams, placed, _ = reference
    tcfg, qp = _port(CFG, qparams)
    laid = pt.place_transformer_params(_port_mesh(), qp, tcfg)
    ref = dict(jax.tree_util.tree_flatten_with_path(placed["int8"])[0])
    n = 0
    for path, leaf in pt._leaves(laid):
        jleaf = next(v for k, v in ref.items()
                     if tuple(str(p.key) for p in k) == path)
        spec = tuple(jleaf.sharding.spec)
        assert leaf.spec == spec + (None,) * (leaf.whole().dim() - len(spec)
                                              ), path
        assert torch.equal(leaf.whole(), torch.from_numpy(
            np.array(jleaf, dtype=np.asarray(jleaf).dtype))), path
        n += 1
    assert n == len(ref)
    assert all(s is None for s in laid["blocks"]["wo_scale"].spec)
    assert laid["blocks"]["w1_scale"].spec[-1] == "model"
    assert laid["head_scale"].spec == (None, "model")


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_greedy_on_the_layout_matches_reference(reference, weights):
    params, qparams, _, ref = reference
    tcfg, p = _port(CFG, qparams if weights == "int8" else params)
    laid = pt.place_transformer_params(_port_mesh(), p, tcfg)
    toks, logits = pt.transformer_generate(tcfg)(
        laid, torch.from_numpy(_prompt()).long(), NEW, temperature=0.0,
        return_logits=True)
    _held(toks, ref[weights], logits)


def test_int8_tracks_float_weights_on_the_layout(reference):
    params, qparams, _, ref = reference
    out = {}
    for name, jp in (("f32", params), ("int8", qparams)):
        tcfg, p = _port(CFG, jp)
        laid = pt.place_transformer_params(_port_mesh(), p, tcfg)
        out[name] = pt.transformer_generate(tcfg)(
            laid, torch.from_numpy(_prompt()).long(), NEW,
            temperature=0.0).numpy()
    agree = (out["int8"][:, PROMPT:] == out["f32"][:, PROMPT:]).mean()
    ref_agree = (ref["int8"][:, PROMPT:] == ref["f32"][:, PROMPT:]).mean()
    assert agree >= INT8_AGREE and ref_agree >= INT8_AGREE


CASES = {
    "gqa": CFG,
    "mha-bf16": dataclasses.replace(CFG, n_kv_heads=None,
                                    compute_dtype=jax.numpy.bfloat16),
    "mqa": dataclasses.replace(CFG, n_kv_heads=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 2)])
def test_layout_matches_single_device_generate(name, dp, tp):
    """The layout's programs against the port's single-device generate on
    the same weights: greedy tokens identical (bf16 compute: or a
    near-tie of the single-device logits at 0.1), the prefill logits
    close. A (1, 2) mesh decodes B 4 on one data row; (2, 4) splits the
    2 KV heads of gqa over 4 ranks (wkv whole: each rank its heads'
    expanded KV)."""
    jcfg = CASES[name]
    tcfg, p = _port(jcfg, jt.init_transformer(jax.random.key(3), jcfg))
    if tcfg.n_heads % tp:
        pytest.skip("tp must divide the heads")
    gen = pt.transformer_generate(tcfg)
    prompt = torch.from_numpy(_prompt(4, seed=11)).long()
    ref, ref_logits = gen(p, prompt, NEW, temperature=0.0,
                          return_logits=True)
    laid = pt.place_transformer_params(_port_mesh(dp, tp), p, tcfg)
    toks, logits = gen(laid, prompt, NEW, temperature=0.0,
                       return_logits=True)
    tol = 0.1 if tcfg.compute_dtype == torch.bfloat16 else NEAR_TIE
    for r in range(4):
        diff = (toks[r] != ref[r]).nonzero()
        if len(diff):
            i = int(diff[0]) - PROMPT
            top2 = torch.topk(ref_logits[i, r], 2).values
            assert float(top2[0] - top2[1]) < tol, (name, r, i)
    scale = ref_logits[0].abs().max()
    atol = 2e-2 if tcfg.compute_dtype == torch.bfloat16 else 1e-4
    assert (logits[0] - ref_logits[0]).abs().max() <= atol * scale


def test_sampled_stream_with_a_key():
    tcfg, p = _port(CFG, jt.init_transformer(jax.random.key(0), CFG))
    gen = pt.transformer_generate(tcfg)
    prompt = torch.from_numpy(_prompt()).long()
    laid = pt.place_transformer_params(_port_mesh(), p, tcfg)
    kw = dict(temperature=0.8, top_k=10)
    got = gen(laid, prompt, NEW, key=5, **kw)
    assert torch.equal(got, gen(p, prompt, NEW, key=5, **kw))
    assert not torch.equal(got, gen(laid, prompt, NEW, key=6, **kw))
    with pytest.raises(ValueError, match="needs a key"):
        gen(laid, prompt, NEW, **kw)


def test_fsdp_tree_decodes_as_the_replicated_layout():
    """An FSDP tree is gathered over the data axis at each rank (an exact
    concatenation): the same tokens and logits, bitwise."""
    tcfg, p = _port(CFG, jt.init_transformer(jax.random.key(0), CFG))
    gen = pt.transformer_generate(tcfg)
    prompt = torch.from_numpy(_prompt()).long()
    mesh = _port_mesh()
    outs = [gen(pt.place_transformer_params(mesh, p, tcfg, fsdp=f), prompt,
                NEW, temperature=0.0, return_logits=True)
            for f in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_moe_tree_decodes_with_experts_on_their_ranks(devices):
    """The reference's generate decodes a placed MoE tree (dense routing
    over every expert); the port's runs each rank's experts on its device
    and holds the reference's tokens."""
    mcfg = dataclasses.replace(CFG, n_kv_heads=None, rope=False,
                               n_experts=2)
    jparams = jt.init_transformer(jax.random.key(0), mcfg)
    jgen = jax.jit(functools.partial(jt.transformer_generate(mcfg),
                                     max_new=NEW, temperature=0.0))
    ref = np.asarray(jgen(jt.place_transformer_params(
        jmesh.dp_mp_mesh(4, 2), jparams, mcfg), _prompt(),
        jax.random.key(1)))
    tcfg, p = _port(mcfg, jparams)
    laid = pt.place_transformer_params(_port_mesh(), p, tcfg)
    assert laid["blocks"]["moe"]["w1"].spec[1] == "model"
    gen = pt.transformer_generate(tcfg)
    prompt = torch.from_numpy(_prompt()).long()
    toks, logits = gen(laid, prompt, NEW, temperature=0.0,
                       return_logits=True)
    _held(toks, ref, logits)
    assert torch.equal(toks, gen(p, prompt, NEW, temperature=0.0))


#: how far the layout's logits may lie from single-device generate's: the
#: f32 sums' order (the row-parallel products' partials added in rank
#: order). Measured on this file's weights: 1.1e-6 to 1.5e-6 on the float
#: layouts, 1.7e-6 to 2.0e-6 on the int8-cache layouts, whose kernel #3
#: launches take the row's q and softmax-weight scales from outside
F32_ORDER = 1e-5
#: an int8 cache's scale rows against the single-device cache's: the same
#: amax up to the f32 sums' order (measured 1.1e-8 absolute)
SCALE_RTOL = 1e-6

#: layouts of the int8 KV cache: KV heads split (wkv split over 2 ranks),
#: wkv whole (2 KV heads over 4 ranks: each rank its query heads'
#: expanded KV) and FSDP (the (4, 2) layout split over the data axis too)
INT8_LAYOUTS = {"split wkv": (2, 2, False), "whole wkv": (1, 4, False),
                "fsdp": (4, 2, True)}


def _int8_port(seed=0):
    q = dataclasses.replace(CFG, decode_int8=True)
    tcfg, p = _port(q, jt.quantize_decode_params(
        jt.init_transformer(jax.random.key(seed), q), q))
    return tcfg, p


@pytest.mark.parametrize("layout", sorted(INT8_LAYOUTS))
def test_int8_cache_on_the_layout_matches_single_device(layout):
    """``decode_int8`` over the layout against single-device int8-cache
    generate on the same quantized weights: greedy tokens identical, or
    the first mismatch at a near-tie of the single-device logits (the
    float layout's bar), and the logits, up to each row's first mismatch,
    within the f32 sums' order (:data:`F32_ORDER`)."""
    dp, tp, fsdp = INT8_LAYOUTS[layout]
    tcfg, p = _int8_port()
    gen = pt.transformer_generate(tcfg)
    prompt = torch.from_numpy(_prompt(4, seed=11)).long()
    ref, ref_logits = gen(p, prompt, NEW, temperature=0.0,
                          return_logits=True)
    laid = pt.place_transformer_params(_port_mesh(dp, tp), p, tcfg, fsdp)
    toks, logits = gen(laid, prompt, NEW, temperature=0.0,
                       return_logits=True)
    _held(toks, ref, ref_logits)
    for r in range(toks.shape[0]):
        diff = (toks[r, PROMPT:] != ref[r, PROMPT:]).nonzero()
        end = int(diff[0]) + 1 if len(diff) else NEW
        gap = (logits[:end, r] - ref_logits[:end, r]).abs().max()
        assert gap <= F32_ORDER, (layout, r, float(gap))


def test_int8_cache_on_the_layout_matches_reference(reference):
    """The port's int8-cache generate over its (4, 2) layout against the
    reference's jitted ``decode_int8`` generate over its placed quantized
    tree."""
    q = dataclasses.replace(CFG, decode_int8=True)
    jparams = jt.quantize_decode_params(reference[0], q)
    jgen = jax.jit(functools.partial(jt.transformer_generate(q),
                                     max_new=NEW, temperature=0.0))
    ref = np.asarray(jgen(jt.place_transformer_params(
        jmesh.dp_mp_mesh(4, 2), jparams, q), _prompt(), jax.random.key(1)))
    tcfg, p = _port(q, jparams)
    laid = pt.place_transformer_params(_port_mesh(), p, tcfg)
    toks, logits = pt.transformer_generate(tcfg)(
        laid, torch.from_numpy(_prompt()).long(), NEW, temperature=0.0,
        return_logits=True)
    _held(toks, ref, logits)


@pytest.mark.parametrize("layout", ["split wkv", "whole wkv", "fsdp"])
def test_every_ranks_scale_row_is_the_whole_rows(layout):
    """After a prefill and one decode step on the layout, every rank of a
    row holds the same scale plane, bitwise: one scale over the row's
    whole Hkv*K, the max of the ranks' amaxes, so each written row's
    largest |int8| over the ranks is 127 (a rank's own amax would give
    127 on every rank). The prompt's rows, and layer 0's decode row, are
    the single-device cache's: scales up to the f32 sums' order, int8
    rows equal (a rank's KV heads, or its query heads' expanded KV)."""
    dp, tp, fsdp = INT8_LAYOUTS[layout]
    tcfg, p = _int8_port(seed=0)
    prompt = torch.from_numpy(_prompt(4, seed=3)).long()
    fwd, init, prefill, cast = pt._decode_builder(tcfg)
    params = cast(p)
    total = PROMPT + 2
    caches, logits = prefill(params, init(4, total, "cpu"), prompt)
    _, caches = fwd(params, caches, logits.argmax(-1), PROMPT)
    md = pt._MeshDecode(tcfg, pt.place_transformer_params(
        _port_mesh(dp, tp), p, tcfg, fsdp))
    sizes = [len(r) for r in torch.tensor_split(torch.arange(4), dp)]
    rows = torch.split(prompt, sizes)
    mine = md.init_caches(sizes, total)
    kd, grp = tcfg.head_dim, tcfg.n_heads // tcfg.kv_heads
    b0 = 0
    for d in range(dp):
        lg = md.prefill(d, mine[d], rows[d])
        md.step(d, mine[d], lg.argmax(-1), pos=PROMPT)
        # the prompt's rows of every layer, then layer 0's decode row
        picks = [(slice(None), slice(0, PROMPT)), (slice(0, 1), PROMPT)]
        want = [(caches["kv"][li, :, b0:b0 + sizes[d], ti],
                 caches["scale"][li, :, b0:b0 + sizes[d], ti])
                for li, ti in picks]
        top = torch.stack([mine[d]["kv"][m][:, :, :, :PROMPT + 1].abs()
                           .amax(-1) for m in range(tp)]).amax(0)
        assert (top == 127).all(), (layout, d)
        for m in range(tp):
            assert torch.equal(mine[d]["scale"][m][:, :, :, :PROMPT + 1],
                               mine[d]["scale"][0][:, :, :, :PROMPT + 1]), (
                layout, d, m)
            for (li, ti), (want_kv, want_sc) in zip(picks, want):
                torch.testing.assert_close(mine[d]["scale"][m][li, :, :, ti],
                                           want_sc, rtol=SCALE_RTOL, atol=0)
                got = mine[d]["kv"][m][li, :, :, ti]
                if md.kv_split:
                    w = want_kv[..., m * md.kv_r * kd:(m + 1) * md.kv_r * kd]
                else:
                    heads = want_kv.unflatten(-1, (tcfg.kv_heads, kd))
                    w = heads.repeat_interleave(grp, dim=-2)[
                        ..., m * md.hs:(m + 1) * md.hs, :].flatten(-2)
                assert torch.equal(got, w), (layout, d, m, li)
        b0 += sizes[d]
