"""MoE configs (``n_experts > 0``) through the port's decode and serving
paths, held against the reference on the CPU: params from the reference
(``MoEParams`` leaves) through ``params_from_jax``, greedy generate, beam
and speculative decoding, the serving engine's features, the npz
checkpoint both ways and the CLI.

The decode programs run ``moe_reference`` (gelu) over every expert; the
reference's do the same per token.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.parallel import checkpoint as jckpt
from deeplearning4j_tpu.parallel.expert_parallel import MoEParams
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
from deeplearning4j_tpu_torch.serving import Request, ServingEngine

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this (f32 logits agree to ~1e-5 here)
NEAR_TIE = 1e-4
# f32 logits and beam scores across the frameworks
LOGIT_ATOL = 1e-4

JCFG = jt.TransformerConfig(
    vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=192,
    use_flash=True, n_experts=4,
)
CFG = pt.TransformerConfig.from_json(JCFG.to_json())
# below the 8 bucket, mid buckets, and past the largest (128) bucket so
# admission takes the chunked path
LENGTHS = [(3, 6), (9, 8), (17, 5), (40, 7), (130, 6), (150, 9)]


@pytest.fixture(scope="module")
def jparams():
    return jt.init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return pt.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                              device="cpu")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32), m)
            for n, m in LENGTHS]


@pytest.fixture(scope="module")
def generated(params):
    gen = pt.transformer_generate(CFG)
    out = []
    for prompt, max_new in _prompts():
        toks, logits = gen(params, torch.from_numpy(prompt[None]).long(),
                           max_new, temperature=0.0, return_logits=True)
        out.append((toks[0].numpy(), logits[:, 0].numpy()))
    return out


def test_moe_params_carry_over_from_the_reference(jparams, params):
    """``jax.tree.map(np.asarray, ...)`` keeps the reference's MoEParams
    NamedTuple; the port reads its fields by name into ``blocks["moe"]``,
    with the shapes ``param_shapes`` gives and the reference's scales."""
    moe = jax.tree.map(np.asarray, jparams)["blocks"]["moe"]
    assert isinstance(moe, MoEParams)
    shapes = pt.param_shapes(CFG)["blocks"]["moe"]
    assert set(params["blocks"]) >= {"moe"}
    assert not {"w1", "b1", "w2", "b2"} & set(params["blocks"])
    for f in MoEParams._fields:
        np.testing.assert_array_equal(params["blocks"]["moe"][f].numpy(),
                                      getattr(moe, f))
        assert tuple(params["blocks"]["moe"][f].shape) == shapes[f]
    init = pt.init_params(CFG, seed=1, device="cpu")["blocks"]["moe"]
    assert float(init["b1"].abs().max()) == float(init["b2"].abs().max()) == 0
    for f, fan_in in (("wg", 32), ("w1", 32), ("w2", 64)):
        assert abs(float(init[f].std()) * fan_in ** 0.5 - 1) < 0.1, f
    # a dict of the fields is taken as well
    as_dict = jax.tree.map(np.asarray, jparams)
    as_dict["blocks"] = dict(as_dict["blocks"])
    as_dict["blocks"]["moe"] = moe._asdict()
    again = pt.params_from_jax(as_dict, CFG, device="cpu")
    assert torch.equal(again["blocks"]["moe"]["w2"],
                       params["blocks"]["moe"]["w2"])


def test_moe_refusals_keep_the_references_wording(params):
    with pytest.raises(NotImplementedError, match="MoE experts"):
        pt.quantize_decode_params(params, CFG)
    with pytest.raises(ValueError, match="MoE"):
        pt.init_lora_bank(0, CFG, 2, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE experts"):
        jt.quantize_decode_params(jt.init_transformer(jax.random.key(0),
                                                      JCFG), JCFG)


def test_generate_greedy_matches_reference(jparams, generated):
    jgen = jax.jit(functools.partial(jt.transformer_generate(JCFG),
                                     temperature=0.0),
                   static_argnums=(3,))
    for (prompt, max_new), (toks, logits) in zip(_prompts(), generated):
        ref = np.asarray(jgen(jparams, jnp.asarray(prompt[None]),
                              jax.random.key(0), max_new))[0]
        diff = np.nonzero(ref != toks)[0]
        if diff.size:
            top2 = np.sort(logits[int(diff[0]) - len(prompt)])[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (len(prompt), top2)


def test_prefill_logits_match_reference_apply(jparams, params):
    """The decode builder's prefill (dense MoE over every expert) against
    the reference's f32 ``transformer_apply`` on a mesh-free config: the
    reference's MoE apply needs a mesh, so its decode prefill stands in."""
    prompt = _prompts()[3][0][None]
    fwd, init, prefill, cast = pt._decode_builder(CFG)
    _, lg = prefill(cast(params), init(1, 48, "cpu"),
                    torch.from_numpy(prompt).long())
    jfwd, jinit, jprefill, jcast = jt._decode_builder(JCFG)
    _, jlg = jprefill(jcast(jparams), jinit(1, 48), jnp.asarray(prompt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_ATOL,
                               rtol=0)


def test_beam_search_matches_reference(jparams, params):
    prompt = np.random.default_rng(6).integers(0, 64, (2, 5)).astype(
        np.int32)
    jtoks, jscores = jax.jit(jt.transformer_beam_search(JCFG),
                             static_argnums=(2, 3))(
        jparams, jnp.asarray(prompt), 3, 6)
    toks, scores = pt.transformer_beam_search(CFG)(
        params, torch.from_numpy(prompt), 3, 6)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=LOGIT_ATOL, rtol=0)


def test_speculative_greedy_is_generates_chain(params, generated):
    """The MoE target as its own f32 draft: every draft token is accepted
    and the chain is greedy generate's, near-ties aside."""
    prompt, max_new = _prompts()[3]
    out, stats = pt.transformer_speculative_generate(CFG)(
        params, params, torch.from_numpy(prompt[None]).long(), max_new,
        draft_k=3, temperature=0.0, return_stats=True)
    toks, logits = generated[3]
    diff = np.nonzero(out[0].numpy() != toks)[0]
    if diff.size:
        top2 = np.sort(logits[int(diff[0]) - len(prompt)])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE
    assert stats["rounds"] == len(stats["accepted"])


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return engine.run()


@pytest.mark.parametrize("kw", [
    dict(decode_horizon=1), dict(decode_horizon=4),
    dict(paged=True), dict(prefix_cache=True), dict(piggyback=True),
], ids=["k1", "k4", "paged", "prefix", "piggyback"])
def test_engine_matches_port_generate(params, generated, kw):
    engine = ServingEngine(CFG, params, n_slots=3, device="cpu",
                           temperature=0.0, **kw)
    assert engine._paged == bool(kw.get("paged"))
    reqs = [Request(prompt=p, max_new=m) for p, m in _prompts()]
    res = _run(engine, reqs)
    for r, (ref, _) in zip(reqs, generated):
        np.testing.assert_array_equal(res[r.id], ref)


def _verdicts(cfg, params):
    engine = ServingEngine(cfg, params, n_slots=4, device="cpu",
                           temperature=0.0, prefix_cache=True)
    return {"prefix_reuse": engine._prefix_reuse_ok(),
            "chunked_replay": engine._use_chunked_replay(),
            "disagg_wire": engine._disagg_ok(),
            "batch_admission": engine._batch_admission_ok("miss", 8, 4)}


def test_engine_probes_pass_for_moe(params):
    """Every parity probe of the dense model gives the MoE model the
    dense model's verdict (dense decode makes each row's value its own):
    the prefix, wire and batching probes pass; the chunked-replay probe (a
    chunk against decode steps, not bitwise on this CPU) declines for
    both."""
    dense = dataclasses.replace(CFG, n_experts=0)
    moe_v = _verdicts(CFG, params)
    assert moe_v == _verdicts(dense, pt.init_params(dense, seed=0,
                                                    device="cpu"))
    assert moe_v["prefix_reuse"] and moe_v["disagg_wire"]
    assert moe_v["batch_admission"]
    # and batched admission serves the rows of serial admission
    engine = ServingEngine(CFG, params, n_slots=4, device="cpu",
                           temperature=0.0, batch_admission=True)
    reqs = [Request(prompt=np.arange(1, 6 + i) % 64, max_new=5)
            for i in range(4)]
    batched = _run(engine, reqs)
    assert engine.prefill_dispatches < len(reqs)
    serial = ServingEngine(CFG, params, n_slots=4, device="cpu",
                           temperature=0.0, batch_admission=False)
    sreqs = [Request(prompt=r.prompt, max_new=5) for r in reqs]
    sres = _run(serial, sreqs)
    for a, b in zip(reqs, sreqs):
        np.testing.assert_array_equal(batched[a.id], sres[b.id])


def test_tp_serving_falls_back_for_moe(params, generated):
    """Exact TP refuses MoE configs (the reference's wording); the engine
    serves at tp 1 instead."""
    with pytest.raises(ValueError, match="MoE"):
        pt.serving_tp_shardings(pt.Mesh(["cpu"] * 2), CFG)
    engine = ServingEngine(CFG, params, n_slots=3, device="cpu",
                           temperature=0.0, tp=2, tp_devices=["cpu"] * 2)
    assert engine.tp == 1
    reqs = [Request(prompt=p, max_new=m) for p, m in _prompts()[:3]]
    res = _run(engine, reqs)
    for r, (ref, _) in zip(reqs, generated):
        np.testing.assert_array_equal(res[r.id], ref)


def test_checkpoint_moe_keys_both_ways(tmp_path, jparams, params):
    """``blocks//moe//.wg`` and its siblings, the keys the reference's
    NamedTuple flattens to: each package restores the other's file."""
    keys = dict(ckpt.flat_leaves(params))
    assert {f"blocks//moe//.{f}" for f in MoEParams._fields} <= set(keys)
    ckpt.save(tmp_path / "port.npz", params, {"step": 1})
    back, meta = jckpt.restore(tmp_path / "port.npz", jparams)
    assert meta["step"] == 1
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.save(tmp_path / "ref.npz", jparams, {"step": 2})
    mine, _ = ckpt.restore(tmp_path / "ref.npz", pt.param_shapes(CFG),
                           device="cpu")
    for f in MoEParams._fields:
        assert torch.equal(mine["blocks"]["moe"][f],
                           params["blocks"]["moe"][f])


def test_cli_serves_and_refuses_int8_for_moe(capsys):
    model = ["--d-model", "32", "--n-layers", "1", "--n-heads", "2",
             "--seq-len", "32", "--n-experts", "2", "--device", "cpu"]
    assert cli.main(["serve", "--demo", "--int8", "weights", "--port", "0",
                     *model]) == 2
    assert "--int8 does not cover MoE experts" in capsys.readouterr().err
    cfg = cli._cfg_from_args(cli.build_parser().parse_args(
        ["serve", "--demo", *model]))
    assert cfg.n_experts == 2
    engine = ServingEngine(cfg, pt.init_params(cfg, seed=0, device="cpu"),
                           n_slots=2, device="cpu", temperature=0.0)
    req = Request(prompt=np.arange(5), max_new=4)
    assert _run(engine, [req])[req.id].shape == (9,)


def test_moe_bf16_decode_runs_generate_and_engine(params):
    """bf16 compute (the card's serving dtype): the engine's streams equal
    generate's."""
    cfg = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
    gen = pt.transformer_generate(cfg)
    prompts = _prompts()[:4]
    refs = [gen(params, torch.from_numpy(p[None]).long(), m,
                temperature=0.0)[0].numpy() for p, m in prompts]
    engine = ServingEngine(cfg, params, n_slots=3, device="cpu",
                           temperature=0.0)
    reqs = [Request(prompt=p, max_new=m) for p, m in prompts]
    res = _run(engine, reqs)
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(res[r.id], ref)
