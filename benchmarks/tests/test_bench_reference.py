"""The plain reference against the program on the CPU at a small size, in
float32, on weights made by the harness.

Tolerances: both sides compute the same float32 arithmetic in a different
order (PyTorch's fused layer norm and SDPA-free attention here, the
program's own ops there), which moves a logit by ~1e-6 of its size; a
relative 1e-4 leaves two orders of room and still fails any wrong term
(a dropped bias or scale moves the logits by ~1e-2)."""

import pytest
import torch

from benchmarks.harness import weights
from benchmarks.reference import gpt2_plain

torch.set_num_threads(2)

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=128,
           max_len=64)
OPT = {"peak_lr": 1e-3, "warmup_steps": 1, "total_steps": 10,
       "clip_norm": 1.0, "weight_decay": 0.01}


def _setup():
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, param_shapes)

    cfg = TransformerConfig(**CFG, compute_dtype=torch.float32)
    params = weights.make_params(param_shapes(cfg), 1234567890123, 32, 128,
                                 torch.device("cpu"))
    return cfg, params


def _tokens(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG["vocab_size"], shape, generator=g)


def test_forward_matches_the_program():
    from deeplearning4j_tpu_torch.models.transformer import transformer_apply

    cfg, params = _setup()
    tok = _tokens(0, (3, 40))
    ours, _ = transformer_apply(cfg)(params, tok)
    ref = gpt2_plain.forward(params, tok, CFG["n_heads"])
    scale = ref.abs().max()
    assert (ours - ref).abs().max() <= 1e-4 * scale


def test_a_dropped_bias_fails_the_forward_tolerance():
    from deeplearning4j_tpu_torch.models.transformer import transformer_apply

    cfg, params = _setup()
    tok = _tokens(0, (3, 40))
    ours, _ = transformer_apply(cfg)(params, tok)
    params["blocks"]["b2"] = torch.zeros_like(params["blocks"]["b2"])
    ref = gpt2_plain.forward(params, tok, CFG["n_heads"])
    assert (ours - ref).abs().max() > 1e-4 * ref.abs().max()


def test_served_gaps_are_zero_for_the_references_own_greedy_tokens():
    _, params = _setup()
    prompt = _tokens(1, (20,))
    seq = prompt.clone()
    for _ in range(6):
        nxt = gpt2_plain.logits(params, seq, CFG["n_heads"])[-1].argmax()
        seq = torch.cat([seq, nxt[None]])
    gaps, ctl = gpt2_plain.served_gaps(params, prompt, seq[20:],
                                       CFG["n_heads"], "fp8")
    assert float(gaps.max()) == 0.0
    assert ctl is not None and ctl.shape == gaps.shape


def test_loss_and_gradients_match_the_program():
    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_loss, value_and_grad)

    cfg, params = _setup()
    tok = _tokens(2, (4, 33))
    loss, grads = value_and_grad(transformer_loss(cfg), params, tok)
    ref_loss, ref_grads = gpt2_plain.loss_and_grads(params, tok,
                                                    CFG["n_heads"], rows=3)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    ours = dict(gpt2_plain.leaves(grads))
    for name, g in ref_grads.items():
        assert (ours[name] - g).norm() <= 1e-4 * g.norm() + 1e-9, name


def test_three_adamw_steps_match_the_program():
    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer, transformer_train_step)

    cfg, params = _setup()
    batches = [_tokens(10 + i, (4, 33)) for i in range(3)]
    losses, first, change = gpt2_plain.train_steps(params, batches,
                                                   CFG["n_heads"], OPT)
    opt = lm_optimizer(peak_lr=OPT["peak_lr"], total_steps=OPT["total_steps"],
                       warmup_steps=OPT["warmup_steps"],
                       clip_norm=OPT["clip_norm"],
                       weight_decay=OPT["weight_decay"])
    step, _, _ = transformer_train_step(None, cfg, optimizer=opt,
                                        device="cpu")
    p = {k: ({kk: vv.clone() for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone())
         for k, v in params.items()}
    state = opt.init(p)
    ours = []
    for i, tok in enumerate(batches):
        p, state, loss = step(p, state, tok)
        ours.append(float(loss))
        if i == 0:
            g1 = {n: float(m.norm()) / 0.1
                  for n, m in gpt2_plain.leaves(state["mu"])}
    assert ours == pytest.approx(losses, rel=1e-5)
    for name, v in first.items():
        assert g1[name] == pytest.approx(v, rel=1e-4, abs=1e-9), name
    for name, x in gpt2_plain.leaves(p):
        x0 = dict(gpt2_plain.leaves(params))[name]
        assert float((x.detach() - x0).norm()) == pytest.approx(change[name],
                                                       rel=1e-4), name


def test_fp8_rounding_keeps_values_within_e4m3s_step():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    y = gpt2_plain._fp8(x)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3)).max()
    assert 0 < rel <= 2 ** -3  # e4m3 keeps 3 mantissa bits
