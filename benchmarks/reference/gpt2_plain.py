"""A plain GPT-2 in float32 PyTorch: the benchmark's reference.

It imports nothing of the program under test. It reads a parameter tree by
the key names below, which the configuration files describe under
``departures``:

    embed (V, d)          token embedding
    pos (n_positions, d)  learned positions
    blocks: stacked over the L layers
        ln1_scale, ln1_bias, ln2_scale, ln2_bias (L, d)
        wqkv (L, d, 3, H, K)     q, k and v projections, no bias
        wo (L, H, K, d)          attention output projection, no bias
        w1 (L, d, F), b1 (L, F)  MLP in, tanh-GELU
        w2 (L, F, d), b2 (L, d)  MLP out
    lnf_scale, lnf_bias (d,)
    head (d, V)           untied output head, no bias

Every product runs in float32 with TF32 off (:func:`tf32_off`), unless
``prec="fp8"`` asks for the control: both operands of every matrix product
rounded to float8 e4m3 with a per-tensor scale (as an fp8 GEMM takes them)
and the product summed in float32.

Serving is judged by :func:`logits` (the full causal forward over a prompt
and its served tokens, layer by layer); training by :func:`train_steps`
(the loss, its gradient in blocks of rows, global-norm clipping and AdamW).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def tf32_off() -> None:
    """Float32 products in float32 on a card: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp8 rounding in the forward, the identity's gradient in the
    backward (the straight-through estimator an fp8 step takes)."""
    return x + (_fp8(x) - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` in float32, or with both operands rounded to fp8 first."""
    a, b = a.float(), b.float()
    if prec == "fp8":
        a, b = _round_fp8(a), _round_fp8(b)
    elif prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return a @ b


def _ln(x, scale, bias):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(), 1e-5)


def block(x: torch.Tensor, p: dict, n_heads: int, prec: str) -> torch.Tensor:
    """One pre-norm GPT-2 block over x (B, T, d), causal."""
    b, t, d = x.shape
    k = d // n_heads
    h = _ln(x, p["ln1_scale"], p["ln1_bias"])
    qkv = mm(h, p["wqkv"].reshape(d, 3 * d), prec).view(b, t, 3, n_heads, k)
    q, kk, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    s = mm(q, kk.transpose(-1, -2), prec) / math.sqrt(k)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v, prec)
    o = o.transpose(1, 2).reshape(b, t, d)
    x = x + mm(o, p["wo"].reshape(d, d), prec)
    h = _ln(x, p["ln2_scale"], p["ln2_bias"])
    h = F.gelu(mm(h, p["w1"], prec) + p["b1"].float(), approximate="tanh")
    return x + mm(h, p["w2"], prec) + p["b2"].float()


def forward(params: dict, tokens: torch.Tensor, n_heads: int,
            prec: str = "f32") -> torch.Tensor:
    """Logits (B, T, V) in float32 of tokens (B, T)."""
    t = tokens.shape[1]
    x = params["embed"][tokens].float() + params["pos"][:t].float()
    names = list(params["blocks"])
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # once instead of writing each layer into a zero leaf
    for lp in zip(*(params["blocks"][n].unbind(0) for n in names)):
        x = block(x, dict(zip(names, lp)), n_heads, prec)
    x = _ln(x, params["lnf_scale"], params["lnf_bias"])
    return mm(x, params["head"], prec)


@torch.no_grad()
def logits(params: dict, seq: torch.Tensor, n_heads: int,
           prec: str = "f32") -> torch.Tensor:
    """Logits (T, V) of one sequence, no graph kept."""
    return forward(params, seq[None], n_heads, prec)[0]


def served_gaps(params: dict, prompt: torch.Tensor, served: torch.Tensor,
                n_heads: int, prec: str = "f32") -> tuple[torch.Tensor, ...]:
    """For a prompt and the tokens served after it: the f32 reference's gap
    at every served position between its best logit and the served
    token's, and, with ``prec`` other than f32, the gap of the token that
    precision puts first (the control's reading). Returns (served gaps,
    control gaps or None)."""
    seq = torch.cat([prompt, served[:-1]])
    ref = logits(params, seq, n_heads, "f32")[len(prompt) - 1:]
    best = ref.max(dim=-1).values
    gaps = best - ref.gather(1, served[:, None].long())[:, 0]
    ctl = None
    if prec != "f32":
        low = logits(params, seq, n_heads, prec)[len(prompt) - 1:]
        ctl = best - ref.gather(1, low.argmax(dim=-1, keepdim=True))[:, 0]
    return gaps, ctl


# -- training -----------------------------------------------------------------

_NO_DECAY = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "lnf_scale",
             "lnf_bias", "b1", "b2", "pos")


def leaves(tree: dict, prefix: str = ""):
    """(dotted name, tensor) pairs of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def lr_at(count: int, opt: dict) -> float:
    """Linear warm-up from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine to a tenth of it at ``total_steps``, read before update
    ``count``."""
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if count < warm:
        return peak * count / warm
    c = min(count - warm, total - warm)
    cosine = 0.5 * (1 + math.cos(math.pi * c / (total - warm)))
    return peak * (0.1 + 0.9 * cosine)


def loss_and_grads(params: dict, tokens: torch.Tensor, n_heads: int,
                   prec: str = "f32", rows: int = 1):
    """Mean next-token cross-entropy of tokens (B, T+1) and its gradient by
    leaf name, summed over blocks of ``rows`` rows so it fits."""
    named = dict(leaves(params))
    flat = {n: p.detach().float().requires_grad_(True)
            for n, p in named.items()}
    tree = _tree(flat)
    grads = {n: torch.zeros_like(p) for n, p in flat.items()}
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    n_all = tokens.shape[0] * (tokens.shape[1] - 1)
    for r0 in range(0, tokens.shape[0], rows):
        blk = tokens[r0:r0 + rows]
        lg = forward(tree, blk[:, :-1], n_heads, prec)
        ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                             blk[:, 1:].reshape(-1).long(), reduction="sum")
        gs = torch.autograd.grad(ce / n_all, list(flat.values()))
        for (n, _), g in zip(flat.items(), gs):
            grads[n] += g
        total += ce.detach().double()
        del lg, ce, gs
    return float(total / n_all), grads


def _tree(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def train_steps(params: dict, batches, n_heads: int, opt: dict,
                prec: str = "f32", rows: int = 1, half_batch: bool = False):
    """Run AdamW steps from ``params`` (left unchanged) over ``batches``,
    each a (B, T+1) token tensor, as the trainer under test states them:
    global-norm clipping at ``clip_norm`` (scaled only at or above it),
    then AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay off
    norms, biases and positions. ``half_batch`` plants the fault that
    drops the second half of every batch.

    Returns (losses, the norm of the first gradient as the update took
    it, by leaf name, the norm of every leaf's change after the last step,
    by leaf name)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = {n: x.detach().float().clone() for n, x in leaves(params)}
    mu = {n: torch.zeros_like(x) for n, x in p.items()}
    nu = {n: torch.zeros_like(x) for n, x in p.items()}
    losses, first = [], None
    for count, tok in enumerate(batches):
        if half_batch:
            tok = tok[: tok.shape[0] // 2]
        loss, g = loss_and_grads(_tree(p), tok, n_heads, prec, rows)
        losses.append(loss)
        norm = torch.sqrt(sum(x.double().square().sum() for x in g.values()))
        if norm >= opt["clip_norm"]:
            g = {n: x * (opt["clip_norm"] / norm).float() for n, x in g.items()}
        if first is None:
            first = {n: float(x.double().norm()) for n, x in g.items()}
        lr = lr_at(count, opt)
        bc1, bc2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
        for n in p:
            mu[n].mul_(b1).add_(g[n], alpha=1 - b1)
            nu[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
            if n.split(".")[-1] not in _NO_DECAY:
                u = u + opt["weight_decay"] * p[n]
            p[n].add_(u, alpha=-lr)
        del g
    del mu, nu
    change = {n: float((p[n] - x.detach().float()).double().norm())
              for n, x in leaves(params)}
    return losses, first, change
