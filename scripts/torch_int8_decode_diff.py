#!/usr/bin/env python3
"""Where the int8 decode kernels and their plain version part, on one CUDA
card.

    python3 scripts/torch_int8_decode_diff.py [--seeds 16] [--out PATH]

Runs kernel #4 in int8 mode on the inputs of
``tests/test_torch_flash_decode_paged.py::test_paged_kernel_on_card`` (the
GPT-2-small decode shape: B 8, Hkv*K 768, 12 layers, Tpad 640; block sizes
8 and 64) and kernel #3 in int8 mode on those of
``tests/test_torch_int8_decode.py::test_int8_kernel_matches_plain_on_card``,
then ``--seeds`` further seeds of each, and holds every output against four
re-computations of the int8 arithmetic on the card over the same rows. The
four differ in two points only:

- how ``x / 127`` is rounded for the q scale and the softmax-weight scale:
  ``recip``, as ``x / 127.0`` runs in PyTorch on CUDA (x times the
  reciprocal of 127), or ``div``, one IEEE division (the kernel's
  ``/ 127.f``);
- the order in which l sums a tile's softmax weights: ``torch.sum``
  (``sum``), or the kernel's (``warp``: two rows a lane, then a warp
  butterfly).

For each variant it prints whether the output equals the kernel's bit for
bit, the largest difference, and how many elements are further apart than
one bf16 step of the output. For each tile where ``recip`` and ``div``
quantize differently it prints both softmax-weight scales (psc) and every
quantized softmax weight (p8) that differs, with its (batch row, cache
row, group, head). It also checks how PyTorch divides by a Python number
on this card. Writes everything as JSON to PATH with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TILE = 64
VARIANTS = [("recip", "sum"), ("div", "sum"), ("recip", "warp"),
            ("div", "warp")]


def _div127(x, how: str):
    import torch

    if how == "recip":
        return x / 127.0
    return x / torch.full((), 127.0, device=x.device)


def _warp_order_sum(x):
    """Sum over the last axis (64 rows) in the kernel's order: lane j adds
    rows j and j + 32, then a butterfly over offsets 16, 8, 4, 2, 1."""
    s = x[..., :32] + x[..., 32:]
    w = 16
    while w:
        s = s[..., :w] + s[..., w:2 * w]
        w //= 2
    return s[..., 0]


def emulate(q, kv8, scales, pos, hkv: int, div: str, lsum: str):
    """The int8 decode of ``flash_decode_attention_plain`` over a (1, 2, B,
    T, Hkv*K) slab at 64-row tiles, with the two switches above; returns the
    output and, per tile, (psc (B,), p8 (B, G, Hkv, 64), live (B,))."""
    import torch

    from deeplearning4j_tpu_torch.ops.flash_decode import _quant8

    b, g, hk = q.shape
    t = kv8.shape[3]
    assert t % TILE == 0
    kd = hk // hkv
    scale = torch.tensor(1.0 / math.sqrt(kd), dtype=torch.float32)
    qf = q.float()
    qsc = _div127(qf.abs().amax(-1, keepdim=True).clamp_min(1e-8), div)
    qi = _quant8(qf / qsc).reshape(b, g, hkv, kd).double()
    qsc4 = qsc[..., None]
    k8 = kv8[0, 0].reshape(b, t, hkv, kd)
    v8 = kv8[0, 1].reshape(b, t, hkv, kd)
    ksc = scales[0, 0, :, :, 0] * scale
    vsc = scales[0, 1, :, :, 0]
    p = pos.long()
    m = torch.full((b, g, hkv), float("-inf"), device=q.device)
    l = torch.zeros((b, g, hkv), device=q.device)
    acc = torch.zeros((b, g, hkv, kd), device=q.device)
    rows = torch.arange(t, device=q.device)
    tiles = []
    for t0 in range(0, t, TILE):
        t1 = t0 + TILE
        dots = torch.einsum("bghk,bthk->bght", qi,
                            k8[:, t0:t1].double()).float()
        s = dots * ksc[:, None, None, t0:t1] * qsc4
        s = s.masked_fill((rows[t0:t1][None] > p[:, None])[:, None, None],
                          float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        tot = pr.sum(-1) if lsum == "sum" else _warp_order_sum(pr)
        l_new = corr * l + tot
        pv = pr * vsc[:, None, None, t0:t1]
        psc = _div127(pv.amax(dim=(1, 2, 3)).clamp_min(1e-30), div)[
            :, None, None, None]
        p8 = _quant8(pv / psc)
        o = torch.einsum("bght,bthk->bghk", p8.double(),
                         v8[:, t0:t1].double()).float()
        acc_new = acc * corr[..., None] + o * psc
        live = (t0 <= p)[:, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
        tiles.append((psc.flatten(), p8, live.flatten()))
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(b, g, hk).to(q.dtype)
    return out, qsc.flatten(), tiles


def bf16_steps(out, ref):
    """|out - ref| in units of one bf16 step of ref (its binade's ulp)."""
    import torch

    r = ref.float()
    _, e = torch.frexp(r)
    step = torch.ldexp(torch.ones_like(r), e - 8)
    return (out.float() - r).abs() / step


def compare(out, ref, hkv: int) -> dict:
    import torch

    err = (out.float() - ref.float()).abs()
    steps = bf16_steps(out, ref)
    hk = out.shape[2]
    far = steps > 1
    lanes = sorted({(int(i), int(j), int(k) // (hk // hkv))
                    for i, j, k in far.nonzero().tolist()})
    return dict(bitwise=bool(torch.equal(out, ref)),
                max_abs_err=err.max().item(),
                max_bf16_steps=steps.max().item(),
                n_beyond_one_step=int(far.sum()),
                lanes_beyond_one_step=lanes[:20])


def tile_diffs(tr_a, tr_b) -> list[dict]:
    """Tiles where two variants' psc or p8 differ (live tiles only)."""
    out = []
    for i, ((psc_a, p8_a, live), (psc_b, p8_b, _)) in enumerate(
            zip(tr_a, tr_b)):
        for bi in live.nonzero().flatten().tolist():
            same_psc = psc_a[bi].item() == psc_b[bi].item()
            d = (p8_a[bi] != p8_b[bi]).nonzero().tolist()
            if same_psc and not d:
                continue
            out.append(dict(
                batch_row=bi, tile_start=i * TILE,
                psc_recip=float(psc_a[bi].item()).hex(),
                psc_div=float(psc_b[bi].item()).hex(),
                p8_diffs=[dict(cache_row=i * TILE + r, group=gg, head=h,
                               recip=int(p8_a[bi, gg, h, r]),
                               div=int(p8_b[bi, gg, h, r]))
                          for gg, h, r in d[:20]],
                n_p8_diffs=len(d),
                max_p8_delta=int((p8_a[bi] - p8_b[bi]).abs().max().item())))
    return out


def run_case(name, q, kv8, scales, pos, hkv, kernel_out) -> dict:
    """Every variant against the kernel's output over the slab ``kv8``."""
    res = {"case": name, "variants": {}}
    traces = {}
    for div, lsum in VARIANTS:
        out, qsc, tiles = emulate(q, kv8, scales, pos, hkv, div, lsum)
        res["variants"][f"{div}+{lsum}"] = compare(kernel_out, out, hkv)
        traces[(div, lsum)] = (qsc, tiles)
    (qa, ta), (qb, tb) = traces[("recip", "sum")], traces[("div", "sum")]
    res["qsc_differs"] = int((qa != qb).sum())
    res["tiles_recip_vs_div"] = tile_diffs(ta, tb)
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    plain = fd.flash_decode_attention_plain(q, kv8, pos, hkv, 0,
                                            kv_scales=scales)
    res["plain"] = compare(kernel_out, plain, hkv)
    return res


def _line(res: dict) -> str:
    parts = [f"{res['case']}:"]
    for k, v in res["variants"].items():
        parts.append(f"{k} bitwise={v['bitwise']} max_err="
                     f"{v['max_abs_err']:.3e} beyond_step="
                     f"{v['n_beyond_one_step']}")
    p = res["plain"]
    parts.append(f"plain bitwise={p['bitwise']} max_err={p['max_abs_err']:.3e}"
                 f" steps={p['max_bf16_steps']:.3f}")
    parts.append(f"qsc_differs={res['qsc_differs']} tiles_differ="
                 f"{len(res['tiles_recip_vs_div'])}")
    return " ".join(parts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=16,
                    help="further seeds of each case, counts only")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_decode_diff: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_flash_decode_paged import _card_case as paged_case
    from test_torch_int8_decode import _card_case as slab_case

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    x = torch.rand(1 << 20, device=dev) * 3
    recip = x * torch.tensor(1 / 127, dtype=torch.float32, device=dev)
    report = {"torch_div_by_python_number": dict(
        equals_reciprocal_product=bool(torch.equal(x / 127.0, recip)),
        differs_from_ieee_division=int(
            (x / 127.0 != _div127(x, "div")).sum()),
        n=x.numel())}
    print(json.dumps(report["torch_div_by_python_number"]), flush=True)
    report["cases"], report["seeds"] = [], []
    layer = 7
    for bs in (8, 64):
        for seed in range(args.seeds + 1):
            q, blocks, scales, tables, pos, hkv = paged_case(dev, True, bs,
                                                             seed=seed)
            out = fd.flash_decode_attention_paged(q, blocks, tables, pos,
                                                  hkv, layer=layer,
                                                  block_scales=scales)
            kv8 = fd._gather_rows(blocks, tables, layer).contiguous()
            sc = fd._gather_rows(scales, tables, layer).contiguous()
            res = run_case(f"paged bs={bs} seed={seed}", q, kv8, sc, pos,
                           hkv, out)
            print(_line(res), flush=True)
            (report["cases"] if seed == 0 else report["seeds"]).append(res)
    for g, hkv in ((1, 6), (3, 2)):
        for seed in range(args.seeds + 1):
            q, cache, scales, pos = slab_case(dev, g, hkv, seed=10 + g + seed)
            out = fd.flash_decode_attention(q, cache, pos, hkv, layer=layer,
                                            kv_scales=scales)
            kv8 = cache[layer:layer + 1].contiguous()
            sc = scales[layer:layer + 1].contiguous()
            res = run_case(f"slab G={g} Hkv={hkv} seed={10 + g + seed}", q,
                           kv8, sc, pos, hkv, out)
            print(_line(res), flush=True)
            (report["cases"] if seed == 0 else report["seeds"]).append(res)
    for res in report["cases"]:
        for tdiff in res["tiles_recip_vs_div"]:
            print(f"{res['case']}: tile {tdiff['tile_start']} batch row "
                  f"{tdiff['batch_row']}: psc recip {tdiff['psc_recip']} div "
                  f"{tdiff['psc_div']}, {tdiff['n_p8_diffs']} p8 differ (max "
                  f"|delta| {tdiff['max_p8_delta']}): {tdiff['p8_diffs']}",
                  flush=True)
    summary = {}
    for k in [f"{d}+{s}" for d, s in VARIANTS] + ["plain"]:
        rs = report["cases"] + report["seeds"]
        vs = [r["plain"] if k == "plain" else r["variants"][k] for r in rs]
        summary[k] = dict(cases=len(vs),
                          bitwise=sum(v["bitwise"] for v in vs),
                          beyond_one_step=sum(v["n_beyond_one_step"] > 0
                                              for v in vs),
                          max_bf16_steps=max(v["max_bf16_steps"] for v in vs))
    report["summary"] = summary
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
