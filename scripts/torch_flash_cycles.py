#!/usr/bin/env python3
"""Where a tile's time goes inside the tensor-core flash kernels, on one
CUDA card.

    python3 scripts/torch_flash_cycles.py [--bh 144] [--t 1024] [--out PATH]

Builds instrumented copies of ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu`` (into the package's ``_build/`` directory) in
which thread 0 of every consumer warpgroup reads ``clock64()`` around the
phases of each KV (forward) or streamed (backward) tile: the wait for the
tile's data, the first chain of ``wgmma`` products (issue to completion),
the math between the chains (softmax, or P and dS with their bf16
roundings), and the second chain. Runs the forward and the backward (dQ and
dK/dV passes) at the training shape (D 128, causal, bf16) and prints the
mean cycles per tile and per warpgroup for each kernel. The copies differ
from the sources only by the counters; the kernels the port runs are never
instrumented. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_COUNTERS = r'''
__device__ unsigned long long g_cycles[16];
extern "C" int dl4j_cycles_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaError_t e = cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_cycles, z, sizeof(z));
  return (int)e;
}
'''
_START = ("long long cstart = clock64(), pw = 0, p1 = 0, pm = 0, p2 = 0, "
          "ntile = 0;\n")
_ACC = ("if ((tid & 127) == 0) { pw += c1 - c0; p1 += c2 - c1; "
        "pm += c3 - c2; p2 += c4 - c3; ++ntile; }\n")


def _end(slot: int) -> str:
    vals = ("pw", "p1", "pm", "p2", "ntile", "(clock64() - cstart)", "1")
    adds = " ".join(f"atomicAdd(&g_cycles[{slot + i}], "
                    f"(unsigned long long)({v}));"
                    for i, v in enumerate(vals))
    return f"if ((tid & 127) == 0) {{ {adds} }}\n"


def _patch(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"torch_flash_cycles: source changed, no "
                             f"anchor {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


def instrumented_sources(csrc: Path) -> dict[str, str]:
    inc = '#include "hopper.cuh"\n'
    fwd = (csrc / "flash_attn_fwd.cu").read_text()
    fwd = _patch(fwd, [
        (inc, inc + _COUNTERS),
        ("  for (int j = 0; j < n_tiles; ++j) {\n    const int s = j % STAGES;"
         "\n    const int ph",
         "  " + _START + "  for (int j = 0; j < n_tiles; ++j) {\n"
         "    const int s = j % STAGES;\n    const int ph"),
        ("    mbar_wait(k_full + s, ph);\n",
         "    long long c0 = clock64();\n    mbar_wait(k_full + s, ph);\n"
         "    long long c1 = clock64();\n"),
        ("    fence_regs(sc);\n", "    fence_regs(sc);\n"
         "    long long c2 = clock64();\n"),
        ("    mbar_wait(v_full + s, ph);\n",
         "    long long c3 = clock64();\n    mbar_wait(v_full + s, ph);\n"),
        ("    fence_regs(pa);\n", "    fence_regs(pa);\n"
         "    long long c4 = clock64();\n    " + _ACC),
        ("  const size_t base = (size_t)bh * t;\n",
         "  " + _end(0) + "  const size_t base = (size_t)bh * t;\n"),
    ])
    bwd = (csrc / "flash_attn_bwd.cu").read_text()
    bwd = _patch(bwd, [(inc, inc + _COUNTERS)])
    i = bwd.index("flash_bwd_dkdv_wgmma_kernel(__grid")
    j = bwd.index("flash_bwd_dq_wgmma_kernel(__grid")
    head, dkdv, dq = bwd[:i], bwd[i:j], bwd[j:]
    dkdv = _patch(dkdv, [
        ("  mbar_wait(bars.own, 0);\n  for (int j = 0; j < n; ++j) {",
         "  " + _START + "  mbar_wait(bars.own, 0);\n"
         "  for (int j = 0; j < n; ++j) {"),
        ("    mbar_wait(bars.full + s, (j / STAGES) & 1);\n",
         "    long long c0 = clock64();\n"
         "    mbar_wait(bars.full + s, (j / STAGES) & 1);\n"
         "    long long c1 = clock64();\n"),
        ("    fence_regs(dpt);\n", "    fence_regs(dpt);\n"
         "    long long c2 = clock64();\n"),
        ("    // dV += P^T dO and dK += dS^T Qs",
         "    long long c3 = clock64();\n"
         "    // dV += P^T dO and dK += dS^T Qs"),
        ("    fence_regs(dsa);\n", "    fence_regs(dsa);\n"
         "    long long c4 = clock64();\n    " + _ACC),
        ("#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n"
         "    const int r = row + 8 * h;\n    if (r >= t) continue;",
         "  " + _end(0) + "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n"
         "    const int r = row + 8 * h;\n    if (r >= t) continue;"),
    ])
    dq = _patch(dq, [
        ("  for (int j = 0; j < n; ++j) {",
         "  " + _START + "  for (int j = 0; j < n; ++j) {"),
        ("    mbar_wait(bars.full + s, (j / STAGES) & 1);\n",
         "    long long c0 = clock64();\n"
         "    mbar_wait(bars.full + s, (j / STAGES) & 1);\n"
         "    long long c1 = clock64();\n"),
        ("    fence_regs(dp);\n", "    fence_regs(dp);\n"
         "    long long c2 = clock64();\n"),
        ("    // dQ += dS K (K MN-major)",
         "    long long c3 = clock64();\n    // dQ += dS K (K MN-major)"),
        ("    fence_regs(dsa);\n", "    fence_regs(dsa);\n"
         "    long long c4 = clock64();\n    " + _ACC),
        ("#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n"
         "    const int r = row + 8 * h;\n    if (r >= t) continue;",
         "  " + _end(8) + "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n"
         "    const int r = row + 8 * h;\n    if (r >= t) continue;"),
    ])
    return {"flash_attn_fwd_cycles": fwd,
            "flash_attn_bwd_cycles": head + dkdv + dq}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bh", type=int, default=144)
    ap.add_argument("--t", type=int, default=1024)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the numbers as JSON to PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_cycles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for stem, src in instrumented_sources(_build.CSRC).items():
        cu = _build.BUILD_DIR / f"{stem}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        procs.append((stem, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for stem, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        libs[stem] = ctypes.CDLL(str(so))

    bh, t, d = args.bh, args.t, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((bh, t, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = fa.flash_attention_bwd_delta(o, do)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = ctypes.c_void_p
    scale = 1.0 / math.sqrt(d)
    o2, lse2, dq, dk, dv, qs = (torch.empty_like(x) for x in
                                (o, lse, q, q, q, q))
    fwd = libs["flash_attn_fwd_cycles"].dl4j_flash_attn_fwd
    fwd.argtypes = [ptr] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ptr]
    bwd = libs["flash_attn_bwd_cycles"].dl4j_flash_attn_bwd
    bwd.argtypes = [ptr] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ptr]
    calls = {
        "flash_attn_fwd_cycles": lambda: fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
            lse2.data_ptr(), bh, t, d, scale, 1, 1, stream),
        "flash_attn_bwd_cycles": lambda: bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), qs.data_ptr(), bh, t, d, scale, 1, 1, stream),
    }
    names = {"flash_attn_fwd_cycles": ("forward", None),
             "flash_attn_bwd_cycles": ("backward dK/dV pass",
                                       "backward dQ pass")}
    buf = (ctypes.c_ulonglong * 16)()
    result = {"card": card, "shape": {"bh": bh, "t": t, "d": d,
                                      "causal": True, "dtype": "bf16"}}
    print(f"card: {card}; BH {bh}, T {t}, D {d}, causal, bf16")
    for stem, call in calls.items():
        read = libs[stem].dl4j_cycles_read
        read.argtypes = [ctypes.c_void_p]
        call()  # warm-up, then the counters of 3 calls
        read(ctypes.addressof(buf))
        for _ in range(3):
            if call() != 0:
                raise SystemExit(f"{stem}: launch failed")
        read(ctypes.addressof(buf))
        for slot, name in zip((0, 8), names[stem]):
            if name is None:
                continue
            wait, chain1, math_, chain2, tiles, total, wgs = buf[slot:slot + 7]
            per = {"wait_for_tile": wait / tiles, "first_wgmma_chain":
                   chain1 / tiles, "math": math_ / tiles,
                   "second_wgmma_chain": chain2 / tiles,
                   "per_warpgroup_total": total / wgs,
                   "tiles_per_warpgroup": tiles / wgs}
            result[name] = per
            print(f"{name}: cycles per tile: wait {per['wait_for_tile']:.0f}"
                  f", first wgmma chain {per['first_wgmma_chain']:.0f}, "
                  f"math {per['math']:.0f}, second wgmma chain "
                  f"{per['second_wgmma_chain']:.0f}; per warpgroup "
                  f"{per['per_warpgroup_total']:.0f} over "
                  f"{per['tiles_per_warpgroup']:.2f} tiles")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
