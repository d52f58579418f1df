"""Builds of a kernel source with other constants, for the sweep scripts
(``torch_decode_sweep.py``, ``torch_emb_dot_sweep.py``). The port always
runs the source's own constants; these copies only measure."""

from __future__ import annotations

import ctypes
import re
import subprocess


def parse_variant(spec: str) -> tuple[str, dict[str, int]]:
    """``NAME:CONST=V[,CONST=V]`` -> (NAME, {CONST: V})."""
    name, _, consts = spec.partition(":")
    subs = {}
    for item in filter(None, consts.split(",")):
        key, _, val = item.partition("=")
        subs[key.strip()] = int(val)
    return name, subs


def build_variants(stem: str, variants: dict[str, dict[str, int]]
                   ) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Copies of ``csrc/<stem>.cu`` that differ only in the ``constexpr
    int`` constants each variant names, built at once into the package's
    ``_build/``. Returns {variant: (library, nvcc's log)}; raises
    ValueError for a constant the source does not hold."""
    from deeplearning4j_tpu_torch.ops import _build as b

    src = (b.CSRC / f"{stem}.cu").read_text()
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in variants.items():
        text = src
        for const, val in subs.items():
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {val};", text)
            if n != 1:
                raise ValueError(f"no constant {const} in {stem}.cu")
        cu = b.BUILD_DIR / f"{stem}_sweep_{name}.cu"
        so = b.BUILD_DIR / f"{stem}_sweep_{name}.so"
        cu.write_text(text)
        cmd = [b.nvcc(), *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o", str(so),
               str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.dl4j_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, log)
    return libs
