"""Build the port's CUDA kernels with ``nvcc`` and bind them through ctypes.

Every ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<stem>-<hash>.so csrc/<stem>.cu

into ``deeplearning4j_tpu_torch/_build/`` at first use. The file name
carries a hash of the source, the shared headers and the flags, so an edit
rebuilds and a stale library is never loaded. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.

Wrappers pass pointers and the stream as ``ctypes.c_void_p`` (a plain int
argument would be cut to 32 bits) and every C entry returns its launch's
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's stderr per source from this process's builds (ptxas register and
#: shared-memory report), for the chip smoke run to print
build_logs: dict[str, str] = {}


def sources() -> list[str]:
    """Stems of every kernel source in the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use on a CUDA machine"
    )


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{stem}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _start(stem: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(stem)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(stem: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_logs[stem] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> list[str]:
    """Compile every source whose library is missing, all ``nvcc``
    processes running at once. Returns the stems that were built."""
    with _lock:
        jobs = {s: _start(s) for s in sources()}
        built = []
        errors = []
        for stem, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(stem, job)
                built.append(stem)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return built


def library(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, building it first if
    needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is not None:
            return lib
        job = _start(stem)
        if job is not None:
            _finish(stem, job)
        lib = ctypes.CDLL(str(_lib_path(stem)))
        lib.dl4j_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_error_string.restype = ctypes.c_char_p
        _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.dl4j_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
