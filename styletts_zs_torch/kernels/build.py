"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ONE ``nvcc`` call into one shared
library with a plain C interface, which ``ctypes`` loads.  No PyTorch
headers are compiled, so the build takes seconds.  The library goes to
``build/`` at the repository root (listed in ``.gitignore``), named by a
hash of the sources and flags, so an unchanged tree loads the library it
already built.  Nothing here runs at import time: the first kernel launch
calls ``library()``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # dtype, q, k, v, lengths, out, B, T, H, D, chunk,
    # q strides (b, t, h), k strides, v strides, scale, stream
    "local_attention_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L,
                            ctypes.c_float, _P],
    # dtype, x, w, bias, syn, inv_env, out, B, T, C, K, n_fft, hop, stream
    "synthesis_head_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P],
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an existing build was loaded
    log: str                 # nvcc's output, ``-Xptxas -v`` lines included


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels can only be "
                           "built on a machine with the CUDA toolkit")
    return found


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libstyletts_zs_kernels-{_digest(srcs)}.so"
    seconds, log = 0.0, "loaded an existing build"
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, log=log)


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
