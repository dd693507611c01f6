"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked by one more into one shared
library with a plain C interface, which ``ctypes`` loads.  No PyTorch
headers are compiled, so the build takes as long as the slowest source.
The library goes to ``build/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an unchanged tree loads the library it
already built (with nvcc's output, kept beside it) and an edited header
builds anew.  Nothing here runs at
import time: the first kernel launch calls ``library()``.  A failed build
or launch raises ``KernelError``, which is not a ``RuntimeError``: the
server requeues a batch on a runtime error, and must never requeue a
kernel fault.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # dtype, q, k, v, lengths, out, B, T, H, D, chunk,
    # q strides (b, t, h), k strides, v strides, scale, stream
    "local_attention_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L,
                            ctypes.c_float, _P],
    # the same with the lse output after out
    "local_attention_fwd_lse": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                ctypes.c_float, _P],
    # dtype, q, k, v, g, lse, delta, lengths, dq, B, T, H, D, chunk,
    # q/k/v/g strides (b, t, h), scale, stream
    "local_attention_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, *[_L] * 12, ctypes.c_float, _P],
    # the same with dk, dv in place of dq
    "local_attention_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, *[_L] * 12, ctypes.c_float,
                                _P],
    # dtype, dc, x, scale, shift, mean, rstd, w, out, B, T, C, C_out, K,
    # dilation, (b, t) strides of x, scale and shift, stream
    "adain_conv_bwd_data": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _L, _L, _L, _L, _L, _L, _P],
    # dtype, x, w, bias, syn, inv_env, out, B, T, C, K, n_fft, hop,
    # x strides (b, t, c), tiles_per_row, n_tiles, grid, stream
    "synthesis_head_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _L, _L, _L, _I, _I, _I, _P],
    # dtype, q, k, v, mask (or null), out, B, Tq, Tk, H, D,
    # q strides (b, t, h), k strides, v strides, mask batch stride, scale,
    # stream
    "full_attention_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                           ctypes.c_float, _P],
    # real, imag, syn, inv_env, out, B, F, n_fft, hop, frames per block,
    # basis in shared memory (0/1), stream
    "istft_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # real, imag, syn, envelope table, out, B, F, n_fft, hop, Fc, grid,
    # stream
    "istft_sm90_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, den_cond, den_uncond, x_out, d_out, n, s_cur, s_next - s_cur,
    # guidance, stream
    "sampler_euler_fwd": [_P, _P, _P, _P, _P, _L, _F, _F, _F, _P],
    # x, x_euler, den2_cond, den2_uncond, d_cur, x_out, n,
    # (s_next - s_cur) / 2, max(s_next, 1e-8), guidance, stream
    "sampler_heun_fwd": [_P, _P, _P, _P, _P, _P, _L, _F, _F, _F, _P],
    # dtype, x, scale, shift, mean, rstd, w, out, B, T, C, C_out, K,
    # dilation, (b, t) strides of x, scale and shift, stream
    "adain_conv_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _L, _L, _L, _L, _L, _L, _P],
    # dtype, x, w, out, B, T, C_in, C_out, K, stride, x strides (b, t, c),
    # leaky, slope, stream
    "conv_transpose_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L,
                           _L, _I, _F, _P],
    # blocks per SM and dynamic shared memory per block (int pointers) of
    # the bf16 kernels of rows 1, 6, 7, 10, 12, 2 and row 2's fp32 kernel
    # (the latter two at Tk keys), 4 or 5 (0 or 1) and row 11's sm90 kernel
    # (at n_fft)
    "local_attention_fwd_occupancy": [_P, _P],
    "adain_conv_fwd_occupancy": [_P, _P],
    "adain_conv_bwd_data_occupancy": [_P, _P],
    "conv_transpose_fwd_occupancy": [_P, _P],
    "synthesis_head_fwd_occupancy": [_P, _P],
    "full_attention_fwd_occupancy": [_I, _P, _P],
    "full_attention_f32_occupancy": [_I, _P, _P],
    "local_attention_bwd_occupancy": [_I, _P, _P],
    "istft_sm90_occupancy": [_I, _P, _P],
}


class KernelError(Exception):
    """A kernel that could not be built (no nvcc, a compile or link error)
    or whose launch returned a CUDA error."""


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an existing build was loaded
    log: str                 # nvcc's output, ``-Xptxas -v`` lines included
                             # (kept beside the library for a later load)


def sources() -> list[Path]:
    """The sources nvcc compiles, one process each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include: not compiled alone, but hashed."""
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels can only be "
                          "built on a machine with the CUDA toolkit")
    return found


def digest() -> str:
    """The hash that names the library: the flags, then each source and
    header by name and content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources() + headers():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libstyletts_zs_kernels-{digest()}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if path.exists():
        log = (log_path.read_text() if log_path.exists()
               else "loaded an existing build")
    else:
        t0 = time.perf_counter()
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        if any(proc.returncode for proc in procs):
            raise KernelError(f"nvcc failed:\n{log}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelError(f"nvcc link failed:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)
        for obj in objs:
            obj.unlink()
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, log=log)


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc}")
