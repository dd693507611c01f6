"""ctypes bridge to the native host frontend (``frontend.cc``).

``frontend.cc`` is a verbatim copy of ``styletts_zs_tpu/native/frontend.cc``
(``tests/test_torch_corpus.py`` checks it): frame energy, YIN-style F0 and
the polyphase resampler in C++.  It is built at first use by one ``g++ -O3
-fPIC -shared -std=c++17`` call into ``build/`` at the repository root
(listed in ``.gitignore``), beside the kernels' library, named by a hash of
the source and the flags, to a temporary name that is then renamed, so
processes that build at once (test workers, data-loader workers) never load
a half-written library.  The JAX package's own ``libstz_frontend.so`` is
never loaded.  Without g++ (or when the build fails) ``available()`` is
False and ``utils/audio.py`` takes its numpy twins, with one line on
stderr.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "frontend.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstz_frontend-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)


@functools.cache
def _load():
    """The bound library, built first when missing; None if it cannot be."""
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError) as e:
        print(f"styletts_zs_torch.native: frontend unavailable ({e!r}); "
              f"numpy twins in use", file=sys.stderr)
        return None
    i32, i64, f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.stz_n_frames.restype = i64
    lib.stz_n_frames.argtypes = [i64, i32, i32]
    lib.stz_frame_energy.restype = None
    lib.stz_frame_energy.argtypes = [fptr, i64, i32, i32, fptr]
    lib.stz_estimate_f0.restype = None
    lib.stz_estimate_f0.argtypes = [fptr, i64, i32, i32, i32, f32, f32, f32,
                                    fptr, ctypes.POINTER(ctypes.c_uint8)]
    lib.stz_resample_out_len.restype = i64
    lib.stz_resample_out_len.argtypes = [i64, i32, i32]
    lib.stz_resample_poly.restype = None
    lib.stz_resample_poly.argtypes = [fptr, i64, i32, i32, i32,
                                      ctypes.c_double, fptr]
    return lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native frontend could not be built (g++ "
                           "missing or failing); use the numpy twins of "
                           "styletts_zs_torch.utils.audio")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def estimate_f0(wav: np.ndarray, sample_rate: int, *, hop: int = 300,
                frame_length: int = 1200, fmin: float = 60.0,
                fmax: float = 400.0, threshold: float = 0.1):
    """(f0 Hz (n_frames,) float32, voiced (n_frames,) bool)."""
    lib = _require()
    wav = np.ascontiguousarray(wav, np.float32)
    n_frames = lib.stz_n_frames(len(wav), frame_length, hop)
    f0 = np.zeros(n_frames, np.float32)
    voiced = np.zeros(n_frames, np.uint8)
    lib.stz_estimate_f0(
        _fptr(wav), len(wav), sample_rate, hop, frame_length, fmin, fmax,
        threshold, _fptr(f0),
        voiced.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return f0, voiced.astype(bool)


def frame_energy(wav: np.ndarray, *, hop: int = 300,
                 frame_length: int = 1200) -> np.ndarray:
    """Log-RMS energy per frame, float32."""
    lib = _require()
    wav = np.ascontiguousarray(wav, np.float32)
    out = np.zeros(lib.stz_n_frames(len(wav), frame_length, hop), np.float32)
    lib.stz_frame_energy(_fptr(wav), len(wav), frame_length, hop, _fptr(out))
    return out


def resample_poly(wav: np.ndarray, sr_in: int, sr_out: int, *,
                  half: int = 10, beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed-sinc polyphase resampler (twin:
    ``utils.audio.resample_poly_np``)."""
    lib = _require()
    wav = np.ascontiguousarray(wav, np.float32)
    out = np.zeros(lib.stz_resample_out_len(len(wav), sr_in, sr_out),
                   np.float32)
    lib.stz_resample_poly(_fptr(wav), len(wav), sr_in, sr_out, half, beta,
                          _fptr(out))
    return out
