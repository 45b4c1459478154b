"""ctypes bindings for the native host library (``native/sdtpu_native.cc``).

The source compiles with ``g++`` into ``_build/libsdtpu_native-<digest>.so``
beside the CUDA kernels' libraries (the digest covers the source and the
flags, so an edited source never loads a stale library), at first use and
never at import. Every caller degrades to the numpy/scipy implementations
when the toolchain or the build is unavailable, as in the JAX package.

``linkage_calls`` counts the native linkages run, so that a caller can see
which backend ``clustering.ahc.linkage`` took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "sdtpu_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-shared")

#: native centroid linkages run (``linkage_centroid`` calls that reached the
#: library)
linkage_calls = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsdtpu_native-{digest}.so"


def build() -> float:
    """Compile the library if it is not built yet. Returns the wall seconds
    spent; raises with the compiler's output on failure."""
    target = library_path()
    if target.exists():
        return 0.0
    t0 = time.perf_counter()
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True,
        text=True,
        timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return time.perf_counter() - t0


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            build()
            lib = ctypes.CDLL(str(library_path()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.sdtpu_linkage_centroid.restype = ctypes.c_int
        lib.sdtpu_linkage_centroid.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.sdtpu_read_wav_info.restype = ctypes.c_int
        lib.sdtpu_read_wav_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.sdtpu_read_wav_data.restype = ctypes.c_int
        lib.sdtpu_read_wav_data.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def linkage_centroid(X: np.ndarray) -> Optional[np.ndarray]:
    """Native centroid linkage of (N, d) X -> (N-1, 4) scipy linkage matrix;
    None if the library is unavailable."""
    global linkage_calls
    lib = _load()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, dtype=np.float64)
    n, d = X.shape
    if n < 2:
        return np.zeros((0, 4))
    Z = np.zeros((n - 1, 4), dtype=np.float64)
    rc = lib.sdtpu_linkage_centroid(
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        d,
        Z.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    linkage_calls += 1
    return Z


def read_wav(path: str):
    """Native WAV read -> (samples (channels, n) float32 raw amplitude,
    sample_rate, bits); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    channels = ctypes.c_int()
    rate = ctypes.c_int()
    bits = ctypes.c_int()
    frames = ctypes.c_longlong()
    rc = lib.sdtpu_read_wav_info(
        path.encode(), ctypes.byref(channels), ctypes.byref(rate),
        ctypes.byref(bits), ctypes.byref(frames),
    )
    if rc != 0:
        return None
    total = frames.value * channels.value
    out = np.empty(total, dtype=np.float32)
    rc = lib.sdtpu_read_wav_data(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), total
    )
    if rc != 0:
        return None
    samples = out.reshape(-1, channels.value).T.copy()
    return samples, rate.value, bits.value
