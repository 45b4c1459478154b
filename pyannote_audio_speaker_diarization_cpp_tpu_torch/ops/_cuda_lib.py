"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``_build/lib<name>-<digest>.so`` (the digest covers the source
and the flags, so an edited source never loads a stale library), which is
loaded with ``ctypes``; nvcc's report is kept beside it as ``.log``. Builds happen at first use, never at import: the CPU
test host has no ``nvcc``. ``build`` starts one ``nvcc`` per missing library,
all at once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("pack", "frontend", "asp", "linkage")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named library that is not built yet, in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            _target(name).with_suffix(".log").write_text(log)
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's report of the built library ``name`` (registers, shared memory
    and spills of each kernel, from ``-Xptxas -v``); "" if not built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = getattr(library(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
