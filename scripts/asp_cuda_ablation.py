#!/usr/bin/env python3
"""Where the bf16 ASP kernel of the PyTorch/CUDA port spends its time, on
one NVIDIA card.

    python3 scripts/asp_cuda_ablation.py

Builds ``csrc/asp.cu`` as it is and with one part of ``asp_bf16_kernel``
taken out per variant (a text substitution in a copy of the source, built
with the port's nvcc flags into ``_build/ablation/``, all variants at once),
and times each at the kernel-phase shapes of ``chip_smoke.py``: x (32, 3072,
501) bf16, a_tanh (32, 128, 501), the same seeded inputs and length masks.
The variants compute wrong numbers on purpose; only their times count:

  as_is          the kernel
  no_mma         the mma.sync instructions removed (ldmatrix kept)
  no_product     the whole score product removed (ldmatrix and mma.sync)
  no_softmax     the pass that reads x and sums p, p x, p x^2 removed
  staging_only   everything after the tile reaches shared memory removed
                 (the copies, the waits and the barriers are left)
  no_stop        every row walked to T, not to its last valid frame (the
                 tiles past it are copied, then skipped as empty)
  compute_only   the copies of every tile after the first removed (each
                 tile computes on the first one's data)

Prints one JSON line per variant (ms: device time per call, timed as
``chip_smoke.py`` times a kernel; registers and spill bytes from ptxas),
then the card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MMA = (
    "        mma_bf16(acc[2 * np], af, bf[0], bf[1]);\n"
    "        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);\n"
)
VARIANTS = {
    "as_is": [],
    "no_mma": [(MMA, "")],
    "no_product": [
        ("for (int k0 = 0; k0 < Kp; k0 += 16) {", "for (int k0 = 0; k0 < 0; k0 += 16) {")
    ],
    "no_softmax": [
        (
            "for (int n = 0; n < kFrames / 8; ++n) {\n        const uint32_t xw",
            "for (int n = 0; n < 0; ++n) {\n        const uint32_t xw",
        )
    ],
    "staging_only": [("if (valid == 0ull) continue;", "continue;")],
    "no_stop": [("  t_end += 1;", "  t_end = Tn;")],
    "compute_only": [
        (
            "      copy_tile(next, xr, ab, lda, nx, A, Kp, Tn, r0, tid, t0 + kFrames, t_end);\n",
            "",
        )
    ],
}


def build(torch, src: str):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import _cuda_lib

    out_dir = os.path.join(str(_cuda_lib.BUILD_DIR), "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: substitution site not found once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"asp_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libasp_{name}.so")
        cmd = [_cuda_lib._nvcc(), *_cuda_lib.NVCC_FLAGS, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        chunk = next(
            c for c in log.split("Compiling entry function")[1:]
            if "asp_bf16_kernel" in c.split("\n", 1)[0]
        )
        regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", chunk).group(1))
        libs[name] = (ctypes.CDLL(so), regs, spill)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("asp_cuda_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import time_ms
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda

    src_path = os.path.join(
        HERE, "pyannote_audio_speaker_diarization_cpp_tpu_torch", "csrc", "asp.cu"
    )
    with open(src_path) as f:
        libs = build(torch, f.read())

    # the inputs of chip_smoke.py's ASP phase (its seed, after the pack and
    # log-mel draws)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, C, A, T = 32, 3072, 128, 501
    rng.normal(size=(B, 80000))
    rng.uniform(size=(B, 293 // 8 + 1))
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32)).to(dev)
    attn = torch.from_numpy(rng.normal(size=(B, A, T)).astype(np.float32)).to(dev)
    bound_w = 1.0 / np.sqrt(A)
    w = torch.from_numpy(rng.uniform(-bound_w, bound_w, (C, A)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-bound_w, bound_w, C).astype(np.float32)).to(dev)
    lens = rng.uniform(0.05, 1.0, B)
    lens[::4] = 1.0
    mask = torch.from_numpy((np.arange(T)[None, :] < (lens * T)[:, None]).astype(np.float32)).to(dev)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    a = asp_cuda.attention_tanh(attn.to(torch.bfloat16))  # as the model lays it out
    mean = torch.empty((B, C), dtype=torch.bfloat16, device=dev)
    std = torch.empty_like(mean)
    stream = torch.cuda.current_stream().cuda_stream

    for name, (lib, regs, spill) in libs.items():
        fn = lib.asp_pool_bf16_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 2
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p]
        )

        def run():
            err = fn(
                x.data_ptr(), a.data_ptr(), a.stride(1), w.data_ptr(), bias.data_ptr(), 0,
                mask.data_ptr(), 0, mean.data_ptr(), std.data_ptr(), B, C, A, T, 1e-12, stream,
            )
            if err != 0:
                raise RuntimeError(f"variant {name}: launch failed (cudaError {err})")

        print(json.dumps({"variant": name, "ms": time_ms(torch, run), "registers": regs,
                          "spill_bytes": spill}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
