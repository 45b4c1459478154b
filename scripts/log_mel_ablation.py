#!/usr/bin/env python3
"""Where the log-mel kernel of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    python3 scripts/log_mel_ablation.py

Builds ``csrc/frontend.cu`` as it is and with one part of ``log_mel_kernel``
changed per variant (a text substitution in a copy of the source, built with
the port's nvcc flags into ``_build/ablation/``, all variants at once), and
times each at the kernel-phase inputs of ``chip_smoke.py``: the 32 packed
windows of 80000 samples (its seed), the default front-end. The variants
compute wrong numbers on purpose; only their times count:

  as_is         the kernel
  one_tf32      one TF32 product (a_big . b_big) in place of three: a speed
                reference only, it is 0.4-0.6 dB off
  no_epilogue   the product and the power tile, without the mel projection
                and the dB conversion
  staging_only  the copy of x into shared memory, the passes without their
                k16 loop (the power stores kept), no epilogue
  no_basis_copy each pass copies only its first k16 of the basis and reads
                it at every k16 (what staging the basis from L2 costs)

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

THREE_TERMS = (
    "    wgmma_tf32(d, a_small[h], b_desc(big), h);  // a_small . b_big\n"
    "    wgmma_tf32(d, a_big[h], b_desc(small), 1);  // a_big . b_small\n"
    "    wgmma_tf32(d, a_big[h], b_desc(big), 1);    // a_big . b_big\n"
)
EPILOGUE = (
    "for (int idx = tid; idx < nvalid * n_mels; idx += kThreads) {",
    "for (int idx = tid; idx < 0; idx += kThreads) {",
)
VARIANTS = {
    "as_is": [],
    "one_tf32": [(THREE_TERMS, "    wgmma_tf32(d, a_big[h], b_desc(big), h);\n")],
    "no_epilogue": [EPILOGUE],
    "staging_only": [("  const int k16s = ksteps / 2;\n", "  const int k16s = 0;\n"), EPILOGUE],
    "no_basis_copy": [("    if (it + 1 < k16s)\n", "    if (false)\n")],
}


def build(src: str):
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
        cu = os.path.join(out_dir, f"frontend_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libfrontend_{name}.so")
        cmd = [_cuda_lib._nvcc(), *_cuda_lib.NVCC_FLAGS, "-o", so, cu]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            so,
        )
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        chunk = next(
            c for c in log.split("Compiling entry function")[1:]
            if "log_mel_kernel" in c.split("\n", 1)[0]
        )
        regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", chunk).group(1))
        libs[name] = (ctypes.CDLL(so), regs, spill)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("log_mel_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import BATCH, WINDOW, pack_inputs, time_ms
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import FrontendConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend as fe
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend_cuda, pack_cuda

    src_path = os.path.join(
        HERE, "pyannote_audio_speaker_diarization_cpp_tpu_torch", "csrc", "frontend.cu"
    )
    with open(src_path) as f:
        libs = build(f.read())

    # the inputs of chip_smoke.py's log-mel phase: its packed windows
    dev = torch.device("cuda")
    x, _ = pack_cuda.pack_frames_plain(*pack_inputs(torch, np.random.default_rng(0), dev))
    cfg = FrontendConfig()
    basis, mel = fe.constants(cfg, dev)
    mult, db_off = fe._db_terms(cfg)
    tiles = frontend_cuda.basis_tiles(basis)
    bins, weights = frontend_cuda.band_table(mel)
    frames = frontend_cuda.num_stft_frames(WINDOW, cfg.hop_length)
    n_mels = mel.shape[1]
    out = torch.empty((BATCH, frames, n_mels), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    for name, (lib, regs, spill) in libs.items():
        fn = lib.log_mel_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
        )

        def run():
            err = fn(
                x.data_ptr(), tiles.data_ptr(), bins.data_ptr(), weights.data_ptr(),
                out.data_ptr(), BATCH, WINDOW, frames, cfg.hop_length,
                frontend_cuda.kernel_ksteps(cfg.win_length),
                cfg.win_length // 2, n_mels, cfg.amin, mult, db_off,
                mult * np.log10(cfg.amin) - db_off, stream,
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
