#!/usr/bin/env python3
"""Where the pack kernel of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    python3 scripts/pack_ablation.py

Builds ``csrc/pack.cu`` as it is and with one part of ``pack_kernel``
changed per variant (a text substitution in a copy of the source, built with
the port's nvcc flags into ``_build/ablation/``, all variants at once), and
times each at the kernel-phase inputs of ``chip_smoke.py`` (its seed: 32
windows of 80000 samples, 49.5 % of them kept), warm and with the L2 cache
flushed before each call. as_is, aligned_pair and the tile and thread
variants compute the pack (held bit-exact to the plain version); the others
are wrong on purpose and only their times count:

  as_is          the kernel
  launch_only    no table and no copy: lens written as 0 (the launch alone)
  launch_smem    launch_only with one shared-memory store and a barrier
  table_only     the segment table and lens, no copy and no zero fill
  table_no_divide      table_only with a shift for the 32-bit division of
                       the frame starts (what the divisions cost)
  table_no_flag_loads  table_only with flags made from the frame index, not
                       loaded (what the flag loads' latency costs)
  table_no_scan  table_only without the warp scan's shuffles
  one_segment    the copy with a fixed one-segment table (half the row from
                 source offset 1, then a zero tail), no table build
  zero_fill      no table, every quad a zero store: the store bound
  aligned_pair   each quad read as two aligned float4 loads and a select on
                 its source offset modulo 4, in place of four 4-byte loads
  quads_2        2 quads a thread (1280 blocks of 2048 samples)
  quads_8        8 quads a thread (320 blocks of 8192 samples)
  threads_128    128 threads a block, 4 quads each (1280 blocks of 2048)
  threads_512    512 threads a block, 4 quads each (320 blocks of 8192)

Prints one JSON line per variant (ms warm, ms_l2_flushed: device time per
call, timed as ``chip_smoke.py`` times a kernel; profiled_ms: one warm
call's run time under torch.profiler, without the launch and event latency
that the CUDA-event times include; registers and spill bytes
of the 16-byte kernel from ptxas; whether its output equals the plain
version's), then the card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD_TABLE = "  const int2 table = build_table(keep + (size_t)row * F, n, F, tab);\n"
COPY = "  copy_tile<kVec>(wav + (size_t)row * n, out + (size_t)row * n, n, table.x, table.y, tab);\n"
QUADS = "constexpr int kQuadsPerThread = 4;\n"
THREADS = "constexpr int kThreads = 256;\n"
GATHER = (
    "          const float* src = wrow + j + t.delta[s];\n"
    "          v[k] = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));\n"
)
DIVIDE = "  return (int)((f * n + F - 1) / F);  // ceil(f * n / F), in 32 bits\n"
FLAGS = "  for (int i = 0; i < kMaxPer; ++i) kept_flag[i] = f0 + i < f1 && krow[f0 + i] != 0;\n"
BEFORE = "  const bool before = f0 > 0 && f0 < F && krow[f0 - 1] != 0;\n"

VARIANTS = {
    "as_is": [],
    "launch_only": [(BUILD_TABLE, "  const int2 table = make_int2(0, 0);\n"), (COPY, "")],
    # nseg is never negative: the table is built, the copy never runs
    "table_only": [(COPY, "  if (table.x < 0)\n  " + COPY)],
    "one_segment": [
        (
            BUILD_TABLE,
            "  if (threadIdx.x == 0) {\n"
            "    tab.dst[0] = 0;\n"
            "    tab.delta[0] = 1;\n"
            "    tab.dst[1] = n / 2;\n"
            "  }\n"
            "  __syncthreads();\n"
            "  const int2 table = make_int2(1, n / 2);\n",
        )
    ],
    "zero_fill": [(BUILD_TABLE, "  const int2 table = make_int2(0, 0);\n")],
    "quads_2": [(QUADS, "constexpr int kQuadsPerThread = 2;\n")],
    "quads_8": [(QUADS, "constexpr int kQuadsPerThread = 8;\n")],
    "aligned_pair": [
        (
            GATHER,
            "          const int src = j + t.delta[s], r = src & 3;\n"
            "          const float4* w4 = reinterpret_cast<const float4*>(wrow) + (src >> 2);\n"
            "          const float4 a = __ldg(w4), b = r ? __ldg(w4 + 1) : a;\n"
            "          v[k] = r == 0 ? a : r == 1 ? make_float4(a.y, a.z, a.w, b.x)\n"
            "               : r == 2 ? make_float4(a.z, a.w, b.x, b.y) : make_float4(a.w, b.x, b.y, b.z);\n",
        )
    ],
    "table_no_divide": [
        (COPY, "  if (table.x < 0)\n  " + COPY),
        (DIVIDE, "  return (int)((f * n) >> 8);\n"),
    ],
    "table_no_flag_loads": [
        (COPY, "  if (table.x < 0)\n  " + COPY),
        (FLAGS, "  for (int i = 0; i < kMaxPer; ++i) kept_flag[i] = f0 + i < f1 && ((f0 + i) & 4);\n"),
        (BEFORE, "  const bool before = f0 > 0 && f0 < F && ((f0 - 1) & 4);\n"),
    ],
    "launch_smem": [
        (
            BUILD_TABLE,
            "  if (threadIdx.x == 0) tab.dst[0] = n;\n"
            "  __syncthreads();\n"
            "  const int2 table = make_int2(0, tab.dst[0] - n);\n",
        ),
        (COPY, ""),
    ],
    "table_no_scan": [
        (COPY, "  if (table.x < 0)\n  " + COPY),
        ("  for (int d = 1; d < 32; d <<= 1) {\n", "  for (int d = 32; d < 32; d <<= 1) {\n"),
    ],
    "threads_128": [(THREADS, "constexpr int kThreads = 128;\n")],
    "threads_512": [(THREADS, "constexpr int kThreads = 512;\n")],
}
EXACT = ("as_is", "aligned_pair", "quads_2", "quads_8", "threads_128", "threads_512")


def build(src: str):
    from chip_smoke import ptxas_report
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
        cu = os.path.join(out_dir, f"pack_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libpack_{name}.so")
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
        libs[name] = (ctypes.CDLL(so), *ptxas_report(log, "pack_kernelILb1E"))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pack_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import l2_flush_buffer, nvidia_smi_line, pack_inputs, profile_call, time_ms
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import pack_cuda

    src_path = os.path.join(
        HERE, "pyannote_audio_speaker_diarization_cpp_tpu_torch", "csrc", "pack.cu"
    )
    with open(src_path) as f:
        libs = build(f.read())

    dev = torch.device("cuda")
    wav, keep = pack_inputs(torch, np.random.default_rng(0), dev)
    want, want_lens = pack_cuda.pack_frames_plain(wav, keep)
    flags = keep.view(torch.uint8)
    batch, n = wav.shape
    out = torch.empty_like(wav)
    lens = torch.empty(batch, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    flush = l2_flush_buffer(torch)

    for name, (lib, regs, spill) in libs.items():
        fn = lib.pack_frames_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def run():
            err = fn(
                wav.data_ptr(), flags.data_ptr(), out.data_ptr(), lens.data_ptr(),
                batch, n, keep.shape[1], 1, stream,
            )
            if err != 0:
                raise RuntimeError(f"variant {name}: launch failed (cudaError {err})")

        out.fill_(float("nan"))
        lens.fill_(-1)
        run()
        torch.cuda.synchronize()
        exact = torch.equal(out, want) and torch.equal(lens, want_lens)
        if name in EXACT and not exact:
            raise AssertionError(f"variant {name} differs from the plain version")
        print(
            json.dumps(
                {
                    "variant": name,
                    "ms": time_ms(torch, run),
                    "ms_l2_flushed": time_ms(torch, run, flush=flush),
                    "profiled_ms": profile_call(torch, run)[1],
                    "registers": regs,
                    "spill_bytes": spill,
                    "exact": exact,
                }
            ),
            flush=True,
        )
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
