#!/usr/bin/env python3
"""Where the two ASP kernels of the PyTorch/CUDA port spend their time, on
one NVIDIA card.

    python3 scripts/asp_cuda_ablation.py [--dtype bfloat16|float32|both]

Builds ``csrc/asp.cu`` as it is and with one part of a kernel taken out or
changed per variant (a text substitution in a copy of the source, built with
the port's nvcc flags into ``_build/ablation/``, all variants at once), and
times each at the kernel-phase shapes of ``chip_smoke.py``: x (32, 3072,
501), a_tanh (32, 128, 501) as the model lays it out, the same seeded inputs
and length masks (57.7 % of the frames valid). The variants that take a
part out compute wrong numbers on purpose; only their times count.

bfloat16 (asp_bf16_kernel):

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

float32 (asp_f32_kernel), each also held against the plain version at the
kernel's tolerance (mean rtol/atol 1e-5, std rtol 1e-4 / atol 1e-5):

  f32_as_is          the kernel; must meet the tolerance
  f32_fma            the port's first float32 kernel (scripts/asp_f32_fma.cu:
                     float32 FMAs, a_tanh and x staged in shared memory)
  f32_specialized    the other layout measured: a producer warpgroup loading
                     a_tanh and x into shared memory for two consumer
                     warpgroups (scripts/asp_f32_specialized.cu)
  f32_one_tf32       one TF32 product (w_big . a_big) instead of three; must
                     miss the tolerance
  f32_one_acc        the products of all of K in one accumulator, no fresh
                     accumulator a k16 (the tensor cores truncate as they add)
  f32_serial         each k16 waited for before the next is issued, one fresh
                     accumulator
  f32_no_product     the wgmma instructions removed
  f32_no_softmax     the softmax and its sums p, p x, p x^2 removed (x's loads
                     go with it)
  f32_no_x           x not loaded (zeros)
  f32_no_a           a_tanh not loaded (zeros; the split stores stay)
  f32_staging_only   the loads of x and a_tanh, the split stores and the
                     barriers left; no product, no softmax
  f32_a_after_loop   the share of the tile after next loaded after the
                     product, not among its k16 steps
  f32_x_in_loop4/8   x loaded among the first 4 / all 8 k16 steps, not at the
                     tile's start
  f32_rna_split      both halves rounded to nearest (ties away), as
                     cvt.rna.tf32.f32 rounds, by two integer instructions;
                     not truncated
  f32_cvt_rna        both halves rounded by cvt.rna.tf32.f32
  f32_profile        clock64 stamps around the phases (per block: mask walk,
                     prologue; per tile: x's loads, the k16 loop with the
                     next tiles' a_tanh, the loop's tail, the softmax, the
                     barrier), read back and printed as SM clocks a block
                     and a tile

Prints one JSON line per variant (ms: device time per call, timed as
``chip_smoke.py`` times a kernel, twice, in two orders; registers and spill
bytes from ptxas; float32: max abs error against the plain version and
whether it meets the tolerance), then the card's name and power limit as
nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FMA_SOURCE = os.path.join(HERE, "scripts", "asp_f32_fma.cu")

MMA = (
    "        mma_bf16(acc[2 * np], af, bf[0], bf[1]);\n"
    "        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);\n"
)
# the float32 kernel's product: three wgmma a k step, and their k16 loop
WGMMA = (
    "        wgmma_tf32(dd[i & 1], w_small[h], b_desc(big), h);         // w_small . a_big\n"
    "        wgmma_tf32(dd[i & 1], w_big[h], b_desc(big + kHalf), 1);   // w_big . a_small\n"
    "        wgmma_tf32(dd[i & 1], w_big[h], b_desc(big), 1);           // w_big . a_big\n"
)
LOAD_W = "      load_w(w_big, w_small, w_s, 16 * warp + g, q, i);\n"
K16_DRAIN = (
    "      if (i > 0) {  // k16 i - 1 is done: add it\n"
    "        wgmma_wait_one();\n"
    "        fence_regs(dd[(i - 1) & 1]);\n"
    "#pragma unroll\n"
    "        for (int e = 0; e < 32; ++e) acc[e] += dd[(i - 1) & 1][e];\n"
    "      }\n"
    "      if (i + 1 == kK16) {\n"
    "        wgmma_wait_all();\n"
    "        fence_regs(dd[i & 1]);\n"
    "#pragma unroll\n"
    "        for (int e = 0; e < 32; ++e) acc[e] += dd[i & 1][e];\n"
    "      }\n"
)
A_NEXT = "      load_a_k16(av[i], arow, lda, A, k_ld, t0 + 2 * kFrames + f_ld, t_end, i);\n"
AFTER_LOOP = "    fence_proxy_async();  // the next stage, for the wgmma after the barrier\n"
SOFTMAX = "    if (valid != 0ull) {  // the same for the whole block"
NO_SOFTMAX = [(SOFTMAX, "    if (false) {")]
X_TILE = (
    "#pragma unroll\n"
    "    for (int h = 0; h < 2; ++h)\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < 16; ++i) {\n"
    "        const int f = t0 + 8 * (i >> 1) + 2 * q + (i & 1);\n"
    "        xv[h][i] = xr[h] != nullptr && f < t_end ? __ldg(xr[h] + f) : 0.0f;\n"
    "      }\n"
)
X_LOAD = "        xv[h][i] = xr[h] != nullptr && f < t_end ? __ldg(xr[h] + f) : 0.0f;\n"
A_LOAD = "    v[j] = f < f_end && k < A ? __ldg(arow + (size_t)k * lda + f) : 0.0f;\n"
TILE_END = "    __syncthreads();  // the next stage is stored; no wgmma reads this one\n  }\n"
SPECIALIZED_SOURCE = os.path.join(HERE, "scripts", "asp_f32_specialized.cu")
# the split of a value into TF32 halves
BIG = "  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);\n"
SMALL_W = "      small[h][e] = __float_as_uint(v - hi);\n"
SMALL_A = "    big[kHalf] = v[j] - hi;\n"

# f32_profile: clock64 stamps around the float32 kernel's phases, summed over
# the first thread of each warpgroup into a device array read back by
# asp_prof_read
PROF_DEFS = (
    "__device__ unsigned long long g_prof[16];\n"
    "__device__ __forceinline__ unsigned long long prof_clock() {\n"
    "  unsigned long long c;\n"
    '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));\n'
    "  return c;\n"
    "}\n\n"
)
PROF_READ = (
    '\nextern "C" int asp_prof_read(unsigned long long* host) {\n'
    "  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));\n"
    "}\n"
    '\nextern "C" int asp_prof_reset() {\n'
    "  const unsigned long long zero[16] = {};\n"
    "  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));\n"
    "}\n"
)


def _stamp(slot, prev, name):
    return (f"    const unsigned long long {name} = prof_clock();\n"
            f"    pr[{slot}] += {name} - {prev};\n")


PROFILE = [
    ("__global__ void __launch_bounds__(kThreads16, 1)\nasp_f32_kernel(",
     PROF_DEFS + "__global__ void __launch_bounds__(kThreads16, 1)\nasp_f32_kernel("),
    ("  extern __shared__ __align__(128) float smem32[];\n",
     "  extern __shared__ __align__(128) float smem32[];\n"
     "  const unsigned long long pt0 = prof_clock();\n"
     "  unsigned long long pr[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"),
    ("  const int t_end = walk_end(mask + (size_t)b * Tn, 0, Tn, valid_s, last_s);\n",
     "  const int t_end = walk_end(mask + (size_t)b * Tn, 0, Tn, valid_s, last_s);\n"
     "  const unsigned long long pt1 = prof_clock();\n  pr[0] += pt1 - pt0;\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n\n",
     "  cp_async_wait_all();\n  __syncthreads();\n  pr[1] += prof_clock() - pt1;\n\n"),
    ("    float* next = b_s + (s ^ 1) * kStage32;\n",
     "    float* next = b_s + (s ^ 1) * kStage32;\n    const unsigned long long q0 = prof_clock();\n"),
    ("    // S (64 x 64 per warpgroup) = W . a_tanh", _stamp(2, "q0", "q1")
     + "    // S (64 x 64 per warpgroup) = W . a_tanh"),
    (AFTER_LOOP, _stamp(3, "q1", "q2") + AFTER_LOOP),
    (SOFTMAX, _stamp(4, "q2", "q3") + SOFTMAX),
    (TILE_END, _stamp(5, "q3", "q4") + "    __syncthreads();\n    pr[6] += prof_clock() - q4;\n"
     "  }\n  if (threadIdx.x % 128 == 0) {\n"
     "    for (int i = 0; i < 7; ++i) atomicAdd(&g_prof[i], pr[i]);\n"
     "    atomicAdd(&g_prof[11], 1ull);\n"
     "    atomicAdd(&g_prof[12], (unsigned long long)((t_end + kFrames - 1) / kFrames));\n  }\n"),
]
# (slot, phase, per): "block" divides by the warpgroups, "tile" by their tiles
PROF_SLOTS = (
    (0, "mask_walk", "block"),
    (1, "prologue", "block"),
    (2, "x_loads", "tile"),
    (3, "k16_loop", "tile"),
    (4, "loop_tail", "tile"),
    (5, "softmax", "tile"),
    (6, "barrier", "tile"),
)



def x_in_loop(k16s):
    """x's loads among the first k16s steps of the loop, 32 / k16s a step."""
    per = 32 // k16s
    return [
        (X_TILE, ""),
        (
            A_NEXT,
            A_NEXT
            + f"      if (i < {k16s}) {{\n#pragma unroll\n"
            + f"        for (int u = {per} * i; u < {per} * (i + 1); ++u) {{\n"
            + "          const int f = t0 + 8 * ((u & 15) >> 1) + 2 * q + (u & 1);\n"
            + "          xv[u >> 4][u & 15] =\n"
            + "              xr[u >> 4] != nullptr && f < t_end ? __ldg(xr[u >> 4] + f) : 0.0f;\n"
            + "        }\n      }\n"
        ),
    ]


# name -> (dtype, substitutions in csrc/asp.cu, or the path of a source of
# its own)
VARIANTS = {
    "as_is": ("bfloat16", []),
    "no_mma": ("bfloat16", [(MMA, "")]),
    "no_product": (
        "bfloat16",
        [("for (int k0 = 0; k0 < Kp; k0 += 16) {", "for (int k0 = 0; k0 < 0; k0 += 16) {")],
    ),
    "no_softmax": (
        "bfloat16",
        [
            (
                "for (int n = 0; n < kFrames / 8; ++n) {\n        const uint32_t xw",
                "for (int n = 0; n < 0; ++n) {\n        const uint32_t xw",
            )
        ],
    ),
    "staging_only": ("bfloat16", [("if (valid == 0ull) continue;", "continue;")]),
    "no_stop": ("bfloat16", [("  return t_end + 1;", "  return Tn;")]),
    "compute_only": (
        "bfloat16",
        [
            (
                "      copy_tile(next, xr, ab, lda, nx, A, Kp, Tn, r0, tid, t0 + kFrames, t_end);\n",
                "",
            )
        ],
    ),
    "f32_as_is": ("float32", []),
    "f32_fma": ("float32", FMA_SOURCE),
    "f32_specialized": ("float32", SPECIALIZED_SOURCE),
    "f32_one_tf32": (
        "float32",
        [(WGMMA, "        wgmma_tf32(dd[i & 1], w_big[h], b_desc(big), h);\n")],
    ),
    "f32_one_acc": (
        "float32",
        [
            (WGMMA, WGMMA.replace("dd[i & 1]", "acc").replace("big), h);", "big), i + h);")),
            (K16_DRAIN, ""),
            (AFTER_LOOP, "    wgmma_wait_all();\n    fence_regs(acc);\n" + AFTER_LOOP),
        ],
    ),
    "f32_serial": (
        "float32",
        [
            (WGMMA, WGMMA.replace("dd[i & 1]", "dd[0]")),
            (
                K16_DRAIN,
                "      wgmma_wait_all();\n      fence_regs(dd[0]);\n#pragma unroll\n"
                "      for (int e = 0; e < 32; ++e) acc[e] += dd[0][e];\n",
            ),
        ],
    ),
    "f32_no_product": ("float32", [(WGMMA, "")]),
    "f32_no_softmax": ("float32", NO_SOFTMAX),
    "f32_no_x": ("float32", [(X_LOAD, "        xv[h][i] = 0.0f;\n")]),
    "f32_no_a": ("float32", [(A_LOAD, "    v[j] = 0.0f;\n")]),
    "f32_staging_only": (
        "float32",
        [(WGMMA, ""), (LOAD_W, "")] + NO_SOFTMAX,
    ),
    "f32_a_after_loop": (
        "float32",
        [
            (A_NEXT, ""),
            (AFTER_LOOP, "#pragma unroll\n    for (int i = 0; i < kK16; ++i)\n  " + A_NEXT + AFTER_LOOP),
        ],
    ),
    "f32_x_in_loop4": ("float32", x_in_loop(4)),
    "f32_x_in_loop8": ("float32", x_in_loop(8)),
    "f32_rna_split": (
        "float32",
        [
            (BIG, "  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);\n"),
            (SMALL_W, "      small[h][e] = __float_as_uint(tf32_big(v - hi));\n"),
            (SMALL_A, "    big[kHalf] = tf32_big(v[j] - hi);\n"),
        ],
    ),
    "f32_cvt_rna": (
        "float32",
        [
            (
                BIG,
                '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));\n'
                "  return __uint_as_float(r);\n",
            ),
            (SMALL_W, "      small[h][e] = __float_as_uint(tf32_big(v - hi));\n"),
            (SMALL_A, "    big[kHalf] = tf32_big(v[j] - hi);\n"),
        ],
    ),
    "f32_profile": ("float32", PROFILE),
}

TOL = dict(mean=(1e-5, 1e-5), std=(1e-4, 1e-5))


def ptxas(log: str, kernel: str):
    """(registers, spill store bytes) of ``kernel`` in nvcc's -Xptxas -v log."""
    chunk = next(c for c in log.split("Compiling entry function")[1:]
                 if kernel in c.split("\n", 1)[0])
    regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
    spill = int(re.search(r"(\d+) bytes spill stores", chunk).group(1))
    return regs, spill


def build(names, src: str):
    """Build the named variants, one nvcc each, all at once: name -> (CDLL,
    registers, spill bytes)."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import _cuda_lib

    out_dir = os.path.join(str(_cuda_lib.BUILD_DIR), "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        dtype, subs = VARIANTS[name]
        if isinstance(subs, str):
            cu = subs
        else:
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: substitution site not found once")
                text = text.replace(old, new)
            if subs is PROFILE:
                text += PROF_READ
            cu = os.path.join(out_dir, f"asp_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
        so = os.path.join(out_dir, f"libasp_{name}.so")
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
        kernel = {"bfloat16": "asp_bf16_kernel", "float32": "asp_f32_kernel"}[VARIANTS[name][0]]
        if VARIANTS[name][1] == FMA_SOURCE:
            kernel = "asp_fma_kernel"
        libs[name] = (ctypes.CDLL(so), *ptxas(log, kernel))
    return libs


def fma_launcher(lib):
    """The port's first float32 kernel as fn(x, a_tanh, w, bias, mask, mean,
    std, stream): W transposed and a_tanh made contiguous outside the
    timing, as its wrapper did."""
    fn = lib.asp_fma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=("bfloat16", "float32", "both"), default="both")
    args = parser.parse_args()
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
        src = f.read()
    names = [n for n, (dt, _) in VARIANTS.items() if args.dtype in ("both", dt)]
    libs = build(names, src)

    # the inputs of chip_smoke.py's ASP phase (its seed, after the pack and
    # log-mel draws)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, C, A, T = 32, 3072, 128, 501
    rng.normal(size=(B, 80000))
    rng.uniform(size=(B, 293 // 8 + 1))
    x32 = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32)).to(dev)
    attn = torch.from_numpy(rng.normal(size=(B, A, T)).astype(np.float32)).to(dev)
    bound_w = 1.0 / np.sqrt(A)
    w32 = torch.from_numpy(rng.uniform(-bound_w, bound_w, (C, A)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-bound_w, bound_w, C).astype(np.float32)).to(dev)
    lens = rng.uniform(0.05, 1.0, B)
    lens[::4] = 1.0
    mask = torch.from_numpy((np.arange(T)[None, :] < (lens * T)[:, None]).astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {}
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        x, w = x32.to(tdt), w32.to(tdt)
        a = asp_cuda.attention_tanh(attn.to(tdt))  # as the model lays it out
        mean = torch.empty((B, C), dtype=tdt, device=dev)
        inputs[dtype] = (x, a, w, mean, torch.empty_like(mean))
    want = asp_cuda.asp_pool_plain(x32, inputs["float32"][1], w32, bias, mask)
    wt, a_contig = w32.t().contiguous(), inputs["float32"][1].contiguous()

    runs = {}
    for name in names:
        lib = libs[name][0]
        dtype, subs = VARIANTS[name]
        x, a, w, mean, std = inputs[dtype]
        if subs == FMA_SOURCE:
            fn = fma_launcher(lib)
            call = (x.data_ptr(), a_contig.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                    mask.data_ptr(), mean.data_ptr(), std.data_ptr(), B, C, A, T, 1e-12, stream)
        elif dtype == "float32":
            fn = lib.asp_pool_f32_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
            call = (x.data_ptr(), a.data_ptr(), a.stride(1), w.data_ptr(), bias.data_ptr(),
                    mask.data_ptr(), mean.data_ptr(), std.data_ptr(), B, C, A, T, 1e-12, stream)
        else:
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
            call = (x.data_ptr(), a.data_ptr(), a.stride(1), w.data_ptr(), bias.data_ptr(), 0,
                    mask.data_ptr(), 0, mean.data_ptr(), std.data_ptr(), B, C, A, T, 1e-12,
                    stream)

        def run(fn=fn, call=call, name=name):
            err = fn(*call)
            if err != 0:
                raise RuntimeError(f"variant {name}: launch failed (cudaError {err})")

        runs[name] = run

    ms = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            ms[name].append(time_ms(torch, runs[name]))
    for name in names:
        _, regs, spill = libs[name]
        line = {"variant": name, "ms": ms[name], "registers": regs, "spill_bytes": spill}
        if VARIANTS[name][1] is PROFILE:
            lib = libs[name][0]
            prof = (ctypes.c_ulonglong * 16)()
            if lib.asp_prof_reset() != 0:
                raise RuntimeError("f32_profile: reset failed")
            runs[name]()
            torch.cuda.synchronize()
            if lib.asp_prof_read(prof) != 0:
                raise RuntimeError("f32_profile: read failed")
            per = {"block": prof[11], "tile": prof[12], "producer_tile": prof[14]}
            line["clocks"] = {
                f"{name} (a {unit})": prof[slot] / max(per[unit], 1)
                for slot, name, unit in PROF_SLOTS
            }
            line["tiles_per_block"] = prof[12] / max(prof[11], 1)
        if VARIANTS[name][0] == "float32":
            _, _, _, mean, std = inputs["float32"]
            runs[name]()
            torch.cuda.synchronize()
            err = max(float((mean - want[0]).abs().max()), float((std - want[1]).abs().max()))
            ok = bool(
                torch.isclose(mean, want[0], rtol=TOL["mean"][0], atol=TOL["mean"][1]).all()
                and torch.isclose(std, want[1], rtol=TOL["std"][0], atol=TOL["std"][1]).all()
            )
            line.update(max_abs_err=err, within_tolerance=ok)
            if name in ("f32_as_is", "f32_fma") and not ok:
                raise AssertionError(f"{name} misses the tolerance (max abs {err})")
            if name == "f32_one_tf32" and ok:
                raise AssertionError("one TF32 product met the tolerance: the check has no teeth")
        print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
