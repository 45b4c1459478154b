#!/usr/bin/env python3
"""Where the merge-loop kernel of the PyTorch/CUDA port spends its time,
whether ``chip_smoke.py``'s check of it catches a wrong kernel, and how it
compares with the designs it was chosen over, on one NVIDIA card.

    python3 scripts/linkage_ablation.py [--probe]

Builds ``csrc/linkage.cu`` (one thread-block cluster, one st.async exchange
between its blocks a step) as it is and changed per variant (a text substitution in a copy of the
source), ``scripts/linkage_grid.cu`` (the cooperative grid it replaced, three
grid barriers a step) and ``scripts/linkage_block.cu`` (the same loop in one
1024-thread block), with the port's nvcc flags into ``_build/ablation/``, all
at once. Each runs on the inputs of ``chip_smoke.py``'s clustering phase,
tight blobs and a chain, at T = 384 (128 chunks) and T = 1024 (400 chunks),
and on the main path's own embeddings (one request of ``chip_smoke.py``'s
full-width pipeline on its 59 s clip, T = 384), and is held to the plain
version as ``chip_smoke.py`` holds the kernel: rep, steps and the merge log
bit-equal. The variants:

  as_is         the kernel (must pass)
  cluster_8     8 blocks a cluster instead of 16 (must pass)
  threads_256   256 threads a block instead of 512 (must pass)
  threads_768   768 threads a block (must pass)
  threads_1024  1024 threads a block (must pass)
  d_global      the rows of D in global memory even where they fit in
                shared memory (must pass; the same kernel at T = 1024)
  barrier_cluster  the step's exchange as plain DSMEM stores and a cluster
                barrier (barrier.cluster.arrive.release / wait.acquire, every
                thread) instead of st.async counted on mbarriers (must pass)
  no_rescan     no row is scanned again after a merge: wrong
  no_distances  no distance from the new centroid is computed: wrong
  profile       the kernel printing each block's SM clocks a phase, summed
                over the steps (lines "linkage_profile ..." after the
                input's "profile_of" line), run once an input, not timed
  grid          scripts/linkage_grid.cu (must pass)
  block         scripts/linkage_block.cu (must pass)

The wrong ones show whether the check catches them (``caught``), and what
their part costs: they may run another number of steps, so their time a
step is what counts. Each input times every variant twice, in one order and
then in the reverse one (``ms``, ``ms_reverse``).

Then a probe: 4096 back-to-back barriers of one 1024-thread block
(``__syncthreads``), of a cooperative grid of one block an SM (``grid.sync()``,
256 and 1024 threads a block) and of one cluster of 8 and of 16 blocks
(``cluster.sync()``, 256 and 512 threads a block), the same clusters'
barrier on mbarriers (``__syncthreads``, one release arrival on each block's
mbarrier, an acquire wait), the step exchange of ``csrc/linkage.cu`` alone
(one 16-byte ``st.async`` from each block to each block, counted on the
receiver's mbarrier, an acquire wait), and 4096 dependent loads of one
thread from another block's shared memory over DSMEM (a cluster of 2 and of
16).

Prints one JSON line per input (its train rows and steps, the plain loop's
time on the card and the least time the bytes its steps read take, both as
``chip_smoke.py``'s clustering phase takes them), one per variant and input
(ms: device time per call, timed as ``chip_smoke.py`` times a kernel; steps
run; us a step; which fields differ from the plain version; registers and
spill bytes; the kernel's cluster size and shared memory a block), one for
the probe (us a barrier or a load), then the card's name and power limit as
nvidia-smi reports them.
``--probe`` builds everything but runs the probe alone.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLUSTER = "constexpr int kCluster = 16;"
THREADS = "constexpr int kThreads = 512;"
D_SHARED = "  p->d_shared = p->cent_shared && "
RESCAN = "      if (v != inf && (a == i || a == j)) {\n"
ROOT = "      const float r0 = __fsqrt_rn(acc0), r1 = __fsqrt_rn(acc1);\n"
TXSYNC = "constexpr bool kTxSync = true;"
PROFILE = "constexpr bool kProfile = false;"

VARIANTS = {
    "as_is": [],
    "cluster_8": [(CLUSTER, "constexpr int kCluster = 8;")],
    "threads_256": [(THREADS, "constexpr int kThreads = 256;")],
    "threads_768": [(THREADS, "constexpr int kThreads = 768;")],
    "threads_1024": [(THREADS, "constexpr int kThreads = 1024;")],
    "d_global": [(D_SHARED, "  p->d_shared = false && ")],
    "barrier_cluster": [(TXSYNC, "constexpr bool kTxSync = false;")],
    "no_rescan": [(RESCAN, "      if (false) {\n")],
    "no_distances": [(ROOT, "      const float r0 = inf, r1 = inf;\n")],
    "profile": [(PROFILE, "constexpr bool kProfile = true;")],
}
# the designs the cluster was measured against: the old interface, with the
# per-slot state scratch
OLD = {
    "grid": os.path.join(HERE, "scripts", "linkage_grid.cu"),
    "block": os.path.join(HERE, "scripts", "linkage_block.cu"),
}
MUST_PASS = (
    "as_is", "cluster_8", "threads_256", "threads_768", "threads_1024", "d_global",
    "barrier_cluster", "grid", "block", "profile",
)
OLD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
    ctypes.c_void_p
]
OLD_STATE_WORDS = 9

PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void block_barriers(int n, int* out) {
  for (int i = 0; i < n; ++i) __syncthreads();
  if (threadIdx.x == 0) out[0] = n;
}

__global__ void grid_barriers(int n, int* out) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = n;
}

__global__ void cluster_barriers(int n, int* out) {
  cg::cluster_group c = cg::this_cluster();
  for (int i = 0; i < n; ++i) c.sync();
  if (c.block_rank() == 0 && threadIdx.x == 0) out[0] = n;
}

// one thread follows a chain of n indices through the last block's shared memory
__global__ void dsmem_chase(int n, int* out) {
  __shared__ int ring[1024];
  cg::cluster_group c = cg::this_cluster();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) ring[i] = (i + 33) & 1023;
  c.sync();
  if (c.block_rank() == 0 && threadIdx.x == 0) {
    const int* remote = c.map_shared_rank(ring, c.num_blocks() - 1);
    int k = 0;
    for (int i = 0; i < n; ++i) k = remote[k];
    out[0] = k;
  }
  c.sync();
}

// the kernel's step barrier: __syncthreads, thread t arrives (release) on
// block t's mbarrier of this parity, every thread waits (acquire)
__global__ void mbarrier_barriers(int n, int* out) {
  __shared__ __align__(8) unsigned long long bars[2];
  cg::cluster_group c = cg::this_cluster();
  const int C = (int)c.num_blocks();
  const unsigned base = (unsigned)__cvta_generic_to_shared(bars);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(base), "r"(C) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(base + 8), "r"(C) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  c.sync();
  for (int u = 0; u < n; ++u) {
    const unsigned bar = base + 8 * (u & 1);
    __syncthreads();
    if ((int)threadIdx.x < C) {
      unsigned remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(bar), "r"((int)threadIdx.x));
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
    }
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(bar), "r"((u >> 1) & 1) : "memory");
  }
  if (c.block_rank() == 0 && threadIdx.x == 0) out[0] = n;
  c.sync();
}

// the kernel's step exchange: thread 0 expects C 16-byte candidates on this
// parity's mbarrier, lane t < C sends one to block t by st.async (complete_tx),
// every thread waits for them
__global__ void tx_exchanges(int n, int* out) {
  __shared__ __align__(16) unsigned long long box[2][16][2];
  __shared__ __align__(8) unsigned long long bars[2];
  cg::cluster_group c = cg::this_cluster();
  const int C = (int)c.num_blocks(), rank = (int)c.block_rank();
  const unsigned base = (unsigned)__cvta_generic_to_shared(bars);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(base), "r"(1) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(base + 8), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  c.sync();
  for (int u = 0; u < n; ++u) {
    const unsigned bar = base + 8 * (u & 1);
    if (threadIdx.x == 0)
      asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
                   ::"r"(bar), "r"(C * 16) : "memory");
    if ((int)threadIdx.x < C) {
      unsigned dst, rbar;
      const unsigned src = (unsigned)__cvta_generic_to_shared(&box[u & 1][rank][0]);
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(src), "r"((int)threadIdx.x));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(bar), "r"((int)threadIdx.x));
      const unsigned long long x = u;
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], {%1, %2}, [%3];"
                   ::"r"(dst), "l"(x), "l"(x), "r"(rbar) : "memory");
    }
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(bar), "r"((u >> 1) & 1) : "memory");
  }
  if (rank == 0 && threadIdx.x == 0) out[0] = (int)box[(n - 1) & 1][C - 1][0];
  c.sync();
}

extern "C" int probe_block(int n, void* out, void* stream) {
  block_barriers<<<1, 1024, 0, (cudaStream_t)stream>>>(n, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int probe_grid(int blocks, int threads, int n, void* out, void* stream) {
  void* args[] = {&n, &out};
  return (int)cudaLaunchCooperativeKernel((void*)grid_barriers, blocks, threads, args, 0,
                                          (cudaStream_t)stream);
}

// what: 0 cluster barriers, 1 DSMEM loads, 2 mbarrier step barriers, 3 st.async exchanges
extern "C" int probe_cluster(int what, int blocks, int threads, int n, void* out, void* stream) {
  void (*kernel)(int, int*) = what == 0   ? cluster_barriers
                              : what == 1 ? dsmem_chase
                              : what == 2 ? mbarrier_barriers
                                          : tx_exchanges;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, n, (int*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""


def build(src: str):
    """{name: (library, nvcc's -Xptxas -v report)}: every variant, the old
    designs and the probe, one nvcc each, all at once."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import _cuda_lib

    out_dir = os.path.join(str(_cuda_lib.BUILD_DIR), "ablation")
    os.makedirs(out_dir, exist_ok=True)
    sources = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: substitution site not found once")
            text = text.replace(old, new)
        sources[name] = text
    for name, path in OLD.items():
        with open(path) as f:
            sources[name] = f.read()
    sources["barrier_probe"] = PROBE
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"linkage_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"liblinkage_{name}.so")
        cmd = [_cuda_lib._nvcc(), *_cuda_lib.NVCC_FLAGS, "-o", so, cu]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            so,
        )
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = (ctypes.CDLL(so), log)
    return libs


def launcher(torch, name, lib, D0, embt, tvalid, thr, got, stream):
    """(run, plan): one launch of variant ``name`` on these inputs into
    ``got``, raising on a launch error, and its layout (None for the old
    designs)."""
    T, d = embt.shape
    flags = tvalid.view(torch.uint8)
    fn = lib.linkage_launch
    fn.restype = ctypes.c_int
    outs = [got.rep.data_ptr(), got.steps.data_ptr(), got.merges.data_ptr(), got.dists.data_ptr()]
    if name in OLD:
        fn.argtypes = OLD_ARGTYPES
        scratch = [
            torch.empty_like(D0),
            torch.empty_like(embt),
            torch.empty(OLD_STATE_WORDS * T, dtype=torch.int32, device="cuda"),
        ]
        plan = None
    else:
        from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda

        fn.argtypes = linkage_cuda.LAUNCH_ARGTYPES
        plan = linkage_cuda.linkage_plan(T, d, lib)
        scratch = [
            None if plan.d_shared else linkage_cuda.d_scratch(D0, lib),
            None if plan.cent_shared else torch.empty_like(embt),
        ]
    ptrs = [None if t is None else t.data_ptr() for t in scratch]

    def run():
        err = fn(
            D0.data_ptr(), embt.data_ptr(), flags.data_ptr(), *ptrs, *outs, T, d, thr, stream
        )
        if err != 0:
            raise RuntimeError(f"variant {name}: launch failed (cudaError {err})")

    run.scratch = scratch  # kept alive with the launcher
    return run, plan


def probe(torch, lib, stream, time_ms):
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = 4096
    lib.probe_block.restype = lib.probe_grid.restype = lib.probe_cluster.restype = ctypes.c_int
    lib.probe_block.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.probe_grid.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.probe_cluster.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def us(call):
        def fn():
            err = call()
            if err != 0:
                raise RuntimeError(f"probe launch failed (cudaError {err})")

        return time_ms(torch, fn) * 1e3 / n

    result = {"probe": "barriers and DSMEM loads", "count": n, "sms": sms}
    result["block_1024_us"] = us(lambda: lib.probe_block(n, out.data_ptr(), stream))
    for threads in (256, 1024):
        result[f"grid_{sms}x{threads}_us"] = us(
            lambda: lib.probe_grid(sms, threads, n, out.data_ptr(), stream)
        )
    for blocks in (8, 16):
        for threads in (256, 512):
            result[f"cluster_{blocks}x{threads}_us"] = us(
                lambda: lib.probe_cluster(0, blocks, threads, n, out.data_ptr(), stream)
            )
    for blocks in (8, 16):
        for threads in (256, 512):
            result[f"mbarrier_{blocks}x{threads}_us"] = us(
                lambda: lib.probe_cluster(2, blocks, threads, n, out.data_ptr(), stream)
            )
    for blocks in (8, 16):
        for threads in (256, 512):
            result[f"st_async_exchange_{blocks}x{threads}_us"] = us(
                lambda: lib.probe_cluster(3, blocks, threads, n, out.data_ptr(), stream)
            )
    for blocks in (2, 16):
        result[f"dsmem_load_cluster_{blocks}_us"] = us(
            lambda: lib.probe_cluster(1, blocks, 32, n, out.data_ptr(), stream)
        )
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("linkage_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from chip_smoke import (
        NOISE,
        blob_embeddings,
        bound_ms,
        linkage_instance,
        nvidia_smi_line,
        ptxas_report,
        synth_clip,
        time_ms,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import device as devclu
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda

    src_path = os.path.join(
        HERE, "pyannote_audio_speaker_diarization_cpp_tpu_torch", "csrc", "linkage.cu"
    )
    with open(src_path) as f:
        libs = build(f.read())
    stream = torch.cuda.current_stream().cuda_stream
    report = [ln.strip() for ln in libs["as_is"][1].splitlines() if "ptxas info" in ln]
    print(json.dumps({"ptxas_as_is": report}), flush=True)
    if "--probe" in sys.argv[1:]:
        print(json.dumps(probe(torch, libs["barrier_probe"][0], stream, time_ms)), flush=True)
        print(nvidia_smi_line(), flush=True)
        return 0
    cfg = ClusteringConfig()

    def inputs():
        """(input, chunks, (R, d) float32 rows, (R,) valid) on the card."""
        for kind, chunks in (("blobs", 128), ("chain", 128), ("blobs", 400), ("chain", 400)):
            emb3, nanmask = blob_embeddings(chunks, seed=chunks, noise=NOISE[kind])
            flat = np.nan_to_num(emb3.reshape(-1, emb3.shape[-1])).astype(np.float32)
            yield kind, chunks, torch.from_numpy(flat).cuda(), torch.from_numpy(
                ~nanmask.reshape(-1)
            ).cuda()
        from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
            SpeakerDiarizationPipeline,
            precision_scope,
        )

        pipe = SpeakerDiarizationPipeline(seed=0)
        with precision_scope(pipe.precision):
            pending = pipe._dispatch(synth_clip(59.0, seed=0, quantize=False))
        yield "main", pending["num_padded"], pending["emb"].float(), ~pending["too_short"]

    names = (*VARIANTS, *OLD)
    libc = ctypes.CDLL(None)
    for kind, chunks, flat, valid in inputs():
        embt, tvalid, _, live = devclu.train_rows(flat, valid, cfg.max_num_embeddings)
        T = embt.shape[0]
        D0 = devclu.initial_distances(embt, tvalid)
        want = linkage_cuda.linkage_labels_plain(D0, embt, tvalid, cfg.threshold)
        # the plain loop's time and the bytes bound, as chip_smoke.py's
        # clustering phase takes them: each step reads the live slots'
        # centroids, a row of D and the row minima
        steps, d = int(want.steps), embt.shape[1]
        nbytes = 4.0 * sum((int(live) - s) * d + 2 * T for s in range(steps))
        plain_ms = time_ms(
            torch, lambda: linkage_cuda.linkage_labels_plain(D0, embt, tvalid, cfg.threshold),
            reps=3, warmup=1, queued=False,
        )
        print(json.dumps({"input": kind, "T": T, "train_rows": int(live), "steps": steps,
                          "plain_ms": plain_ms, "bound_ms_bytes": bound_ms(nbytes, {})[0]}),
              flush=True)
        rows = {}
        print(json.dumps({"profile_of": kind, "T": T}), flush=True)
        for name in names:
            got = linkage_cuda.LinkageResult(
                rep=torch.empty(T, dtype=torch.int32, device="cuda"),
                steps=torch.empty(1, dtype=torch.int32, device="cuda"),
                merges=torch.empty((T - 1, 2), dtype=torch.int32, device="cuda"),
                dists=torch.empty(T - 1, dtype=torch.float32, device="cuda"),
            )
            lib, log = libs[name]
            run, plan = launcher(torch, name, lib, D0, embt, tvalid, cfg.threshold, got, stream)
            kernel = {"grid": "linkage_kernel", "block": "linkage_block_kernel"}.get(name)
            regs, spill = ptxas_report(log, kernel or linkage_instance(plan))
            run()
            torch.cuda.synchronize()
            if name == "profile":
                libc.fflush(None)  # the kernel's printf lines, before what follows
            differ = [f for f, a, b in zip(want._fields, got, want) if not torch.equal(a, b)]
            if differ and name in MUST_PASS:
                raise AssertionError(f"variant {name} ({kind}, T={T}) differs in {differ}")
            rows[name] = dict(
                variant=name,
                input=kind,
                T=T,
                chunks=int(chunks),
                steps=int(got.steps),
                registers=regs,
                spill_bytes=spill,
                plan=None if plan is None else plan._asdict(),
                differs_in=differ,
                caught=bool(differ),
                run=run,
            )
        timed = [n for n in names if n != "profile"]
        for key, order in (("ms", timed), ("ms_reverse", timed[::-1])):
            for name in order:
                rows[name][key] = time_ms(torch, rows[name]["run"])
        for name in timed:
            r = rows[name]
            del r["run"]
            r["us_per_step"] = r["ms"] * 1e3 / max(r["steps"], 1)
            r["us_per_step_reverse"] = r["ms_reverse"] * 1e3 / max(r["steps"], 1)
            print(json.dumps(r), flush=True)

    print(json.dumps(probe(torch, libs["barrier_probe"][0], stream, time_ms)), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
