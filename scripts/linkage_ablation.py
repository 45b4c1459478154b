#!/usr/bin/env python3
"""Where the merge-loop kernel of the PyTorch/CUDA port spends its time,
whether ``chip_smoke.py``'s check of it catches a wrong kernel, and how it
compares with the one-block design, on one NVIDIA card.

    python3 scripts/linkage_ablation.py

Builds ``csrc/linkage.cu`` (a cooperative grid, one block an SM, three grid
barriers a step) as it is and with one phase of ``linkage_kernel`` taken
out per variant (a text substitution in a copy of the source), and
``scripts/linkage_block.cu`` (the same loop in one 1024-thread block), with
the port's nvcc flags into ``_build/ablation/``, all at once. Each runs on
the inputs of ``chip_smoke.py``'s clustering phase, tight blobs and a
chain, at T = 384 (128 chunks) and T = 1024 (400 chunks), and on the main
path's own embeddings (one request of ``chip_smoke.py``'s full-width
pipeline on its 59 s clip, T = 384), and is held to the plain version as
``chip_smoke.py`` holds the kernel: rep, steps and the merge log bit-equal.
The variants:

  as_is         the kernel (must pass)
  no_rescan     no row is scanned again after a merge (phase 4): wrong
  no_distances  no distance from the new centroid is computed (phase 2): wrong
  block         linkage_block.cu (must pass)

The wrong ones show whether the check catches them (``caught``), and what
their phase costs: they may run another number of steps, so their time a
step is what counts.

Then a barrier probe: 4096 back-to-back barriers of one 1024-thread block
(``__syncthreads``), and of a cooperative grid of one block an SM
(``grid.sync()``, 256 and 1024 threads a block).

Prints one JSON line per variant and input (ms: device time per call, timed
as ``chip_smoke.py`` times a kernel; steps run; us a step; which fields
differ from the plain version; registers and spill bytes), one for the
probe (us a barrier), then the card's name and power limit as nvidia-smi
reports them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "as_is": [],
    "no_rescan": [
        ("      if (!__ldcg(flag + k)) continue;\n", "      if (k >= 0) continue;\n"),
        # a stale minimum can point at a row with no finite entry left: stop
        # there rather than index slot kNone
        (
            "    const int i = min(i0, j0), j = max(i0, j0);\n",
            "    if (j0 == kNone) break;\n    const int i = min(i0, j0), j = max(i0, j0);\n",
        ),
    ],
    "no_distances": [
        (
            "      if (k != i && k != j && __ldcg(alive + k)) {\n",
            "      if (k != i && k != j && __ldcg(alive + k) && d < 0) {\n",
        )
    ],
}
MUST_PASS = ("as_is", "block")
BLOCK_SOURCE = os.path.join(HERE, "scripts", "linkage_block.cu")

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

extern "C" int probe_block(int n, void* out, void* stream) {
  block_barriers<<<1, 1024, 0, (cudaStream_t)stream>>>(n, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int probe_grid(int blocks, int threads, int n, void* out, void* stream) {
  void* args[] = {&n, &out};
  return (int)cudaLaunchCooperativeKernel((void*)grid_barriers, blocks, threads, args, 0,
                                          (cudaStream_t)stream);
}
"""


def build(src: str):
    from chip_smoke import ptxas_report
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
        sources[f"linkage_{name}"] = text
    with open(BLOCK_SOURCE) as f:
        sources["linkage_block"] = f.read()
    sources["barrier_probe"] = PROBE
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
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
        kernel = "linkage_block_kernel" if name == "linkage_block" else "linkage_kernel"
        libs[name] = (ctypes.CDLL(so), *ptxas_report(log, kernel))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("linkage_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from chip_smoke import NOISE, blob_embeddings, nvidia_smi_line, synth_clip, time_ms
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import device as devclu
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda

    src_path = os.path.join(
        HERE, "pyannote_audio_speaker_diarization_cpp_tpu_torch", "csrc", "linkage.cu"
    )
    with open(src_path) as f:
        libs = build(f.read())
    stream = torch.cuda.current_stream().cuda_stream
    cfg = ClusteringConfig()
    state_words = libs["linkage_as_is"][0].linkage_state_words()

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

    for kind, chunks, flat, valid in inputs():
        d = flat.shape[-1]
        embt, tvalid, _, _ = devclu.train_rows(flat, valid, cfg.max_num_embeddings)
        T = embt.shape[0]
        D0 = devclu.initial_distances(embt, tvalid)
        want = linkage_cuda.linkage_labels_plain(D0, embt, tvalid, cfg.threshold)
        got = linkage_cuda.LinkageResult(
            rep=torch.empty(T, dtype=torch.int32, device="cuda"),
            steps=torch.empty(1, dtype=torch.int32, device="cuda"),
            merges=torch.empty((T - 1, 2), dtype=torch.int32, device="cuda"),
            dists=torch.empty(T - 1, dtype=torch.float32, device="cuda"),
        )
        D = torch.empty_like(D0)
        cent = torch.empty_like(embt)
        state = torch.empty(state_words * T, dtype=torch.int32, device="cuda")
        flags = tvalid.view(torch.uint8)
        for name in (*VARIANTS, "block"):
            lib, regs, spill = libs[f"linkage_{name}"]
            fn = lib.linkage_launch
            fn.restype = ctypes.c_int
            fn.argtypes = linkage_cuda.LAUNCH_ARGTYPES

            def run():
                err = fn(
                    D0.data_ptr(), embt.data_ptr(), flags.data_ptr(), D.data_ptr(),
                    cent.data_ptr(), state.data_ptr(), got.rep.data_ptr(), got.steps.data_ptr(),
                    got.merges.data_ptr(), got.dists.data_ptr(), T, d, cfg.threshold, stream,
                )
                if err != 0:
                    raise RuntimeError(f"variant {name}: launch failed (cudaError {err})")

            run()
            torch.cuda.synchronize()
            differ = [f for f, a, b in zip(want._fields, got, want) if not torch.equal(a, b)]
            if differ and name in MUST_PASS:
                raise AssertionError(f"variant {name} ({kind}, T={T}) differs in {differ}")
            ms = time_ms(torch, run)
            n = int(got.steps)
            print(
                json.dumps(
                    {
                        "variant": name,
                        "input": kind,
                        "T": T,
                        "chunks": chunks,
                        "ms": ms,
                        "steps": n,
                        "us_per_step": ms * 1e3 / max(n, 1),
                        "registers": regs,
                        "spill_bytes": spill,
                        "differs_in": differ,
                        "caught": bool(differ),
                    }
                ),
                flush=True,
            )

    probe = libs["barrier_probe"][0]
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = 4096
    probe.probe_block.restype = probe.probe_grid.restype = ctypes.c_int
    probe.probe_block.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    probe.probe_grid.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def check(err):
        if err != 0:
            raise RuntimeError(f"barrier probe launch failed (cudaError {err})")

    result = {"probe": "barriers", "barriers": n, "sms": sms}
    result["block_1024_us"] = (
        time_ms(torch, lambda: check(probe.probe_block(n, out.data_ptr(), stream))) * 1e3 / n
    )
    for threads in (256, 1024):
        result[f"grid_{sms}x{threads}_us"] = (
            time_ms(
                torch,
                lambda: check(probe.probe_grid(sms, threads, n, out.data_ptr(), stream)),
            )
            * 1e3
            / n
        )
    print(json.dumps(result), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
