#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a JSON line on stdout:
  1. device: the card (as nvidia-smi reports its name and power limit),
     torch/CUDA versions, and the wall time of building the CUDA kernels
     from csrc/ (one nvcc per source, all started together) and the native
     host library (runtime/native, g++);
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the main path gives it (a 32-row stage-2 batch
     of 5 s windows), with its device time (ms; call_ms adds the host's
     enqueue of one call on an idle card), the plain version's time and
     the least time the card could take for the same work; for pack also
     its time with the L2 cache flushed before each call, and the device
     kernels one call runs with their run time under torch.profiler; for
     pack, log-mel and both ASP kernels their registers and spills (log-mel
     and ASP: blocks an SM), for log-mel its distance from a float64
     log-mel beside the plain version's, and for float32 ASP its bound in
     3xTF32 with its bound on the float32 FMA units beside it;
  3. clustering: the merge-loop kernel (csrc/linkage.cu, the whole loop in
     one launch of one thread-block cluster) against its plain version on
     the card and on the CPU, on embeddings around 5 centres (d = 192, 10 %
     invalid): tight blobs and a chain (noise 0.3 of the centres' scale:
     hundreds of merges whose order matters), at T = 384 (128 chunks, the main path's size) and T = 1024
     (400 and 1536 chunks): rep, steps and the merge log (each step's pair
     and distance) must be bit-equal; then the whole device_cluster on the
     card against the CPU (num_large and partition equal) and, on blobs,
     the host clusterer; kernel ms, plain ms, us a step, the byte bound,
     the cluster size, shared memory a block and which state it holds,
     registers and spills;
  4. parity: a small-model pipeline (real 5 s / 0.5 s recipe) run with the
     same weights on the card and on the CPU, in float32 with TF32 off:
     embeddings must agree, stage 3 must take the device route on both with
     equal clusters, and the turns must be equal; then both again with
     device_clustering=False (the host route): turns equal between card and
     CPU and to the device route's;
  5. default_numerics: the same pipeline with the in-repo gate checkpoint
     at the port's defaults on the card, against the CPU in float32
     (embeddings within abs 0.02) and at the defaults (equal turns);
  6. requests: the main path at full model width (default PyanNet and
     ECAPA-TDNN, default config: bf16 ECAPA trunk, f16 transfer), seeded
     random weights, three requests on a synthetic 59 s clip; pack, log-mel
     and the bf16 ASP kernel must launch 12 times per request (128 padded
     chunks x 3 speakers / 32), the float32 ASP kernel never, the linkage
     kernel once, and stage 3 must stay on the device (no embedding fetch);
     one request with ``profile`` True (the dispatch waits for stages 1
     and 2, the only waits lifted from sync debug mode "error"): the warm
     request's turns and launches, the host spans segmentation, embedding
     and fetch each > 0 and total their sum, printed beside the stages'
     device ms; one with ``profile`` False again under "error",
     ``embedding`` 0.0;
     one request with max_speakers must take the host route (one embedding
     fetch, no linkage launch);
     one more request with the pack and ASP inputs watched (pack_rows: kept
     share, segments a row, empty rows; asp_frames: the share of frames
     valid and walked) and its float16 activations checked; then one more
     under torch.profiler (device time by kernel, the port's own kernels by
     name);
  7. float32_requests: the same model at full width with compute_dtype and
     transfer_dtype float32 at precision "highest" (the parity mode): a
     warm-up and two timed 59 s requests, each launching the float32 ASP
     kernel 12 times and the bf16 one never, stage 3 on the device; one
     more with its ASP inputs watched (finite embeddings, the kernel held
     against its plain version on one batch's real inputs, its profiled time
     there beside the FMA kernel's, built from scripts/asp_f32_fma.cu), and
     one more under torch.profiler (the kernel's device time in a request);
  8. entry_points: a fresh full-width pipeline's warmup(60) (seconds,
     buckets, the first request's wall after it), after which every
     dispatch runs under sync debug mode "error" (as in phases 6 and 7
     after their first request; the watched request there must count no
     host wait); map of four clips (59, 30, 12.3 and 59 s) with turns equal
     to sequential calls, its wall beside their sum (four rounds in
     turns), peak memory and a profiled map's idle share; run_chunks and
     stage2_internals against the request's embeddings (within abs 0.02)
     and the plain pack (equal);
     SegmentationPipeline and EmbeddingPipeline once each; the CLI in a
     subprocess, its turns equal to the in-process turns for the same
     weights (saved as an .npz directory under a temporary directory); and
     small5s run_with_dumps on the card against the CPU (all 39 names);
  9. layouts: one full-width pipeline per ECAPA layout ("nch", "nhc",
     "gemm"): a first request, then two under sync debug mode "error"
     (launches as in phase 6, device ms by stage), turns equal to the
     "nch" pipeline's; stage 2 alone and one 32-row trunk batch timed and
     profiled on a request's own inputs (stage 2's top kernels); the MFA
     and a tdnn1 1x1 conv alone in each layout's form (ms, TFLOP/s, the
     kernel it gets); in "nhc" the bf16 ASP kernel against its plain
     version on a request's inputs, beside the ms of the (B, T, C) ->
     (B, C, T) copy of x it takes; small5s float32 (TF32 off) in "nhc" and
     "gemm", card against CPU (embeddings rtol 1e-3 / atol 1e-4, turns);
 10. ingest: the seeded full-width models written as a pyannote Lightning
     .bin, a speechbrain savedir and an .npz tree with a baked filterbank;
     load_params_auto of each (host s; the arrays equal the source's), one
     request each on pipelines built from them, turns equal to the
     source's;
 11. streaming: pipelines/streaming.py at full width on the host route
     (the 59 s clip in 0.5 s blocks, emit_every 8, recluster_every 4):
     the flush equal to the same pipeline's offline request and
     partition-equivalent to a default device-route request, the native
     linkage run in the flush (327 train rows), launches 3 a 32-chunk
     range; feed ms by whether it reclustered, flush ms, the padded share,
     the stream's scores and embeddings against one run_chunks of the
     whole clip; a 300 s clip in 1 s blocks under the doubling schedule
     (flush equal to offline); small5s with the gate checkpoint in float32
     on a 30 s silence-gapped clip, every emission on the card equal to the
     CPU's and the frozen prefix engaged; the spectral clusterer at full
     width (no linkage launch) and small5s card against CPU; the native
     linkage against scipy at the main path's N, 1000 and 2000 (host ms,
     with the host's CPU model);
 12. longform: parallel/longform.py at full width on the synthetic clip
     extended to 600 s (1191 chunks): LongFormDiarizer(num_shards=4)
     against the single-shot request, both with stage 3 on the device
     (merge loop at T = 1024, the fused stage 3 engaged: no host clusterer
     call), in the parity mode (turns equal, embeddings at rtol 1e-3 /
     atol 1e-4) and at the defaults (embeddings within abs 0.02, turn
     equality printed), a default run on the first 120 s under
     torch.profiler (busy ms, idle share, top kernels); the parity mode
     card against CPU on 20 s; then
     3600 s (7191 chunks) with 8 shards and the window of 3 against the
     single-shot request (host route): walls, audio-s/s, peak device
     memory, launches, T. Every long-form run after the first runs under
     sync debug mode "error" but for its fetches, which are counted;
 13. multirank: the pipeline's mesh= at full width on the 59 s clip: one
     NCCL rank on the card equal to the mesh-less pipeline (strings,
     embeddings, launches), all_gather_embeddings under sync debug mode
     "error" and timed; then two gloo ranks spawned on cuda:0 (NCCL
     refuses two ranks on one card) running parallel/dryrun.py's three
     cases, in the parity mode and at the defaults, each rank launching
     half of a request's stage-2 batches; a failed rank fails the run;
 14. server: runtime/server.py serving the default pipeline on an
     ephemeral port: /diarize of the 59 s clip (JSON and RTTM) equal to a
     direct call, three serial requests (client and server walls, launches
     as phase 6's), four concurrent requests each equal to its serial
     answer, a float32 "highest" service whose concurrent requests equal
     its serial ones (turns and embeddings: threads share
     precision_scope), an HTTP stream equal to StreamingDiarizer fed
     directly, and the error answers (404, 413, 400, 429, health counts);
 15. server_mesh: runtime/server.py over a mesh (--mesh): one NCCL rank,
     the default pipeline behind MeshControl beside the mesh-less service,
     /diarize JSON and RTTM equal string for string, launches as phase
     6's, each mesh dispatch and broadcast under sync debug mode "error",
     walls in turns and four concurrent requests against their serial sum;
     then two gloo ranks spawned on cuda:0, float32 "highest": served turns
     equal a one-rank call's, an HTTP stream of 1 s feeds equal to
     StreamingDiarizer fed directly (close == flush), four concurrent
     requests with the stream equal serial ones, half of a request's
     stage-2 batches on each rank, stop ending both with exit 0;
 16. training: PIT-BCE on the default PyanNet (32 x 80 000) and
     AAM-softmax on the default ECAPA-TDNN (32 x 300 x 80, 7205 classes),
     TF32 off: card against CPU (loss, gradients), ms a step, the float32
     ASP kernel once a forward with its autograd backward against the
     plain version's, every trunk parameter's gradient, the BatchNorm
     statistics moved; deterministic resume bit-equal; the data-parallel
     step (NCCL world 1; two gloo ranks on cuda:0) equal to one process;
 17. accuracy_loop: the JAX package's closed accuracy loop
     (tests/test_accuracy_loop.py) on the card, through
     tests/_torch_accuracy.py: PyanNet and ECAPA-TDNN at small widths
     trained from their seeded inits on synthetic two-speaker tones
     (PIT-BCE to a loss target, 150 AAM-softmax steps; deterministic
     algorithms, so every run takes one trajectory), then the tiny1s
     pipeline with those weights diarizing a composed 12 s conversation:
     every JAX threshold must hold (PyanNet loss < 0.12, within > across +
     0.05, DER < 0.25 with num_speakers=2, exactly 2 speakers); steps to
     target, losses, separation, DER, labels, wall seconds of each part
     (the host's making of the training batches apart), launches of each
     part (log-mel and float32 ASP in training; pack, log-mel and bf16 ASP
     in the diarization) and the card; one request without a bound (stage
     3 on the device) reported only;
 18. sinc_conv: the SincNet conv's polyphase and strided forms on one
     (32, 80 000) batch, TF32 off and on: device ms, the largest
     difference between the forms and from the CPU, the bound;
 19. each phase's host wall seconds; the kernel summary line (launches:
     float32 ASP's from phase 7, the others' from phase 6, each plus
     phases 8-17's, the spawned ranks' included), the nvidia-smi line, and
     last {"ok": true, "device": {...}}.

Any failed check raises: the script then exits non-zero before the last
line. It imports nothing of JAX, and fails without a CUDA device or
without the package beside it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 494.7e12, "bfloat16": 989e12}

BATCH, WINDOW, FRAMES = 32, 80000, 293


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


# a device spin of about 2 ms at the H100's clocks: longer than the host
# takes to enqueue any call timed here
SLEEP_CYCLES = 4_000_000


def time_ms(
    torch, fn, reps: int = 20, warmup: int = 3, queued: bool = True, flush=None
) -> float:
    """Median of ``reps`` CUDA-event timings of one fn() call each, after
    ``warmup`` calls. ``queued``: the events and the call are enqueued behind
    a device spin, so they time the device alone; else the device is idle
    when the start event runs, and the time includes the host's enqueue of
    the call (wrapper and launch). ``flush``: a device buffer larger than the
    L2 cache, read before each timed call (outside the timing), so the call
    finds its inputs in device memory and the L2 full of clean lines; else
    nothing is flushed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        if flush is not None:
            flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: dict):
    """(least ms, what bounds it): bytes over the memory rate vs operations,
    each part ({type: flops}) over the peak rate of its operands' type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[dtype] for dtype, f in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(torch, got, want, rtol, atol) -> bool:
    return bool(torch.isclose(got.float(), want.float(), rtol=rtol, atol=atol).all())


def walk_ends(torch, valid):
    """Per row of a (rows, T) bool mask: one past its last valid frame (0 if
    none), the end of the bf16 ASP kernel's walk over T."""
    idx = torch.arange(1, valid.shape[1] + 1, device=valid.device)
    return (valid * idx).amax(dim=1)


def ptxas_report(log: str, kernel: str):
    """(registers, spill store bytes) of one kernel in nvcc's -Xptxas -v log."""
    for chunk in log.split("Compiling entry function")[1:]:
        if kernel in chunk.split("\n", 1)[0]:
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            return (int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None)
    return None, None


def pack_inputs(torch, rng, dev):
    """The kernel phase's pack inputs: 32 windows of normal noise and keep
    masks of 8-frame speech runs, kept with probability 0, 0.3, 0.7, 1 by
    row (49.5 % of the samples at seed 0)."""
    wav = torch.from_numpy(rng.normal(size=(BATCH, WINDOW)).astype(np.float32)).to(dev)
    p_keep = np.array([0.0, 0.3, 0.7, 1.0] * (BATCH // 4))[:, None]
    runs = np.repeat(rng.uniform(size=(BATCH, FRAMES // 8 + 1)), 8, axis=1)[:, :FRAMES]
    return wav, torch.from_numpy(runs < p_keep).to(dev)


def segments_per_row(torch, keep):
    """Maximal runs of kept frames in each row of a (rows, F) bool mask."""
    starts = keep.clone()
    starts[:, 1:] &= ~keep[:, :-1]
    return starts.sum(dim=1)


def pack_bound_bytes(batch: int, n: int, frames: int, kept: float) -> float:
    """Traffic the pack needs: the kept samples read, every output written,
    the keep flags (one byte each) read and the lengths written."""
    return 4.0 * (batch * n + kept) + batch * frames + 4.0 * batch


def l2_flush_buffer(torch):
    """A device buffer of twice the L2 cache, for ``time_ms(flush=...)``."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return torch.zeros(2 * l2 // 4, dtype=torch.float32, device="cuda")


def is_marker(event) -> bool:
    """A device event of ``torch.cuda._sleep``'s kernel (the markers that
    ``traced`` and ``profile_sections`` launch)."""
    return "spin_kernel" in event.name


def traced(torch, fn, markers: int = 0):
    """(fn(), the device events torch.profiler traced from fn's start on:
    kernels, copies and memsets, in the order they ran). ``markers``: the
    marker kernels (``torch.cuda._sleep``) fn launches itself. On the card
    a session has dropped every device event of its first tens to hundreds
    of milliseconds (in one, nothing before 57 ms was traced; in another,
    nothing before its last 0.1 s section), so fn runs after a lead-in: a
    host sleep, then a marker kernel. The trace must hold all markers, the
    lead-in's first, else the session runs again with twice the sleep (0.25
    s, then up to 4 s). The events are cut at that marker in the device's
    own order: device and host timestamps were found milliseconds apart."""
    from torch.profiler import ProfilerActivity, profile

    lead_s = 0.25
    while True:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(lead_s)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        device = sorted(device_events(prof.events()), key=lambda e: e.time_range.start)
        found = [i for i, e in enumerate(device) if is_marker(e)]
        if len(found) == markers + 1:
            return out, device[found[0] + 1 :]
        check(lead_s < 4.0, "profile: the trace never held every marker kernel")
        lead_s *= 2


def device_events(events):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA]


def profile_call(torch, fn, reps: int = 10):
    """(device kernels and copies a fn() call runs, their device ms a call),
    from ``reps`` warm calls under torch.profiler: the kernels' own run time,
    without the launch and event latency that a CUDA-event timing includes."""
    fn()
    torch.cuda.synchronize()
    _, device = traced(torch, lambda: [fn() for _ in range(reps)])
    busy = sum(e.time_range.end - e.time_range.start for e in device) / 1e3
    return len(device) / reps, busy / reps


def kernel_phase(torch):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import FrontendConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import (
        _cuda_lib,
        asp_cuda,
        frontend as fe,
        frontend_cuda,
        pack_cuda,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {}
    flush = l2_flush_buffer(torch)

    # --- pack: 32 windows, keep masks of speech runs (p_keep cycling) ------
    wav, keep = pack_inputs(torch, rng, dev)
    packed_k, lens_k = pack_cuda.pack_frames(wav, keep)
    packed_p, lens_p = pack_cuda.pack_frames_plain(wav, keep)
    torch.cuda.synchronize()
    exact = torch.equal(packed_k, packed_p) and torch.equal(lens_k, lens_p)
    err = float((packed_k - packed_p).abs().max())
    check(exact, f"pack kernel differs from its plain version (max abs {err})")
    # a bool keep goes to the kernel as its bytes: one device kernel a call
    per_call, profiled_ms = profile_call(torch, lambda: pack_cuda.pack_frames(wav, keep))
    check(per_call == 1, f"pack_frames ran {per_call} device kernels for a bool keep")
    kept = float(lens_p.sum())
    nbytes = pack_bound_bytes(BATCH, WINDOW, FRAMES, kept)
    b, by = bound_ms(nbytes, {})
    regs, spill = ptxas_report(_cuda_lib.build_log("pack"), "pack_kernelILb1E")
    results["pack_frames"] = dict(
        max_abs_err=err,
        tolerance="bit-exact",
        kept_share=kept / (BATCH * WINDOW),
        segments_per_row=float(segments_per_row(torch, keep).float().mean()),
        device_kernels_per_call=per_call,
        registers=regs,
        spill_bytes=spill,
        bound_bytes=nbytes,
        ms=time_ms(torch, lambda: pack_cuda.pack_frames(wav, keep)),
        ms_l2_flushed=time_ms(torch, lambda: pack_cuda.pack_frames(wav, keep), flush=flush),
        profiled_ms=profiled_ms,
        call_ms=time_ms(torch, lambda: pack_cuda.pack_frames(wav, keep), queued=False),
        plain_ms=time_ms(torch, lambda: pack_cuda.pack_frames_plain(wav, keep)),
        bound_ms=b,
        bound_by=by,
        shapes="wav (32, 80000) f32, keep (32, 293) bool -> (32, 80000) f32, (32,) i32",
    )

    # --- log-mel on the packed signals -------------------------------------
    cfg = FrontendConfig()
    basis, mel = fe.constants(cfg, dev)
    mult, db_off = fe._db_terms(cfg)
    args = (packed_k, basis, mel, cfg.hop_length, float(cfg.amin), mult, db_off)
    out_k = frontend_cuda.log_mel_spectrogram(*args)
    out_p = frontend_cuda.log_mel_spectrogram_plain(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(
        within(torch, out_k, out_p, 1e-4, 1e-3),
        f"log-mel kernel differs from its plain version (max abs {err})",
    )
    # float32-accurate: no further from a float64 log-mel than the plain
    # version, give or take 2e-3 dB
    ref = frontend_cuda.log_mel_spectrogram_plain(
        packed_k.double(),
        torch.from_numpy(fe.dft_basis(cfg.n_fft, cfg.win_length)).to(dev),
        torch.from_numpy(fe.mel_filterbank(cfg)).to(dev),
        *args[3:],
    )
    err64 = float((out_k.double() - ref).abs().max())
    err64_plain = float((out_p.double() - ref).abs().max())
    check(
        err64 <= err64_plain + 2e-3,
        f"log-mel kernel is {err64} dB from float64, the plain version {err64_plain}",
    )
    frames = out_k.shape[1]
    win, ncol = basis.shape
    # the DFT product as three TF32 products (3xTF32); the mel projection
    # over each band's own bins (the filterbank's nonzeros), in float32
    flops = {
        "tfloat32": 3 * 2.0 * BATCH * frames * win * ncol,
        "float32": 2.0 * BATCH * frames * float((mel != 0).sum()),
    }
    nbytes = 4.0 * (BATCH * WINDOW + BATCH * frames * mel.shape[1] + basis.numel() + mel.numel())
    b, by = bound_ms(nbytes, flops)
    regs, spill = ptxas_report(_cuda_lib.build_log("frontend"), "log_mel_kernel")
    blocks = ctypes.c_int(0)
    occupancy = _cuda_lib.library("frontend").log_mel_blocks_per_sm
    occupancy.restype = ctypes.c_int
    occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    ksteps = frontend_cuda.kernel_ksteps(win)
    _cuda_lib.check(
        "frontend", occupancy(cfg.hop_length, ksteps, mel.shape[1], ctypes.byref(blocks))
    )
    results["log_mel"] = dict(
        max_abs_err=err,
        tolerance="rtol 1e-4, atol 1e-3 (dB); float64 error <= plain's + 2e-3 dB",
        f64_err=err64,
        f64_err_plain=err64_plain,
        registers=regs,
        spill_bytes=spill,
        blocks_per_sm=blocks.value,
        bound_bytes=nbytes,
        bound_flops=flops,
        ms=time_ms(torch, lambda: frontend_cuda.log_mel_spectrogram(*args)),
        call_ms=time_ms(torch, lambda: frontend_cuda.log_mel_spectrogram(*args), queued=False),
        plain_ms=time_ms(torch, lambda: frontend_cuda.log_mel_spectrogram_plain(*args)),
        bound_ms=b,
        bound_by=by,
        shapes=f"x (32, 80000) f32 -> (32, {frames}, 80) f32",
    )

    # --- ASP tail: x (32, 3072, 501), attention (32, 128, 501) --------------
    C, A, T = 3072, 128, frames
    x32 = torch.from_numpy(rng.normal(size=(BATCH, C, T)).astype(np.float32)).to(dev)
    attn32 = torch.from_numpy(rng.normal(size=(BATCH, A, T)).astype(np.float32)).to(dev)
    bound_w = 1.0 / np.sqrt(A)
    w32 = torch.from_numpy(rng.uniform(-bound_w, bound_w, (C, A)).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(rng.uniform(-bound_w, bound_w, C).astype(np.float32)).to(dev)
    lens = rng.uniform(0.05, 1.0, BATCH)
    lens[::4] = 1.0
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < (lens * T)[:, None]).astype(np.float32)
    ).to(dev)
    for dtype, tol in (
        ("float32", dict(mean=(1e-5, 1e-5), std=(1e-4, 1e-5))),
        # both sides compute in float32 from the same bf16 inputs and round
        # once to bf16: they may differ by one bf16 rounding step (2^-8)
        ("bfloat16", dict(mean=(8e-3, 1e-4), std=(8e-3, 1e-4))),
    ):
        tdt = getattr(torch, dtype)
        # a_tanh laid out as the model lays it out for this dtype
        x, a, w = x32.to(tdt), asp_cuda.attention_tanh(attn32.to(tdt)), w32.to(tdt)
        mk_, sk = asp_cuda.asp_pool(x, a, w, b32, mask)
        mp, sp = asp_cuda.asp_pool_plain(x, a, w, b32, mask)
        torch.cuda.synchronize()
        err = max(float((mk_.float() - mp.float()).abs().max()),
                  float((sk.float() - sp.float()).abs().max()))
        check(
            within(torch, mk_, mp, *tol["mean"]) and within(torch, sk, sp, *tol["std"]),
            f"ASP kernel ({dtype}) differs from its plain version (max abs {err})",
        )
        # frames outside the mask get p = 0: only the valid frames of x and
        # a_tanh are needed, and only their scores; W, bias and the mask are
        # read once and mean and std written once
        valid = float((mask > 0).sum())
        size = x.element_size()
        nbytes = size * (valid * (C + A) + C * A + 2 * BATCH * C) + 4.0 * (C + BATCH * T)
        flops = 2.0 * C * A * valid
        # float32: the product as three TF32 products (3xTF32); its bound on
        # the float32 FMA units printed beside it
        b, by = bound_ms(nbytes, {"tfloat32": 3 * flops} if dtype == "float32" else {dtype: flops})
        results[f"asp_pool_{dtype}"] = dict(
            max_abs_err=err,
            tolerance=f"mean rtol/atol {tol['mean']}, std rtol/atol {tol['std']}",
            valid_share=valid / (BATCH * T),
            bound_bytes=nbytes,
            bound_flops=flops,
            ms=time_ms(torch, lambda: asp_cuda.asp_pool(x, a, w, b32, mask)),
            call_ms=time_ms(torch, lambda: asp_cuda.asp_pool(x, a, w, b32, mask), queued=False),
            plain_ms=time_ms(torch, lambda: asp_cuda.asp_pool_plain(x, a, w, b32, mask)),
            bound_ms=b,
            bound_by=by,
            shapes=f"x (32, 3072, {T}) {dtype}, a_tanh (32, 128, {T}) -> 2 x (32, 3072)",
        )
    r = results["asp_pool_float32"]
    r["bound_ms_fma"], _ = bound_ms(0.0, {"float32": r["bound_flops"]})
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    # each kernel's registers and spills (nvcc -Xptxas -v) and occupancy
    lib = _cuda_lib.library("asp")
    for dtype, kernel, occupancy, args in (
        ("bfloat16", "asp_bf16_kernel", lib.asp_bf16_blocks_per_sm, (A, T)),
        ("float32", "asp_f32_kernel", lib.asp_f32_blocks_per_sm, (T,)),
    ):
        regs, spill = ptxas_report(_cuda_lib.build_log("asp"), kernel)
        blocks = ctypes.c_int(0)
        occupancy.restype = ctypes.c_int
        occupancy.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
        _cuda_lib.check("asp", occupancy(*args, ctypes.byref(blocks)))
        results[f"asp_pool_{dtype}"].update(
            registers=regs, spill_bytes=spill, blocks_per_sm=blocks.value
        )
    for name, r in results.items():
        emit({"kernel": name, **r})
    return results


def linkage_instance(plan) -> str:
    """The mangled name's part that marks the linkage kernel's template
    instance for a launch's layout: linkage_kernel<cent_shared, d_shared>."""
    return f"linkage_kernelILb{int(plan.cent_shared)}ELb{int(plan.d_shared)}E"


def partitions_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """The same partition up to a label bijection; -2 rows exactly equal."""
    if not np.array_equal(a < 0, b < 0):
        return False
    fwd = {}
    for x, y in zip(a[a >= 0], b[a >= 0]):
        if fwd.setdefault(x, y) != y:
            return False
    return len(set(fwd.values())) == len(fwd)


# noise to add to centres of scale 4: tight blobs, or a long chain of
# accepted merges whose order matters (0.3 of the centres' scale)
NOISE = {"blobs": 0.05, "chain": 1.2}


def blob_embeddings(
    num_chunks: int, seed: int, dim: int = 192, centres: int = 5, noise: float = 0.05
):
    """(num_chunks, 3, dim) float64 embeddings around ``centres`` separated
    centres, f16-rounded as the pipeline transfers them, with 10 % of the
    rows invalid (NaN), and the (num_chunks, 3) invalid mask."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, dim)) * 4
    emb = c[rng.integers(0, centres, size=(num_chunks, 3))]
    emb = emb + noise * rng.normal(size=(num_chunks, 3, dim))
    emb = emb.astype(np.float16).astype(np.float64)
    nanmask = rng.random((num_chunks, 3)) < 0.1
    emb[nanmask] = np.nan
    return emb, nanmask


def clustering_phase(torch):
    """The linkage kernel against its plain version at the main path's
    merge-loop size (128 chunks: T = 384) and at the capped size (400 and
    1536 chunks: T = 1024), on tight blobs and on a chain input (many
    merges whose order matters), then the whole device_cluster on the card
    against the CPU, and on blobs against the host clusterer too."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import device as devclu
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.base import (
        AgglomerativeClustering,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import _cuda_lib, linkage_cuda

    cfg = ClusteringConfig()
    thr = cfg.threshold
    log = _cuda_lib.build_log("linkage")
    results = {}
    for kind, chunks in (("blobs", 128), ("chain", 128), ("blobs", 400), ("chain", 400),
                         ("blobs", 1536)):
        emb3, nanmask = blob_embeddings(chunks, seed=chunks, noise=NOISE[kind])
        d = emb3.shape[-1]
        flat = torch.from_numpy(np.nan_to_num(emb3.reshape(-1, d)).astype(np.float32)).cuda()
        valid = torch.from_numpy(~nanmask.reshape(-1)).cuda()
        embt, tvalid, _, K = devclu.train_rows(flat, valid, cfg.max_num_embeddings)
        T = embt.shape[0]
        D0 = devclu.initial_distances(embt, tvalid)
        got = linkage_cuda.linkage_labels(D0, embt, tvalid, thr)
        plain = linkage_cuda.linkage_labels_plain(D0, embt, tvalid, thr)
        cpu = linkage_cuda.linkage_labels_plain(D0.cpu(), embt.cpu(), tvalid.cpu(), thr)
        torch.cuda.synchronize()
        name = f"{kind} T={T} ({chunks} chunks)"
        # the same first distances, then every number rounded in one order:
        # rep, the steps and the merge log (each step's pair and distance)
        # equal bit for bit on the card and on the CPU
        for field, k, p, c in zip(plain._fields, got, plain, cpu):
            check(
                torch.equal(k, p) and torch.equal(k.cpu(), c),
                f"linkage {name}: the kernel's {field} differs from the plain version's",
            )
        steps = int(got.steps)
        merged = int((got.merges[:, 0] >= 0).sum())
        check(merged >= steps - 1, f"linkage {name}: {merged} merges in {steps} steps")
        # the whole stage: card (kernel) vs CPU (plain loop), and on blobs the
        # host clusterer
        card = devclu.device_cluster(flat, valid, ~valid, thr, cfg.min_cluster_size, 8)
        on_cpu = devclu.device_cluster(
            flat.cpu(), valid.cpu(), ~valid.cpu(), thr, cfg.min_cluster_size, 8
        )
        ch = card.hard.cpu().numpy()
        check(
            int(card.num_large) == int(on_cpu.num_large)
            and partitions_equal(ch, on_cpu.hard.numpy()),
            f"device_cluster {name}: num_large {int(card.num_large)} (cpu "
            f"{int(on_cpu.num_large)}) or partition differs from the CPU's",
        )
        if kind == "blobs":
            host, _ = AgglomerativeClustering(cfg)(emb3)
            host = np.asarray(host).reshape(-1)
            host[nanmask.reshape(-1)] = -2
            check(
                int(card.num_large) == int(host.max()) + 1 and partitions_equal(ch, host),
                f"device_cluster {name}: differs from the host clusterer "
                f"(num_large {int(card.num_large)}, host {int(host.max()) + 1})",
            )
        # the launch's layout, and the registers and spills of the kernel's
        # instantiation for it (centroids, rows of D in shared memory or not)
        plan = linkage_cuda.linkage_plan(T, d)
        regs, spill = ptxas_report(log, linkage_instance(plan))
        ms = time_ms(torch, lambda: linkage_cuda.linkage_labels(D0, embt, tvalid, thr))
        plain_ms = time_ms(
            torch, lambda: linkage_cuda.linkage_labels_plain(D0, embt, tvalid, thr),
            reps=3, warmup=1, queued=False,
        )
        # each step reads the live slots' centroids (d floats each: the live
        # count falls by one a merge), a row of D and the row minima
        live = int(K)
        nbytes = 4.0 * sum((live - s) * d + 2 * T for s in range(steps))
        b, by = bound_ms(nbytes, {})
        key = f"{kind}_T{T}_chunks{chunks}"
        results[key] = dict(
            T=T,
            d=d,
            train_rows=live,
            steps=steps,
            merges=merged,
            accepted_bins=len(set(got.rep.cpu().tolist()) - set(range(T))),
            tolerance="bit-exact: rep, steps, merge pairs and distances",
            max_abs_err=float((got.rep - plain.rep).abs().max()),
            num_large=int(card.num_large),
            ms=ms,
            us_per_step=ms * 1e3 / max(steps, 1),
            plain_ms=plain_ms,
            bound_ms=b,
            bound_by=by,
            bound_bytes=nbytes,
            cluster_blocks=plan.cluster,
            smem_bytes_per_block=plan.smem_bytes,
            centroids_in_smem=plan.cent_shared,
            rows_of_D_in_smem=plan.d_shared,
            registers=regs,
            spill_bytes=spill,
        )
        emit({"clustering": f"linkage kernel, {name}", **results[key]})
    return results


def synth_clip(seconds: float, seed: int, quantize: bool) -> np.ndarray:
    sr = 16000
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    if not quantize:  # the bench's 59 s fallback clip
        x = 0.1 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.normal(size=t.shape)
        return x.astype(np.float32)
    x = (
        0.30 * np.sin(2 * np.pi * 220.0 * t)
        + 0.20 * np.sin(2 * np.pi * 1100.0 * t * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t)))
        + 0.05 * rng.standard_normal(t.shape)
    )
    q = np.clip(np.round(x * 20000.0), -32768, 32767).astype(np.int16)
    return q.astype(np.float32) / 32768.0


def turns_of(annotation):
    return [(t.start, t.end, t.label) for t in annotation.turns()]


def same_turns(a, b) -> bool:
    if len(a) != len(b):
        return False
    mapping = {}
    for (s1, e1, l1), (s2, e2, l2) in zip(a, b):
        if s1 != s2 or e1 != e2 or mapping.setdefault(l1, l2) != l2:
            return False
    return len(set(mapping.values())) == len(mapping)


def strict_dispatch(torch, pipe):
    """From here on every dispatch of ``pipe`` (``_dispatch``, and
    ``_run_range`` behind run_chunks and stage2_internals) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host wait for the card
    while a request is launched raises. Returns ``pipe``."""
    for name in ("_dispatch", "_run_range"):

        def strict(*args, _launch=getattr(pipe, name), **kwargs):
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _launch(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(previous)

        setattr(pipe, name, strict)
    return pipe


def small5s_pipeline(
    device: str,
    float32: bool,
    params=None,
    device_clustering="auto",
    ecapa_layout="nch",
    clusterer="ahc",
):
    """The small5s test configuration (the real 5 s / 0.5 s recipe, small
    model widths, seed 0): float32 compute and transfer at precision
    "highest" (TF32 off), or the defaults; the ECAPA trunk in
    ``ecapa_layout``."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    cfg = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)
    if float32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32", transfer_dtype="float32")
    return SpeakerDiarizationPipeline(
        cfg,
        params=params,
        seed=0,
        seg_batch=4,
        emb_batch=4,
        precision="highest" if float32 else "default",
        pyannet_cfg=PyanNetConfig(
            num_filters=32, conv_channels=16, lstm_hidden=16, lstm_layers=2, linear_hidden=16
        ),
        ecapa_cfg=EcapaConfig(
            channels=(64, 64, 64, 64, 128), attention_channels=16, se_channels=16, emb_dim=32
        ),
        device=device,
        device_clustering=device_clustering,
        ecapa_layout=ecapa_layout,
        clusterer=clusterer,
    )


def run_small5s(
    device: str, float32: bool, params=None, device_clustering="auto", ecapa_layout="nch"
):
    """One request of the small5s test configuration (the real 5 s / 0.5 s
    recipe, small model widths) on the 12.3 s int16 clip: float32 compute
    and transfer at precision "highest" (TF32 off), or the defaults (bf16
    ECAPA trunk, f16 transfer, precision "default"). ``params``: a
    checkpoint tree, else seeded random weights. ``device_clustering``:
    "auto" must take the device stage 3, False the host route. Returns its
    embeddings, too_short flags, segmentations (on the CPU), the device
    stage 3's clusters (None on the host route) and turns."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        precision_scope,
    )

    pipe = small5s_pipeline(device, float32, params, device_clustering, ecapa_layout)
    clip = synth_clip(12.3, seed=977, quantize=True)
    with precision_scope(pipe.precision):
        pending = pipe._dispatch(clip)
    dc = pending["device_clu"]
    route = "device" if device_clustering else "host"
    check(
        (dc is not None) == bool(device_clustering),
        f"small5s on {device}: stage 3 did not take the {route} route",
    )
    return dict(
        emb=pending["emb"].float().cpu(),
        too_short=pending["too_short"].cpu(),
        segs=pending["segmentations"].cpu(),
        hard=None if dc is None else dc["hard"].cpu().numpy(),
        num_large=None if dc is None else int(dc["num_large"]),
        turns=turns_of(pipe(clip)),
    )


def parity_phase(torch):
    out = {device: run_small5s(device, float32=True) for device in ("cuda", "cpu")}
    g, c = out["cuda"], out["cpu"]
    valid = ~c["too_short"]
    emb_err = float((g["emb"][valid] - c["emb"][valid]).abs().max())
    seg_err = float((g["segs"] - c["segs"]).abs().max())
    check(torch.equal(g["too_short"], c["too_short"]), "parity: too_short differs")
    check(
        within(torch, g["emb"][valid], c["emb"][valid], 1e-3, 1e-4),
        f"parity: embeddings differ (max abs {emb_err})",
    )
    # stage 3 on the device: the linkage kernel on the card, the plain loop
    # on the CPU
    check(
        g["num_large"] == c["num_large"] and partitions_equal(g["hard"], c["hard"]),
        "parity: device stage 3 clusters differ between cuda and cpu",
    )
    check(same_turns(g["turns"], c["turns"]), "parity: turns differ between cuda and cpu")
    # the host route (device_clustering=False; also bounds, too many rows,
    # or num_large 0 or above k_max): the embeddings fetched, the host
    # clusterer, post_cluster on the card
    host = {
        device: run_small5s(device, float32=True, device_clustering=False)
        for device in ("cuda", "cpu")
    }
    check(
        same_turns(host["cuda"]["turns"], host["cpu"]["turns"]),
        "parity: host-route turns differ between cuda and cpu",
    )
    check(
        same_turns(host["cuda"]["turns"], g["turns"]),
        "parity: host-route turns differ from the device route's",
    )
    emit(
        {
            "parity": "small5s cuda vs cpu, float32, TF32 off, device stage 3 on both",
            "clip_s": 12.3,
            "emb_max_abs_err": emb_err,
            "seg_max_abs_err": seg_err,
            "embedding_rows": int(valid.sum()),
            "num_large": g["num_large"],
            "clusters_equal": True,
            "turns": len(c["turns"]),
            "turns_equal": True,
            "host_route_turns_equal_cpu_and_device_route": True,
        }
    )


# the reference envelope: embedding abs 0.02 against the float32 run
ENVELOPE = 0.02


def default_numerics_phase(torch):
    """small5s with the in-repo gate checkpoint at the port's defaults on the
    card (stage 1 runs TF32 cuDNN kernels there), against the port on the
    CPU in float32 (embeddings within the envelope) and at the defaults
    (equal turns)."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import load_checkpoint

    params = load_checkpoint(os.path.join(HERE, "tests", "goldens", "gate_ckpt"))
    card = run_small5s("cuda", float32=False, params=params)
    cpu_default = run_small5s("cpu", float32=False, params=params)
    cpu_f32 = run_small5s("cpu", float32=True, params=params)
    check(
        torch.equal(card["too_short"], cpu_f32["too_short"])
        and torch.equal(cpu_default["too_short"], cpu_f32["too_short"]),
        "default numerics: too_short differs",
    )
    valid = ~cpu_f32["too_short"]
    check(bool(valid.any()), "default numerics: no embedding rows")
    err_f32 = float((card["emb"][valid] - cpu_f32["emb"][valid]).abs().max())
    err_default = float((card["emb"][valid] - cpu_default["emb"][valid]).abs().max())
    check(
        err_f32 <= ENVELOPE,
        f"default numerics: embeddings {err_f32} from the CPU float32 run (> {ENVELOPE})",
    )
    check(
        same_turns(card["turns"], cpu_default["turns"]),
        "default numerics: turns differ from the CPU default run's",
    )
    emit(
        {
            "default_numerics": "small5s gate checkpoint, cuda defaults vs cpu",
            "clip_s": 12.3,
            "emb_max_abs_err_vs_cpu_float32": err_f32,
            "envelope": ENVELOPE,
            "emb_max_abs_err_vs_cpu_default": err_default,
            "seg_max_abs_err_vs_cpu_float32": float(
                (card["segs"] - cpu_f32["segs"]).abs().max()
            ),
            "embedding_rows": int(valid.sum()),
            "turns": len(card["turns"]),
            "turns_equal_cpu_default": True,
        }
    )


def main_path_phase(torch, counters):
    """``counters``: name -> (wrapper, attribute holding its kernel's launch
    count, launches a request must make or None for one per stage-2
    batch)."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import diarization
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    # the host clustering route is the only caller of finalize_embeddings:
    # counting its calls shows whether the embeddings left the card
    real_finalize, host_route = diarization.finalize_embeddings, []

    def counted_finalize(*args, **kwargs):
        host_route.append(1)
        return real_finalize(*args, **kwargs)

    diarization.finalize_embeddings = counted_finalize
    pipe = SpeakerDiarizationPipeline(seed=0)  # default config, full widths, cuda
    seg = pipe.config.segmentation
    clip = synth_clip(59.0, seed=0, quantize=False)
    padded = pipe.chunk_lattice(chunk_count(len(clip), seg.window_size, seg.step_size))
    batches = padded * seg.num_speakers // pipe.emb_batch
    expected = {
        name: batches if per_request is None else per_request
        for name, (_, _, per_request) in counters.items()
    }

    def count():
        return {name: getattr(fn, attr) for name, (fn, attr, _) in counters.items()}

    for fn, attr, _ in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        if i == 1:  # after the warm-up request
            strict_dispatch(torch, pipe)
        before = count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        annotation = pipe(clip)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {name: n - before[name] for name, n in count().items()}
        check(
            launched == expected,
            f"main path: launches {launched}, expected {expected} per request",
        )
        check(not host_route, "main path: the embeddings were fetched for host clustering")
        t = pipe.timings
        emit(
            {
                "request": i,
                "warmup": i == 0,
                "audio_s": len(clip) / seg.sample_rate,
                "wall_ms": wall_ms,
                "audio_s_per_s": len(clip) / seg.sample_rate / (wall_ms / 1e3),
                "host_s": {
                    "segmentation": t.segmentation,
                    "fetch": t.fetch,
                    "clustering": t.clustering,
                },
                "device_ms": {
                    "stage1": t.stage1_ms,
                    "stage2": t.stage2_ms,
                    "stage3": t.stage3_ms,
                    "post": t.post_ms,
                },
                "stage3_route": "device",
                "padded_chunks": padded,
                "turns": len(annotation.turns()),
                "speakers": len(annotation.labels),
                "launches": launched,
                "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            }
        )
    profiled_request(pipe, clip, turns_of(annotation), count, expected)
    totals = count()
    # one request with a speaker bound: the host route at full width (the
    # embeddings fetched, the host clusterer, post_cluster on the card), no
    # linkage launch
    before = count()
    t0 = time.perf_counter()
    annotation = pipe(clip, max_speakers=pipe.k_max)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {name: n - before[name] for name, n in count().items()}
    check(
        launched == dict(expected, linkage=0),
        f"host-route request: launches {launched}",
    )
    check(len(host_route) == 1, "host-route request: the embeddings were not fetched")
    check(len(annotation.labels) >= 1, "host-route request: no speaker")
    t = pipe.timings
    emit(
        {
            "request": "host route (max_speakers)",
            "wall_ms": wall_ms,
            "host_s": {"fetch": t.fetch, "clustering": t.clustering},
            "device_ms": {"post": t.post_ms},
            "stage3_route": "host",
            "turns": len(annotation.turns()),
            "speakers": len(annotation.labels),
            "launches": launched,
        }
    )
    diarization.finalize_embeddings = real_finalize
    # outputs: finite embeddings of the expected shape (one more, uncounted
    # run), and the pack and ASP inputs that run passes
    pending = watched_request(torch, pipe, clip)
    dc = pending["device_clu"]
    check(dc is not None, "main path: stage 3 did not take the device route")
    act = dc["activations"]
    check(
        act.dtype == torch.float16
        and tuple(act.shape) == (pipe._diarization_plan(padded).num_frames, pipe.k_max)
        and bool(torch.isfinite(act).all()),
        f"main path: activations {act.dtype} {tuple(act.shape)}",
    )
    check(1 <= int(dc["num_large"]) <= pipe.k_max, "main path: num_large out of range")
    emb = pending["emb"].float()
    rows = pending["num_chunks"] * seg.num_speakers
    check(
        tuple(emb.shape) == (padded * seg.num_speakers, pipe.ecapa_cfg.emb_dim),
        f"main path: embedding shape {tuple(emb.shape)}",
    )
    check(
        bool(torch.isfinite(emb[:rows][~pending["too_short"][:rows]]).all()),
        "main path: non-finite embeddings",
    )
    profile_request(torch, pipe, clip)
    return totals, batches


def profiled_request(pipe, clip, warm_turns, count, expected):
    """One request with ``pipe.profile`` True (the dispatch waits for the
    card after stages 1 and 2: the only host waits it makes by design,
    lifted from the strict mode ``pipe`` runs under), then one with it
    False again. Both must launch ``expected`` and give ``warm_turns``; the
    profiled one must have every host span > 0 and ``total`` their sum, the
    next one ``embedding`` 0.0."""
    rows = []
    for profile in (True, False):
        pipe.profile = profile
        before = count()
        t0 = time.perf_counter()
        try:
            annotation = pipe(clip)
        finally:
            pipe.profile = False
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {name: n - before[name] for name, n in count().items()}
        t = pipe.timings
        spans = [t.segmentation, t.embedding, t.fetch, t.clustering]
        check(launched == expected, f"profile={profile}: launches {launched}")
        check(turns_of(annotation) == warm_turns, f"profile={profile}: turns differ")
        if profile:
            check(
                min(spans[:3]) > 0 and t.total == sum(spans),
                f"profiled request: host spans {spans}, total {t.total}",
            )
        else:
            check(t.embedding == 0.0, f"profile off: a stale embedding span {t.embedding}")
        rows.append(
            {
                "profile": profile,
                "strict": True,
                "wall_ms": wall_ms,
                "host_s": dict(
                    zip(("segmentation", "embedding", "fetch", "clustering"), spans),
                    total=t.total,
                ),
                "device_ms": {
                    "stage1": t.stage1_ms,
                    "stage2": t.stage2_ms,
                    "stage3": t.stage3_ms,
                },
                "turns_equal_warm": True,
                "launches": launched,
            }
        )
    emit({"profiled_request": rows})


def watched_request(torch, pipe, clip):
    """Dispatch one request with the pack and ASP calls watched. Emits the
    pack rows' kept share, segments and empty rows (and the byte bound of a
    pack call at that share), then the share of the ASP frames that are
    valid and the share the bf16 kernel walks (each row up to its last valid
    frame, in 64-frame tiles). Returns the pending outputs."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ecapa
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import masks as mk

    real_asp, real_pack, masks, keeps, lens = ecapa.asp_pool, mk.pack_frames, [], [], []

    def watched_asp(x, a_tanh, w, bias, mask, eps=1e-12):
        masks.append(mask > 0)
        return real_asp(x, a_tanh, w, bias, mask, eps)

    def watched_pack(waveforms, keep):
        packed, row_lens = real_pack(waveforms, keep)
        keeps.append(keep != 0)
        lens.append(row_lens)
        return packed, row_lens

    # host waits for the card while the request is enqueued, counted by
    # PyTorch's sync debug mode in "warn" (the dispatch itself, not the
    # strict wrapper): all of them, and those inside stage 3; there must be
    # none
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import diarization

    real_stage3, in_stage3 = diarization.stage3, []

    def watched_stage3(*args, **kwargs):
        in_stage3.append(len(caught))
        out = real_stage3(*args, **kwargs)
        in_stage3.append(len(caught))
        return out

    ecapa.asp_pool, mk.pack_frames = watched_asp, watched_pack
    diarization.stage3 = watched_stage3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pending = type(pipe)._dispatch(pipe, clip)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            ecapa.asp_pool, mk.pack_frames = real_asp, real_pack
            diarization.stage3 = real_stage3
    torch.cuda.synchronize()
    def sync_lines(ws):
        # the waits themselves, not the mode's one-time prototype notice
        return [
            str(w.message).splitlines()[0]
            for w in ws
            if "called a synchronizing" in str(w.message)
        ]

    check(len(in_stage3) == 2, "watched request: stage 3 did not run on the device")
    syncs = sync_lines(caught)
    emit(
        {
            "dispatch_syncs": "host waits for the card while one 59 s request is enqueued",
            "count": len(syncs),
            "in_stage3": len(sync_lines(caught[in_stage3[0] : in_stage3[1]])),
            "first": syncs[:3],
        }
    )
    check(not syncs, f"watched request: {len(syncs)} host waits in the dispatch")
    keep, row_lens = torch.cat(keeps), torch.cat(lens)
    rows, frames = keep.shape
    n = pipe.config.segmentation.window_size
    kept = float(row_lens.sum())
    segments = segments_per_row(torch, keep)
    batch = rows // len(keeps)
    bound, _ = bound_ms(pack_bound_bytes(batch, n, frames, kept / len(keeps)), {})
    emit(
        {
            "pack_rows": "main path, one 59 s request (uncounted run)",
            "calls": len(keeps),
            "rows": rows,
            "frames": frames,
            "samples": n,
            "kept_share": kept / (rows * n),
            "segments_per_row": float(segments.float().mean()),
            "segments_per_row_max": int(segments.max()),
            "empty_rows": int((row_lens == 0).sum()),
            "bound_ms_per_call": bound,
        }
    )
    valid = torch.cat(masks)
    rows, T = valid.shape
    ends = walk_ends(torch, valid)
    tile = 64
    emit(
        {
            "asp_frames": "main path, one 59 s request (uncounted run)",
            "calls": len(masks),
            "rows": rows,
            "frames": T,
            "valid_share": float(valid.sum()) / (rows * T),
            "walked_share": float(ends.sum()) / (rows * T),
            "walked_tile_share": float(((ends + tile - 1) // tile).sum())
            / (rows * ((T + tile - 1) // tile)),
            "empty_rows": int((ends == 0).sum()),
        }
    )
    return pending


def union_length(spans) -> float:
    """Total length covered by (start, end) intervals (overlaps once)."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def by_kernel(device):
    """Traced device events -> {name: [device ms, calls]}."""
    by_name = {}
    for e in device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += (e.time_range.end - e.time_range.start) / 1e3
        acc[1] += 1
    return by_name


def profile_request(torch, pipe, clip):
    """One more (uncounted) request under torch.profiler: device time by
    kernel, and the share of the request's wall time in which no device
    activity (kernel, copy, memset) ran. The profiler slows the host, so
    this idle share is an upper bound for the unprofiled requests."""
    (_, wall_ms), device = traced(torch, lambda: timed(torch, lambda: pipe(clip)))
    check(bool(device), "profile: no device activity was traced")
    busy_ms = union_length((e.time_range.start, e.time_range.end) for e in device) / 1e3
    by_name = by_kernel(device)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    ours = {
        name[:60]: {"device_ms": ms, "calls": n}
        for name, (ms, n) in by_name.items()
        if any(
            k in name
            for k in (
                "asp_bf16_kernel",
                "asp_f32_kernel",
                "log_mel_kernel",
                "pack_kernel",
                "linkage_kernel",
            )
        )
    }
    emit(
        {
            "profile": "one 59 s request under torch.profiler",
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "port_kernels": ours,
            "top": [
                {"name": name[:90], "device_ms": ms, "calls": n} for name, (ms, n) in top
            ],
        }
    )


def fma_asp_kernel(torch):
    """The first slice's float32 ASP kernel (scripts/asp_f32_fma.cu), built
    as scripts/asp_cuda_ablation.py builds it: fn(x, a_tanh, w, bias, mask)
    lays the inputs out as that kernel reads them and returns run(), which
    launches it alone and returns (mean, std)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "asp_cuda_ablation", os.path.join(HERE, "scripts", "asp_cuda_ablation.py")
    )
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    lib = ablation.build(["f32_fma"], "")["f32_fma"][0]
    launch = ablation.fma_launcher(lib)

    def prepare(x, a_tanh, w, bias, mask, eps=1e-12):
        B, C, T = x.shape
        a_tanh, wt = a_tanh.contiguous(), w.t().contiguous()
        bias, mask = bias.float().contiguous(), mask.float().contiguous()
        mean = torch.empty((B, C), dtype=torch.float32, device=x.device)
        std = torch.empty_like(mean)

        def run():
            err = launch(x.data_ptr(), a_tanh.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                         mask.data_ptr(), mean.data_ptr(), std.data_ptr(), B, C,
                         a_tanh.shape[1], T, eps, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"the FMA ASP kernel failed to launch (cudaError {err})")
            return mean, std

        return run

    return prepare


def float32_requests_phase(torch, counters):
    """The float32 path at full width: the default PyanNet and ECAPA-TDNN with
    seeded random weights, compute_dtype and transfer_dtype float32 at
    precision "highest" (TF32 off), on the 59 s clip: one warm-up request and
    two timed ones, each launching the float32 ASP kernel once a stage-2
    batch (12) and the bf16 one never, stage 3 on the device. Then one more
    request with its ASP inputs watched: the embeddings finite, and the
    kernel held against its plain version on one batch's real inputs, with
    its time there beside the FMA kernel's on the same inputs; then one more
    under torch.profiler (the kernel's device time in a request). Kernel times
    on the batch are CUDA-event device times, as in the kernel phase.
    ``counters``: as main_path_phase's. Returns the launch counts."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ecapa
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
        precision_scope,
    )

    cfg = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="float32", transfer_dtype="float32")
    pipe = SpeakerDiarizationPipeline(cfg, seed=0, precision="highest")
    seg = pipe.config.segmentation
    clip = synth_clip(59.0, seed=0, quantize=False)
    padded = pipe.chunk_lattice(chunk_count(len(clip), seg.window_size, seg.step_size))
    batches = padded * seg.num_speakers // pipe.emb_batch
    expected = dict(
        {name: batches for name in counters},
        asp_pool=0,  # the bf16 kernel
        linkage=1,
    )

    def count():
        return {name: getattr(fn, attr) for name, (fn, attr, _) in counters.items()}

    for fn, attr, _ in counters.values():
        setattr(fn, attr, 0)
    for i in range(3):
        if i == 1:  # after the warm-up request
            strict_dispatch(torch, pipe)
        before = count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        annotation = pipe(clip)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {name: n - before[name] for name, n in count().items()}
        check(
            launched == expected,
            f"float32 path: launches {launched}, expected {expected} per request",
        )
        t = pipe.timings
        emit(
            {
                "float32_request": i,
                "warmup": i == 0,
                "config": "compute_dtype and transfer_dtype float32, precision highest",
                "audio_s": len(clip) / seg.sample_rate,
                "wall_ms": wall_ms,
                "host_s": {"segmentation": t.segmentation, "fetch": t.fetch},
                "device_ms": {
                    "stage1": t.stage1_ms,
                    "stage2": t.stage2_ms,
                    "stage3": t.stage3_ms,
                },
                "stage3_route": "device",
                "turns": len(annotation.turns()),
                "launches": launched,
            }
        )
    totals = count()

    # one more request with the ASP calls watched: the first batch's inputs
    # kept for the kernel against its plain version
    real_asp, seen = ecapa.asp_pool, []

    def watched_asp(x, a_tanh, w, bias, mask, eps=1e-12):
        if not seen:
            seen.append((x, a_tanh, w, bias, mask, eps))
        return real_asp(x, a_tanh, w, bias, mask, eps)

    ecapa.asp_pool = watched_asp
    try:
        with precision_scope(pipe.precision):
            pending = pipe._dispatch(clip)
    finally:
        ecapa.asp_pool = real_asp
    torch.cuda.synchronize()
    check(pending["device_clu"] is not None, "float32 path: stage 3 did not take the device route")
    emb = pending["emb"].float()
    rows = pending["num_chunks"] * seg.num_speakers
    check(
        emb.dtype == torch.float32
        and tuple(emb.shape) == (padded * seg.num_speakers, pipe.ecapa_cfg.emb_dim)
        and bool(torch.isfinite(emb[:rows][~pending["too_short"][:rows]]).all()),
        f"float32 path: embeddings {tuple(emb.shape)} not finite or misshapen",
    )
    x, a_tanh, w, bias, mask, eps = seen[0]
    check(x.dtype == torch.float32, f"float32 path: ASP ran on {x.dtype}")
    # the request's tensors are inference tensors; W is a parameter
    with torch.inference_mode(), precision_scope(pipe.precision):
        fma = fma_asp_kernel(torch)(x, a_tanh, w, bias, mask, eps)
        got = asp_cuda.asp_pool(x, a_tanh, w, bias, mask, eps)
        want = asp_cuda.asp_pool_plain(x, a_tanh, w, bias, mask, eps)
        old = fma()
        torch.cuda.synchronize()
        err = max(float((g - p).abs().max()) for g, p in zip(got, want))
        err_fma = max(float((g - p).abs().max()) for g, p in zip(old, want))
        check(
            within(torch, got[0], want[0], 1e-5, 1e-5) and within(torch, got[1], want[1], 1e-4, 1e-5),
            f"float32 path: the ASP kernel differs from its plain version on a request's "
            f"inputs (max abs {err})",
        )
        kernel_ms = time_ms(torch, lambda: asp_cuda.asp_pool(x, a_tanh, w, bias, mask, eps))
        fma_ms = time_ms(torch, fma)
    valid = mask > 0
    emit(
        {
            "float32_asp_inputs": "one stage-2 batch of a float32 request, on the card",
            "shapes": {"x": list(x.shape), "a_tanh": list(a_tanh.shape)},
            "a_tanh_row_stride": a_tanh.stride(1),
            "valid_share": float(valid.float().mean()),
            "walked_share": float(walk_ends(torch, valid).sum()) / valid.numel(),
            "max_abs_err": err,
            "tolerance": "mean rtol/atol 1e-5, std rtol 1e-4 / atol 1e-5",
            "kernel_ms": kernel_ms,
            "fma_kernel_ms": fma_ms,
            "fma_kernel_max_abs_err": err_fma,
        }
    )

    # one more request under torch.profiler: the kernel's device time in it
    (_, wall_ms), device = traced(torch, lambda: timed(torch, lambda: pipe(clip)))
    runs = [
        (e.time_range.end - e.time_range.start) / 1e3 for e in device if "asp_f32_kernel" in e.name
    ]
    check(bool(runs), "float32 profile: no run of the float32 ASP kernel was traced")
    by_name = {}
    for e in device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += (e.time_range.end - e.time_range.start) / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    emit(
        {
            "float32_profile": "one float32 59 s request under torch.profiler",
            "wall_ms": wall_ms,
            "device_busy_ms": union_length((e.time_range.start, e.time_range.end) for e in device)
            / 1e3,
            "asp_f32_kernel_ms": sum(runs),
            "asp_f32_kernel_runs_traced": len(runs),
            "launches": batches,
            "fma_kernel_ms_times_launches": batches * fma_ms,
            "top": [{"name": n[:90], "device_ms": ms, "calls": c} for n, (ms, c) in top],
        }
    )
    return totals


TURN_LINE = re.compile(r"^\[(\d+\.\d{3}) -- (\d+\.\d{3})\] --> Speaker_(\S+)$")


def turn_lines(annotation):
    """The CLI's output lines of an annotation."""
    return [f"[{t.start:.3f} -- {t.end:.3f}] --> Speaker_{t.label}" for t in annotation.turns()]


def counted(torch, counters, fn):
    """(fn(), the launches each kernel made in it), the counts set to 0
    just before and read just after; the card is drained on both sides."""
    for kernel, attr, _ in counters.values():
        setattr(kernel, attr, 0)
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(kernel, attr) for name, (kernel, attr, _) in counters.items()}


def timed(torch, fn):
    """(fn(), its host wall ms, ended by a wait for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def entry_points_phase(torch, counters):
    """The pipeline's entry points besides ``__call__`` at full width (the
    default PyanNet and ECAPA-TDNN, default config, seeded weights):
    ``warmup(60)`` on a fresh pipeline, then every dispatch under sync debug
    mode "error"; ``map`` of four clips against sequential calls;
    ``run_chunks`` and ``stage2_internals`` on the 59 s clip against the
    request's embeddings and the plain pack; the two sub-pipelines; the CLI
    in a subprocess against the same weights in process; and the small5s
    differential dumps on the card against the CPU. Returns each kernel's
    launches over the phase's paths."""
    import shutil
    import tempfile

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.io.wav import write_wav
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import (
        params_to_jax,
        save_checkpoint,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import pyannet_num_frames
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import masks as mk
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import pack_cuda
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
        finalize_embeddings,
        to_host,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.embedding import (
        EmbeddingPipeline,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.segmentation import (
        SegmentationPipeline,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils import debug_dump, instrumented

    totals = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            totals[name] += n
        return launches

    # --- warmup on a fresh pipeline, then the first request -----------------
    t0 = time.perf_counter()
    pipe = SpeakerDiarizationPipeline(seed=0)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets = pipe.warmup(60.0)
    warmup_s = time.perf_counter() - t0
    strict_dispatch(torch, pipe)
    seg = pipe.config.segmentation
    clip = synth_clip(59.0, seed=0, quantize=False)
    first, first_ms = timed(torch, lambda: pipe(clip))
    emit(
        {
            "entry_points": "warmup(60) on a fresh full-width pipeline, then one 59 s request",
            "init_s": init_s,
            "warmup_s": warmup_s,
            "buckets": buckets,
            "first_request_wall_ms": first_ms,
            "first_request_turns": len(first.turns()),
        }
    )

    # --- map against sequential calls ---------------------------------------
    clips = [
        clip,
        synth_clip(30.0, seed=1, quantize=True),
        synth_clip(12.3, seed=977, quantize=True),  # ends on an orphan chunk
        clip,
    ]
    torch.cuda.reset_peak_memory_stats()
    sequential = [timed(torch, lambda c=c: pipe(c)) for c in clips]
    sequential_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    (mapped, map_ms), launches = counted(torch, counters, lambda: timed(torch, lambda: pipe.map(clips)))
    map_peak = torch.cuda.max_memory_allocated() / 2**30
    add(launches)
    for i, (got, (want, _)) in enumerate(zip(mapped, sequential)):
        check(
            same_turns(turns_of(got), turns_of(want)),
            f"map: clip {i}'s turns differ from its sequential call's",
        )
    # three more rounds in turns (map first, then sequential first, ...):
    # the two walls side by side on the same card
    map_walls, sequential_sums = [map_ms], [sum(ms for _, ms in sequential)]
    for r in range(3):
        for mode in ("map", "sequential") if r % 2 == 0 else ("sequential", "map"):
            if mode == "map":
                map_walls.append(timed(torch, lambda: pipe.map(clips))[1])
            else:
                sequential_sums.append(sum(timed(torch, lambda c=c: pipe(c))[1] for c in clips))
    for name in ("pack_frames", "log_mel", "asp_pool", "linkage"):
        check(launches[name] > 0, f"map: the {name} kernel never launched")
    (_, map_profiled_ms), device = traced(torch, lambda: timed(torch, lambda: pipe.map(clips)))
    busy_ms = union_length((e.time_range.start, e.time_range.end) for e in device) / 1e3
    emit(
        {
            "entry_points": "map of four clips (59, 30, 12.3 with an orphan chunk, 59 s) "
            "against sequential calls",
            "audio_s": [len(c) / seg.sample_rate for c in clips],
            "sequential_wall_ms": [ms for _, ms in sequential],
            "sequential_sum_ms": sequential_sums,
            "map_wall_ms": map_walls,
            "map_over_sequential_median": statistics.median(map_walls)
            / statistics.median(sequential_sums),
            "turns_equal": True,
            "turns": [len(a.turns()) for a in mapped],
            "peak_device_gib": {"sequential": sequential_peak, "map": map_peak},
            "profiled_map_wall_ms": map_profiled_ms,
            "profiled_map_device_busy_ms": busy_ms,
            "profiled_map_device_idle_share": 1.0 - busy_ms / map_profiled_ms,
            "launches": launches,
        }
    )

    # --- run_chunks and stage2_internals on the 59 s clip --------------------
    n = chunk_count(len(clip), seg.window_size, seg.step_size)
    orphan = len(clip) - (n - 1) * seg.step_size
    orphan_frames = None
    if orphan < seg.window_size:
        orphan_frames = max(pyannet_num_frames(orphan, pipe.pyannet_cfg), 0)
    S = seg.num_speakers
    (segs, binarized, emb_rc), launches = counted(
        torch, counters, lambda: pipe.run_chunks(clip, n, orphan_frames, orphan)
    )
    add(launches)
    pending = pipe._dispatch(clip)
    emb_call = finalize_embeddings(*to_host(pending["emb"], pending["too_short"]), n, S)
    check(
        np.array_equal(np.isnan(emb_rc), np.isnan(emb_call)),
        "run_chunks: too-short rows differ from the request's",
    )
    emb_err = float(np.nanmax(np.abs(emb_rc - emb_call)))
    check(emb_err <= ENVELOPE, f"run_chunks: embeddings {emb_err} from the request's (> {ENVELOPE})")
    (signals, wav_lens), launches = counted(
        torch, counters, lambda: pipe.stage2_internals(clip, n, orphan_frames, orphan)
    )
    add(launches)
    # the plain pack of the same rows: the masks the request chose from its
    # binarized scores, over the rows' windows
    binarized_t = torch.from_numpy(binarized)
    chosen = mk.choose_masks(
        binarized_t, mk.clean_segmentations(binarized_t), pipe._min_num_frames
    ).numpy()
    keep = chosen.reshape(n * S, -1) > pipe.config.embedding.mask_threshold
    wav_padded = np.zeros((n - 1) * seg.step_size + seg.window_size, np.float32)
    wav_padded[: len(clip)] = clip
    windows = np.repeat(
        np.stack([wav_padded[i * seg.step_size : i * seg.step_size + seg.window_size] for i in range(n)]),
        S,
        axis=0,
    )
    packed, lens = pack_cuda.pack_frames_plain(
        torch.from_numpy(windows).cuda(), torch.from_numpy(keep).cuda()
    )
    packed, lens = packed.cpu().numpy(), lens.cpu().numpy()
    too_short = lens < pipe.config.embedding.min_num_samples
    want_lens = np.where(too_short, 1.0, lens / seg.window_size).astype(np.float32)
    check(np.array_equal(signals, packed), "stage2_internals: signals differ from the plain pack")
    check(
        np.allclose(wav_lens, want_lens, rtol=1e-6, atol=0),
        "stage2_internals: wav_lens differ from the plain pack's lengths",
    )
    emit(
        {
            "entry_points": "run_chunks and stage2_internals, 59 s clip",
            "chunks": n,
            "embedding_rows": int((~np.isnan(emb_rc[..., 0])).sum()),
            "emb_max_abs_err_vs_request": emb_err,
            "envelope": ENVELOPE,
            "signals_equal_plain_pack": True,
            "kept_share": float(lens.sum()) / lens.size / seg.window_size,
        }
    )

    # --- the sub-pipelines ---------------------------------------------------
    sp = SegmentationPipeline(seed=0)
    (vad, vad_ms), launches = counted(torch, counters, lambda: timed(torch, lambda: sp(clip)))
    speakers = sp(clip, merge_speakers=False)
    ep = EmbeddingPipeline(seed=0)
    masks = chosen.reshape(n * S, -1)[: pipe.emb_batch].astype(np.float32)
    (emb_masked, masked_ms), launches_masked = counted(
        torch, counters, lambda: timed(torch, lambda: ep(windows[: pipe.emb_batch], masks))
    )
    (emb_plain, plain_ms), launches_plain = counted(
        torch, counters, lambda: timed(torch, lambda: ep(windows[: pipe.emb_batch]))
    )
    for ls in (launches, launches_masked, launches_plain):
        add(ls)
    rows = ~np.isnan(emb_masked[:, 0])
    check(
        emb_masked.shape == emb_plain.shape == (pipe.emb_batch, pipe.ecapa_cfg.emb_dim)
        and bool(np.isfinite(emb_plain).all())
        and bool(np.isfinite(emb_masked[rows]).all())
        and bool(rows.any()),
        "EmbeddingPipeline: embeddings misshapen or not finite",
    )
    check(
        launches_masked["pack_frames"] == 1 and launches_plain["pack_frames"] == 0
        and launches_masked["asp_pool_float32"] == launches_plain["asp_pool_float32"] == 1,
        f"EmbeddingPipeline: launches {launches_masked} (masked), {launches_plain} (plain)",
    )
    check(len(vad.turns()) >= 1, "SegmentationPipeline: no speech turn")
    emit(
        {
            "entry_points": "SegmentationPipeline (59 s clip) and EmbeddingPipeline "
            f"({pipe.emb_batch} windows, float32 trunk)",
            "segmentation_wall_ms": vad_ms,
            "vad_turns": len(vad.turns()),
            "speaker_turns": len(speakers.turns()),
            "embedding_masked_wall_ms": masked_ms,
            "embedding_unmasked_wall_ms": plain_ms,
            "embedding_rows_masked": int(rows.sum()),
            "launches": {"masked": launches_masked, "unmasked": launches_plain},
        }
    )

    # --- the CLI in a subprocess, with the pipeline's weights ----------------
    tmp = tempfile.mkdtemp()
    try:
        wav_path = os.path.join(tmp, "clip.wav")
        write_wav(wav_path, clip * 32768.0, seg.sample_rate)
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, params_to_jax(pipe.segmentation_model, pipe.embedding_model))
        want = turn_lines(pipe(wav_path))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "pyannote_audio_speaker_diarization_cpp_tpu_torch.cli",
             wav_path, "--checkpoint", ckpt],
            cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True,
            text=True,
            timeout=600,
        )
        cli_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(out.returncode == 0, f"cli: exit {out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    check(bool(lines) and all(TURN_LINE.match(ln) for ln in lines), f"cli: output {lines[:5]}")
    check(lines == want, f"cli: turns {lines[:5]} differ from in process {want[:5]}")
    emit(
        {
            "entry_points": "python -m ...cli clip.wav --checkpoint <npz dir>, subprocess",
            "wall_s": cli_s,
            "turn_lines": len(lines),
            "turns_equal_in_process": True,
            "stderr": [ln for ln in out.stderr.splitlines() if "time:" in ln],
        }
    )

    # --- the differential dumps on the card against the CPU ------------------
    small_clip = synth_clip(12.3, seed=977, quantize=True)
    dumps = {}
    for device in ("cuda", "cpu"):
        session = debug_dump.DumpSession(write_text=False)
        small = small5s_pipeline(device, float32=True)
        if device == "cuda":
            annotation, launches = counted(
                torch, counters, lambda: instrumented.run_with_dumps(small, small_clip, session)
            )
            add(launches)
        else:
            annotation = instrumented.run_with_dumps(small, small_clip, session)
        dumps[device] = (session.tensors, turns_of(annotation))
    results = debug_dump.compare_tensors(dumps["cuda"][0], dumps["cpu"][0])
    bad = [f"{r.name}: {r.status} {r.detail}" for r in results if r.status != "match"]
    check(len(results) == 39, f"dumps: {len(results)} names, the checklist has 39")
    check(not bad, "dumps: card vs cpu: " + "; ".join(bad))
    check(same_turns(dumps["cuda"][1], dumps["cpu"][1]), "dumps: turns differ between cuda and cpu")
    emit(
        {
            "entry_points": "run_with_dumps small5s (float32), cuda against cpu",
            "names": len(results),
            "matched": len(results) - len(bad),
            "tolerance": "exact for discrete names, rtol 1e-3 / atol 1e-4 for floats",
        }
    )
    emit({"entry_points": "launches over the phase's paths", "launches": totals})
    return totals


def per_request_launches(pipe, clip, counters):
    """The launches each kernel must make in one request of ``clip``."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count

    seg = pipe.config.segmentation
    padded = pipe.chunk_lattice(chunk_count(len(clip), seg.window_size, seg.step_size))
    batches = padded * seg.num_speakers // pipe.emb_batch
    return {name: batches if n is None else n for name, (_, _, n) in counters.items()}


def profile_sections(torch, sections, top: int = 8):
    """Each fn of ``sections`` ({name: fn}) once, warm, in one
    torch.profiler session (``traced``), in order, each after a marker
    kernel and closed by a wait for the card. Returns {name: (its device
    kernels by total ms, the first ``top``, each {name, device_ms, calls};
    their device ms in all; their count)}: a section's kernels are those
    between its marker and the next, in the device's own order."""

    def run():
        for fn in sections.values():
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()

    run()
    _, device = traced(torch, run, markers=len(sections))
    parts = []
    for e in device:
        if is_marker(e):
            parts.append({})
        elif parts:
            acc = parts[-1].setdefault(e.name, [0.0, 0])
            acc[0] += (e.time_range.end - e.time_range.start) / 1e3
            acc[1] += 1
    check(
        len(parts) == len(sections) and all(parts),
        f"profile: {len(parts)} traced sections of {len(sections)}, or one without a kernel",
    )
    out = {}
    for name, by_name in zip(sections, parts):
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        out[name] = (
            [{"name": n[:100], "device_ms": ms, "calls": c} for n, (ms, c) in ranked[:top]],
            sum(ms for ms, _ in by_name.values()),
            sum(c for _, c in by_name.values()),
        )
    return out


def layouts_phase(torch, counters):
    """The ECAPA trunk in each layout ("nch", "nhc", "gemm") at full width:
    one pipeline each (default config, seeded weights); a first request,
    then two under sync debug mode "error" (launches counted, device ms by
    stage), turns equal to the "nch" pipeline's; stage 2 alone and one
    32-row trunk batch timed and profiled on that request's own inputs; the
    MFA (3072 -> 3072) and a tdnn1 (1024 -> 1024) 1x1 conv alone in the
    layout's form (device ms, TFLOP/s, the kernel it gets); in "nhc" the
    ASP kernel against its plain version on a request's own inputs, and the
    cost of the (B, T, C) -> (B, C, T) copy of x it needs; then small5s in
    float32 (TF32 off) in "nhc" and "gemm" on the card against the CPU.
    Returns each kernel's launches over the counted requests."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ecapa
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import layers as L
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    totals = {name: 0 for name in counters}
    clip = synth_clip(59.0, seed=0, quantize=False)
    turns = {}
    for layout in ecapa.ECAPA_LAYOUTS:
        pipe = SpeakerDiarizationPipeline(seed=0, ecapa_layout=layout)
        expected = per_request_launches(pipe, clip, counters)
        captured = {}

        def stage2(chunks, chosen, with_internals=False, _real=pipe._stage2, _c=captured):
            _c.setdefault("stage2", (chunks, chosen))
            return _real(chunks, chosen, with_internals)

        def trunk(feats, lengths=None, _real=pipe.embedding_model.forward, _c=captured):
            _c.setdefault("trunk", (feats, lengths))
            return _real(feats, lengths)

        pipe._stage2, pipe.embedding_model.forward = stage2, trunk
        pipe(clip)  # the first request
        strict_dispatch(torch, pipe)
        requests = []
        for _ in range(2):
            (annotation, wall_ms), launched = counted(
                torch, counters, lambda: timed(torch, lambda: pipe(clip))
            )
            for name, n in launched.items():
                totals[name] += n
            check(launched == expected, f"layouts ({layout}): launches {launched}, expected {expected}")
            t = pipe.timings
            requests.append(
                {
                    "wall_ms": wall_ms,
                    "host_s_segmentation": t.segmentation,
                    "device_ms": {"stage1": t.stage1_ms, "stage2": t.stage2_ms, "stage3": t.stage3_ms},
                }
            )
        turns[layout] = turns_of(annotation)
        check(
            same_turns(turns[layout], turns["nch"]),
            f"layouts ({layout}): turns differ from the nch pipeline's",
        )
        chunks, chosen = captured["stage2"]
        feats, lengths = captured["trunk"]
        with torch.inference_mode():
            model = pipe.embedding_model
            sections = {}
            convs = {}
            B, T = feats.shape[:2]
            for name, conv in (("mfa", model.mfa.conv), ("block1.tdnn1", model.block1.tdnn1.conv)):
                c_out, c_in = conv.weight.shape[:2]
                x = torch.randn((B, T, c_in), device="cuda").to(pipe.emb_dtype)
                if layout == "nch":
                    x = x.transpose(1, 2).contiguous()
                    fn = lambda x=x, conv=conv: conv(x)  # noqa: E731
                else:
                    form = L.conv1d_nhc if layout == "nhc" else L.conv1d_gemm
                    fn = lambda x=x, conv=conv, form=form: ecapa.conv_nlc(form, x, conv)  # noqa: E731
                ms = time_ms(torch, fn)
                sections[name] = fn
                convs[name] = {
                    "shape": [B, T, c_in, c_out],
                    "ms": ms,
                    "tflop_per_s": 2.0 * B * T * c_in * c_out / (ms / 1e3) / 1e12,
                }
            trunk_ms = time_ms(torch, lambda: model(feats, lengths), reps=10)
            sections["trunk"] = lambda: model(feats, lengths)
            sections["stage2"] = lambda: pipe._stage2(chunks, chosen)
            profiled = profile_sections(torch, sections)
            for name in convs:
                convs[name]["kernels"] = profiled[name][0][:2]
            stage2_top, stage2_kernel_ms, _ = profiled["stage2"]
            _, trunk_busy_ms, trunk_launches = profiled["trunk"]
        emit(
            {
                "layouts": f"ecapa_layout={layout!r}, full width, 59 s clip, two requests "
                "after the first, sync debug mode error",
                "requests": requests,
                "turns": len(turns[layout]),
                "turns_equal_nch": True,
                "launches_per_request": expected,
                "stage2_kernel_ms": stage2_kernel_ms,
                "stage2_top": stage2_top,
                "trunk_batch": list(feats.shape),
                "trunk_ms": trunk_ms,
                "trunk_kernel_ms": trunk_busy_ms,
                "trunk_kernels": trunk_launches,
                "conv1x1": convs,
            }
        )
        if layout == "nhc":
            asp_check = nhc_asp_check(torch, pipe, clip)
        del pipe
    emit(asp_check)
    for layout in ("nhc", "gemm"):
        card = run_small5s("cuda", float32=True, ecapa_layout=layout)
        cpu = run_small5s("cpu", float32=True, ecapa_layout=layout)
        valid = ~cpu["too_short"]
        err = float((card["emb"][valid] - cpu["emb"][valid]).abs().max())
        check(torch.equal(card["too_short"], cpu["too_short"]), f"layouts small5s ({layout}): too_short")
        check(
            within(torch, card["emb"][valid], cpu["emb"][valid], 1e-3, 1e-4),
            f"layouts small5s ({layout}): embeddings differ from the CPU (max abs {err})",
        )
        check(same_turns(card["turns"], cpu["turns"]), f"layouts small5s ({layout}): turns differ")
        emit(
            {
                "layouts": f"small5s float32 (TF32 off), ecapa_layout={layout!r}, cuda vs cpu",
                "emb_max_abs_err": err,
                "tolerance": "rtol 1e-3, atol 1e-4",
                "embedding_rows": int(valid.sum()),
                "turns_equal": True,
            }
        )
    return totals


def nhc_asp_check(torch, pipe, clip):
    """One more (uncounted) request of an "nhc" pipeline with the ASP
    kernel's inputs captured: the kernel against its plain version on the
    first batch (bf16 tolerance of the kernel phase), and the device ms of
    the (B, T, C) -> (B, C, T) copy of x the layout needs beside the
    kernel's."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ecapa
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda

    real, seen = ecapa.asp_pool, []

    def watched(x, a_tanh, w, bias, mask, eps=1e-12):
        if not seen:
            seen.append((x, a_tanh, w, bias, mask, eps))
        return real(x, a_tanh, w, bias, mask, eps)

    ecapa.asp_pool = watched
    try:
        pipe(clip)
    finally:
        ecapa.asp_pool = real
    x, a_tanh, w, bias, mask, eps = seen[0]
    check(x.dtype == torch.bfloat16 and x.is_contiguous(), "nhc ASP: x is not contiguous bf16")
    with torch.inference_mode():
        mk_, sk = asp_cuda.asp_pool(x, a_tanh, w, bias, mask, eps)
        mp, sp = asp_cuda.asp_pool_plain(x, a_tanh, w, bias, mask, eps)
        torch.cuda.synchronize()
        err = max(
            float((mk_.float() - mp.float()).abs().max()), float((sk.float() - sp.float()).abs().max())
        )
        check(
            within(torch, mk_, mp, 8e-3, 1e-4) and within(torch, sk, sp, 8e-3, 1e-4),
            f"nhc ASP: kernel differs from its plain version (max abs {err})",
        )
        x_btc = x.transpose(1, 2).contiguous()
        kernel_ms = time_ms(torch, lambda: asp_cuda.asp_pool(x, a_tanh, w, bias, mask, eps))
        copy_ms = time_ms(torch, lambda: x_btc.transpose(1, 2).contiguous())
    return {
        "layouts": "nhc: the bf16 ASP kernel on a request's first batch, against asp_pool_plain",
        "x": list(x.shape),
        "a_tanh_row_stride": a_tanh.stride(1),
        "max_abs_err": err,
        "tolerance": "rtol 8e-3, atol 1e-4 (mean and std)",
        "kernel_ms": kernel_ms,
        "x_copy_ms": copy_ms,
        "x_copy_bytes": 2 * x.numel() * x.element_size(),
    }


def sinc_conv_phase(torch):
    """The SincNet conv in both forms (``sinc_conv``: polyphase and
    strided) on one (32, 80 000) batch with the default filterbank, at
    precision "highest" (TF32 off) and "default" (cuDNN TF32): device ms,
    the largest difference between the two forms and from the CPU's
    float32 result, and the bound of the work."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
        PyanNetConfig,
        SincFilters,
        sinc_conv,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        precision_scope,
    )

    cfg = PyanNetConfig()
    rng = np.random.default_rng(3)
    x_cpu = torch.from_numpy(rng.normal(size=(BATCH, 1, WINDOW)).astype(np.float32))
    with torch.inference_mode():
        f_cpu = SincFilters(cfg)()
        want = sinc_conv(x_cpu, f_cpu, cfg.stride)
        x, f = x_cpu.cuda(), f_cpu.cuda()
        frames = want.shape[-1]
        flops = 2.0 * BATCH * cfg.num_filters * cfg.kernel_size * frames
        nbytes = 4.0 * (x.numel() + f.numel() + want.numel())
        result = {
            "sinc_conv": f"one ({BATCH}, {WINDOW}) batch, {cfg.num_filters} filters of "
            f"{cfg.kernel_size} taps, stride {cfg.stride}",
        }
        for precision, dtype in (("highest", "float32"), ("default", "tfloat32")):
            with precision_scope(precision):
                outs = {}
                for form, poly in (("polyphase", True), ("strided", False)):
                    fn = lambda poly=poly: sinc_conv(x, f, cfg.stride, poly)  # noqa: E731
                    outs[form] = fn().cpu()
                    result[f"{precision}_{form}_ms"] = time_ms(torch, fn)
                    result[f"{precision}_{form}_max_abs_err_vs_cpu"] = float(
                        (outs[form] - want).abs().max()
                    )
                result[f"{precision}_forms_max_abs_diff"] = float(
                    (outs["polyphase"] - outs["strided"]).abs().max()
                )
                if precision == "highest":
                    for form, out in outs.items():
                        check(
                            bool(torch.isclose(out, want, rtol=1e-3, atol=1e-4).all()),
                            f"sinc_conv ({form}, TF32 off) differs from the CPU",
                        )
            result[f"{precision}_bound_ms"] = bound_ms(nbytes, {dtype: flops})
    result["max_abs_output"] = float(want.abs().max())
    emit(result)
    return result


def ingest_phase(torch, counters):
    """Weight ingest at full width: the seeded default models (the main
    path's) written as the published artifacts (``pyannet_to_pyannote``
    into a Lightning ``{"state_dict": ...}`` ``.bin``, ``ecapa_to_speechbrain``
    into a speechbrain savedir's ``embedding_model.ckpt``, both by
    ``torch.save``) and as an ``.npz`` tree whose filterbank is baked (the
    card's own filters); ``load_params_auto`` of each (host s, arrays equal
    to the source's); then one request each on pipelines built from what
    was loaded (seed 1, so a part not loaded would show), with turns equal
    to the source pipeline's. Returns each kernel's launches there."""
    import shutil
    import tempfile

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import (
        ecapa_to_speechbrain,
        flatten_pytree,
        params_to_jax,
        pyannet_to_pyannote,
        save_checkpoint,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ingest import load_params_auto
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    totals = {name: 0 for name in counters}
    clip = synth_clip(59.0, seed=0, quantize=False)
    source = SpeakerDiarizationPipeline(seed=0)
    want = turns_of(source(clip))
    params = params_to_jax(source.segmentation_model, source.embedding_model)
    sn = params["segmentation"]["sincnet"]
    filters = source.segmentation_model.sincnet.sinc().detach().cpu().numpy()
    baked = dict(params, segmentation=dict(params["segmentation"], sincnet=dict(sn, sinc={"filters": filters})))

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    tmp = tempfile.mkdtemp()
    try:
        paths = {
            "lightning_bin": os.path.join(tmp, "pytorch_model.bin"),
            "speechbrain_savedir": os.path.join(tmp, "savedir"),
            "baked_npz": os.path.join(tmp, "baked"),
        }
        torch.save(
            {
                "state_dict": tensors(pyannet_to_pyannote(params["segmentation"])),
                "hyper_parameters": {"sample_rate": 16000},
            },
            paths["lightning_bin"],
        )
        os.makedirs(paths["speechbrain_savedir"])
        torch.save(
            tensors(ecapa_to_speechbrain(params["embedding"])),
            os.path.join(paths["speechbrain_savedir"], "embedding_model.ckpt"),
        )
        save_checkpoint(paths["baked_npz"], baked)
        loaded, load_s, size_mb = {}, {}, {}
        for name, path in paths.items():
            files = [path] if os.path.isfile(path) else [os.path.join(path, f) for f in os.listdir(path)]
            size_mb[name] = sum(os.path.getsize(f) for f in files) / 1e6
            t0 = time.perf_counter()
            loaded[name] = load_params_auto(path)
            load_s[name] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, source_tree in (
        ("lightning_bin", {"segmentation": params["segmentation"]}),
        ("speechbrain_savedir", {"embedding": params["embedding"]}),
        ("baked_npz", baked),
    ):
        got, exp = flatten_pytree(loaded[name]), flatten_pytree(source_tree)
        check(
            sorted(got) == sorted(exp) and all(np.array_equal(got[k], exp[k]) for k in exp),
            f"ingest: {name} does not give back the source's arrays",
        )
    runs = {
        "lightning_bin + speechbrain_savedir": {
            "segmentation": loaded["lightning_bin"]["segmentation"],
            "embedding": loaded["speechbrain_savedir"]["embedding"],
        },
        "baked_npz": loaded["baked_npz"],
    }
    requests = {}
    for name, tree in runs.items():
        pipe = SpeakerDiarizationPipeline(params=tree, seed=1)
        check(
            pipe.segmentation_model.sincnet.sinc.baked == (name == "baked_npz"),
            f"ingest: {name}: the sinc filterbank's form",
        )
        expected = per_request_launches(pipe, clip, counters)
        (annotation, wall_ms), launched = counted(
            torch, counters, lambda: timed(torch, lambda: pipe(clip))
        )
        for k, n in launched.items():
            totals[k] += n
        check(launched == expected, f"ingest: {name}: launches {launched}, expected {expected}")
        check(same_turns(turns_of(annotation), want), f"ingest: {name}: turns differ from the source's")
        requests[name] = {"first_request_wall_ms": wall_ms, "turns": len(want), "turns_equal_source": True}
    emit(
        {
            "ingest": "full-width artifacts written by torch.save, read by load_params_auto",
            "artifact_mb": size_mb,
            "load_params_auto_s": load_s,
            "arrays_equal_source": True,
            "requests": requests,
        }
    )
    return totals


def gapped_clip(seconds: float = 30.0, seed: int = 0, sr: int = 16000) -> np.ndarray:
    """Tone-and-noise speech turns of 2-4 s from three voices, separated by
    zero-filled gaps of 1.5-2.5 s (the gate model, an energy voice-activity
    detector, gives count == 0 there), int16-quantized: the clip on which
    the stream's frozen prefix engages."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * sr), np.float32)
    voices = ((220.0, 1100.0), (410.0, 2500.0), (150.0, 700.0))
    t, i = 0.5, 0
    while True:
        dur = rng.uniform(2.0, 4.0)
        if t + dur > seconds - 0.3:
            break
        f0, f1 = voices[i % 3]
        n0, n = int(t * sr), int(dur * sr)
        tt = np.arange(n) / sr
        out[n0 : n0 + n] = (
            0.3 * np.sin(2 * np.pi * f0 * tt)
            + 0.2 * np.sin(2 * np.pi * f1 * tt * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * tt)))
            + 0.05 * rng.standard_normal(n)
        )
        t += dur + rng.uniform(1.5, 2.5)
        i += 1
    q = np.clip(np.round(out * 20000.0), -32768, 32767).astype(np.int16)
    return q.astype(np.float32) / 32768.0


def turns_well_formed(annotation, seconds: float) -> bool:
    turns = annotation.turns()
    return len(turns) > 0 and all(
        np.isfinite([t.start, t.end]).all() and 0.0 <= t.start < t.end <= seconds + 1e-6
        for t in turns
    )


def partition_of(annotation):
    """Each label's set of spans, as a sorted list of sets (the partition
    the turns make, whatever the labels are called)."""
    groups = {}
    for t in annotation.turns():
        groups.setdefault(t.label, set()).add((round(t.start, 6), round(t.end, 6)))
    return sorted(map(frozenset, groups.values()), key=sorted)


def feed_stats(stream):
    """Median and max ms of the emitting feeds, by whether a full recluster
    ran in them."""
    kinds = {"recluster": [], "fold": []}
    for i, sec in enumerate(stream.feed_latencies):
        kinds["recluster" if i in stream.recluster_emissions else "fold"].append(sec * 1e3)
    return {
        kind: {"n": len(ms), "median_ms": statistics.median(ms), "max_ms": max(ms)}
        if ms
        else {"n": 0}
        for kind, ms in kinds.items()
    }


def stream_clip(torch, pipe, clip, block, **kwargs):
    """Stream ``clip`` through ``pipe`` in ``block``-sample blocks. Returns
    (the stream, each feed's emission or None, the flush, flush ms, native
    linkages run in the flush, (real, padded) chunks and host wall ms of
    each run_chunks range: its enqueue, the card's work and the fetch)."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.streaming import (
        StreamingDiarizer,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import native_bindings

    ranges = []
    run_chunks = pipe.run_chunks

    def recorded(waveform, num_chunks, *args):
        t0 = time.perf_counter()
        out = run_chunks(waveform, num_chunks, *args)
        ranges.append((num_chunks, pipe.chunk_lattice(num_chunks), (time.perf_counter() - t0) * 1e3))
        return out

    pipe.run_chunks = recorded
    try:
        stream = StreamingDiarizer(pipe, **kwargs)
        outs = [stream.feed(clip[i : i + block]) for i in range(0, len(clip), block)]
        calls = native_bindings.linkage_calls
        t0 = time.perf_counter()
        final = stream.flush()
        flush_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del pipe.run_chunks
    return stream, outs, final, flush_ms, native_bindings.linkage_calls - calls, ranges


def range_stats(ranges):
    """Median and max host ms of the stream's run_chunks ranges."""
    ms = [t for _, _, t in ranges]
    return {"n": len(ms), "median_ms": statistics.median(ms), "max_ms": max(ms)}


def train_rows(pipe, embeddings) -> int:
    """Rows the host clusterer's linkage takes from ``embeddings``."""
    rows = int((~np.isnan(embeddings).any(axis=-1)).sum())
    cap = getattr(pipe.clusterer, "max_num_embeddings", None)
    return rows if cap is None else min(rows, int(cap))


def streaming_phase(torch, counters):
    """pipelines/streaming.py on the card. (a) Full width, the default
    config on the host route (device_clustering=False): the 59 s clip in
    0.5 s blocks, emit_every 8, recluster_every 4; its flush against the
    same pipeline's offline request (equal strings) and a default
    device-route pipeline's (equal partition); the stream's scores and
    embeddings against one run_chunks over the whole clip; native linkage
    in the flush; then a 5-minute clip in 1 s blocks under the doubling
    schedule. (b) small5s with the gate checkpoint in float32 (TF32 off)
    on a silence-gapped clip: every emission on the card against the same
    stream on the CPU, the frozen prefix engaged. (c) The spectral
    clusterer: a full-width request (no linkage launch) and small5s card
    against CPU. (d) The native linkage against scipy on the card's host.
    Returns each kernel's launches over the phase's streams and requests."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import load_checkpoint
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    totals = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            totals[name] += n
        return launches

    def expected(pipe, ranges):
        per_range = sum(p * pipe.config.segmentation.num_speakers // pipe.emb_batch for _, p, _ in ranges)
        return {name: per_range if n is None else 0 for name, (_, _, n) in counters.items()}

    # (a) full width
    pipe = SpeakerDiarizationPipeline(seed=0, device_clustering=False)
    seg = pipe.config.segmentation
    clip = synth_clip(59.0, seed=0, quantize=False)
    offline, offline_ms = timed(torch, lambda: pipe(clip))
    # the 32-chunk range's first call (cuDNN's plan choice), outside the stream
    pipe.run_chunks(clip[: 7 * seg.step_size + seg.window_size], 8)
    (stream, outs, final, flush_ms, flush_native, ranges), launched = counted(
        torch, counters, lambda: stream_clip(torch, pipe, clip, 8000, emit_every=8, recluster_every=4)
    )
    add(launched)
    check(launched == expected(pipe, ranges), f"stream: launches {launched}, ranges {ranges}")
    check(str(final) == str(offline), "stream: the flush differs from the offline host-route request")
    device_route = SpeakerDiarizationPipeline(seed=0)
    (dev_ann, _), dev_launched = counted(torch, counters, lambda: timed(torch, lambda: device_route(clip)))
    add(dev_launched)
    check(dev_launched["linkage"] == 1, "stream: no linkage launch in the default pipeline's request (stage 3 on the card)")
    check(
        partition_of(final) == partition_of(dev_ann),
        "stream: the flush is not partition-equivalent to the device-route request",
    )
    n_train = train_rows(pipe, stream._embeddings.view())
    check(n_train >= 256, f"stream: {n_train} train rows, below the native backend's 256")
    check(flush_native >= 1, "stream: the flush's recluster did not run the native linkage")
    segs_w, bin_w, emb_w = pipe.run_chunks(clip, stream._done_chunks)
    emb_s = stream._embeddings.view()
    check(
        np.array_equal(np.isnan(emb_s), np.isnan(emb_w)),
        "stream: too-short rows differ from the whole clip's run_chunks",
    )
    finite = ~np.isnan(emb_w)
    real = sum(n for n, _, _ in ranges)
    padded = sum(p for _, p, _ in ranges)
    emissions = sum(o is not None for o in outs)
    full = {
        "clip_s": len(clip) / seg.sample_rate,
        "block_s": 0.5,
        "emissions": emissions,
        "reclusters": stream.recluster_emissions,
        "feed": feed_stats(stream),
        "flush_ms": flush_ms,
        "offline_request_ms": offline_ms,
        "ranges": len(ranges),
        "run_chunks_ms": range_stats(ranges),
        "padded_share": 1.0 - real / padded,
        "launches": launched,
        "max_abs_diff_vs_whole_run_chunks": {
            "scores": float(np.abs(stream._segs.view() - segs_w).max()),
            "binarized_frames_differing": int((stream._binarized.view() != bin_w).sum()),
            "embeddings": float(np.abs(emb_s[finite] - emb_w[finite]).max()),
        },
        "train_rows": n_train,
        "flush_native_linkages": flush_native,
        "flush_equals_offline": True,
        "partition_equals_device_route": True,
        "turns": len(final.turns()),
        "speakers": len(final.labels),
    }
    emit({"streaming": "full width, 59 s clip, host route", **full})

    # where a range's time goes: one 8-chunk range (32 padded) against one
    # run_chunks of the whole clip (109 in 128), host wall then profiled
    range_clip = clip[: 7 * seg.step_size + seg.window_size]
    sections = {
        "range_8_of_32": lambda: pipe.run_chunks(range_clip, 8),
        "whole_109_of_128": lambda: pipe.run_chunks(clip, stream._done_chunks),
    }
    walls = {name: [timed(torch, fn)[1] for _ in range(3)] for name, fn in sections.items()}
    profiled = profile_sections(torch, sections, top=5)
    emit(
        {
            "streaming": "one range against the whole clip's run_chunks",
            **{
                name: {
                    "wall_ms": walls[name],
                    "device_kernel_ms": profiled[name][1],
                    "kernels": profiled[name][2],
                    "top": profiled[name][0],
                }
                for name in sections
            },
        }
    )

    long_clip = synth_clip(300.0, seed=1, quantize=False)
    long_offline, long_offline_ms = timed(torch, lambda: pipe(long_clip))
    (lstream, louts, lfinal, lflush_ms, lnative, lranges), launched = counted(
        torch,
        counters,
        lambda: stream_clip(torch, pipe, long_clip, 16000, emit_every=8, recluster_schedule="doubling"),
    )
    add(launched)
    check(launched == expected(pipe, lranges), f"long stream: launches {launched}")
    check(str(lfinal) == str(long_offline), "long stream: the flush differs from the offline request")
    emit(
        {
            "streaming": "full width, 300 s clip, 1 s blocks, doubling schedule",
            "emissions": sum(o is not None for o in louts),
            "reclusters": lstream.recluster_emissions,
            "feed": feed_stats(lstream),
            "flush_ms": lflush_ms,
            "offline_request_ms": long_offline_ms,
            "run_chunks_ms": range_stats(lranges),
            "padded_share": 1.0 - sum(n for n, _, _ in lranges) / sum(p for _, p, _ in lranges),
            "train_rows": train_rows(pipe, lstream._embeddings.view()),
            "flush_native_linkages": lnative,
            "flush_equals_offline": True,
        }
    )

    # (b) small5s parity stream, card against CPU
    params = load_checkpoint(os.path.join(HERE, "tests", "goldens", "gate_ckpt"))
    gapped = gapped_clip(30.0)
    runs = {}
    for device in ("cuda", "cpu"):
        small = small5s_pipeline(device, float32=True, params=params, device_clustering=False)
        if device == "cuda":
            run, launched = counted(
                torch, counters, lambda: stream_clip(torch, small, gapped, len(gapped) // 14 + 1, emit_every=8)
            )
            add(launched)
            small_launches = launched
            offline_small = str(small(gapped))
        else:
            run = stream_clip(torch, small, gapped, len(gapped) // 14 + 1, emit_every=8)
        runs[device] = run
    card, cpu = runs["cuda"], runs["cpu"]
    outs_card, outs_cpu = card[1] + [card[2]], cpu[1] + [cpu[2]]
    check(
        [o is None for o in outs_card] == [o is None for o in outs_cpu],
        "small5s stream: emissions at different feeds on the card and the CPU",
    )
    check(
        all(
            a is None or same_turns(turns_of(a), turns_of(b))
            for a, b in zip(outs_card, outs_cpu)
        ),
        "small5s stream: an emission differs between the card and the CPU",
    )
    check(card[0]._seam_cidx > 0, "small5s stream: the frozen prefix did not engage on the card")
    check(str(card[2]) == offline_small, "small5s stream: the flush differs from the card's offline request")
    check(small_launches["asp_pool_float32"] > 0, "small5s stream: no float32 ASP launch")
    emit(
        {
            "streaming": "small5s, gate checkpoint, float32 (TF32 off), 30 s silence-gapped clip",
            "emissions": sum(o is not None for o in outs_card[:-1]),
            "emissions_equal_cpu": True,
            "seam_cidx": int(card[0]._seam_cidx),
            "frozen_turns": len(card[0]._frozen_turns),
            "flush_equals_offline": True,
            "asp_pool_float32_launches": small_launches["asp_pool_float32"],
            "feed": feed_stats(card[0]),
            "turns": len(card[2].turns()),
            "speakers": len(card[2].labels),
        }
    )

    # (c) the spectral clusterer
    spectral = SpeakerDiarizationPipeline(seed=0, clusterer="spectral")
    check(spectral._device_clu_key() is None, "spectral: the device route is on")
    (ann, wall_ms), launched = counted(torch, counters, lambda: timed(torch, lambda: spectral(clip)))
    add(launched)
    check(launched["linkage"] == 0, "spectral: a linkage launch")
    check(turns_well_formed(ann, len(clip) / seg.sample_rate), "spectral: malformed turns")
    spectral_host_s = spectral.timings.clustering
    small_turns = {
        device: turns_of(
            small5s_pipeline(device, float32=True, params=params, clusterer="spectral")(gapped)
        )
        for device in ("cuda", "cpu")
    }
    check(
        same_turns(small_turns["cuda"], small_turns["cpu"]),
        "spectral: small5s turns differ between the card and the CPU",
    )
    emit(
        {
            "streaming": "spectral clusterer",
            "full_width_request_ms": wall_ms,
            "host_clustering_and_decode_s": spectral_host_s,
            "launches": launched,
            "turns": len(ann.turns()),
            "small5s_turns": len(small_turns["cuda"]),
            "small5s_turns_equal_cpu": True,
        }
    )

    # (d) the native linkage on the card's host
    emb = emb_w.reshape(-1, emb_w.shape[-1])
    emb = emb[~np.isnan(emb).any(axis=1)]
    native_vs_scipy(
        ("main_path", emb / np.linalg.norm(emb, axis=1, keepdims=True)),
        pipe.config.clustering.threshold,
    )
    return totals


def cpu_model() -> dict:
    """The host CPU as /proc/cpuinfo gives it (a virtualized host may report
    its model name as "unknown"; vendor, family, model and stepping still
    name the part), with the ISA level PyTorch's CPU kernels use."""
    import torch

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip().lower()
                if not line.strip():
                    break  # the first processor's block is enough
                fields.setdefault(key, value.strip())
    except OSError:
        pass
    flags = set(fields.get("flags", "").split())
    return {
        **{k: fields.get(k, "not reported") for k in ("model name", "vendor_id", "cpu family", "model", "stepping")},
        "isa": sorted(flags & {"avx2", "avx512f", "avx512_bf16", "amx_tile", "sve"}),
        "torch_cpu_capability": torch.backends.cpu.get_cpu_capability(),
    }


def native_vs_scipy(main_path, threshold: float):
    """runtime/native_bindings.py ``linkage_centroid`` against scipy's
    centroid linkage, on the main path's embeddings and on seeded unit
    blobs of 1000 and 2000 rows: merge pairs and sizes equal, distances
    within rtol 1e-8; host ms of each (median of three). Rows that are
    exact copies of each other (a chunk's speakers with equal masks get
    equal embeddings) merge at distance 0 in an order neither library
    defines, so where the input has copies the merges are compared on its
    distinct rows, and on all rows the merge distances and the flat
    clusters at ``threshold``."""
    from scipy.cluster.hierarchy import linkage

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import ahc
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import native_bindings

    cases = [main_path]
    for n in (1000, 2000):
        rng = np.random.default_rng(n)
        centres = rng.normal(size=(8, 192))
        X = centres[rng.integers(0, 8, size=n)] + 0.5 * rng.normal(size=(n, 192))
        cases.append((f"blobs_{n}", X / np.linalg.norm(X, axis=1, keepdims=True)))
    check(native_bindings.available(), "native: the library is unavailable")
    results = {}
    for name, X in cases:
        times = {"native": [], "scipy": []}
        for _ in range(3):
            t0 = time.perf_counter()
            Zn = native_bindings.linkage_centroid(X)
            times["native"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            Zs = linkage(X, method="centroid", metric="euclidean")
            times["scipy"].append((time.perf_counter() - t0) * 1e3)
        check(np.allclose(Zn[:, 2], Zs[:, 2], rtol=1e-8, atol=0), f"native: {name}: distances differ")
        check(
            partitions_equal(
                ahc.fcluster_distance(Zn, threshold), ahc.fcluster_distance(Zs, threshold)
            ),
            f"native: {name}: flat clusters differ from scipy's",
        )
        distinct = np.unique(X, axis=0)
        if len(distinct) < len(X):
            Zn, Zs = native_bindings.linkage_centroid(distinct), linkage(distinct, method="centroid")
            check(np.allclose(Zn[:, 2], Zs[:, 2], rtol=1e-8, atol=0), f"native: {name}: distances differ")
        check(
            np.array_equal(Zn[:, :2], Zs[:, :2]) and np.array_equal(Zn[:, 3], Zs[:, 3]),
            f"native: {name}: merges differ from scipy's",
        )
        results[name] = {
            "n": int(X.shape[0]),
            "distinct_rows": int(len(distinct)),
            "d": int(X.shape[1]),
            "native_ms": statistics.median(times["native"]),
            "scipy_ms": statistics.median(times["scipy"]),
        }
    emit(
        {
            "native_linkage": "linkage_centroid vs scipy centroid linkage: equal merges",
            "host_cpu": cpu_model(),
            "host_cpus": os.cpu_count(),
            "nvidia_smi": nvidia_smi_line(),
            "cases": results,
        }
    )


# ---------------------------------------------------------------------------
# long-form and the data-parallel layer
# ---------------------------------------------------------------------------


class ClustererSpy:
    """A pipeline's host clusterer with its calls counted."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)


def record_shards(pipe):
    """Keep (chunks, embeddings, too_short) of every ``run_chunks_device``
    call of ``pipe`` (long-form's shards), on the device. Returns the list."""
    kept = []
    launch = pipe.run_chunks_device

    def recording(*args, **kwargs):
        out = launch(*args, **kwargs)
        kept.append((args[1], out[3], out[4]))
        return out

    pipe.run_chunks_device = recording
    return kept


def record_requests(pipe):
    """Keep the pending state of every ``_dispatch`` of ``pipe``. Returns the
    list."""
    kept = []
    launch = pipe._dispatch

    def recording(*args, **kwargs):
        kept.append(launch(*args, **kwargs))
        return kept[-1]

    pipe._dispatch = recording
    return kept


def strict_longform(torch, lf, audio):
    """``lf(audio)`` with sync debug mode "error" throughout, except in its
    fetches (``lf._fetch``, the waits long-form makes by design, counted in
    ``lf.host_waits``): anything else that waits for the card raises."""
    fetch = lf._fetch

    def lifted(*tensors):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return fetch(*tensors)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    lf._fetch = lifted
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return lf(audio)
    finally:
        torch.cuda.set_sync_debug_mode(previous)
        del lf._fetch


def shard_embeddings(torch, kept, num_speakers):
    """The real rows of recorded shards' embeddings and too-short flags,
    concatenated in shard order (float32, on the CPU)."""
    emb = torch.cat([e[: n * num_speakers].float() for n, e, _ in kept]).cpu()
    too_short = torch.cat([t[: n * num_speakers] for n, _, t in kept]).cpu()
    return emb, too_short


def in_mode(launches, float32: bool):
    """A request's launches at the defaults -> in the parity mode, where the
    float32 ASP kernel takes the bf16 one's batches."""
    if not float32:
        return dict(launches)
    return dict(launches, asp_pool=0, asp_pool_float32=launches["asp_pool"])


def longform_launches(pipe, lf, num_samples, float32: bool, linkage: int):
    """The launches each kernel must make in one long-form run: every
    shard's stage-2 batches, on its own chunk lattice."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.longform import plan_shards

    seg = pipe.config.segmentation
    shards = plan_shards(
        chunk_count(num_samples, seg.window_size, seg.step_size),
        lf.num_shards,
        seg.window_size,
        seg.step_size,
    )
    padded = sum(pipe.chunk_lattice(s.num_chunks) for s in shards if s.num_chunks)
    batches = padded * seg.num_speakers // pipe.emb_batch
    launches = {"pack_frames": batches, "log_mel": batches, "asp_pool": batches}
    return in_mode(dict(launches, asp_pool_float32=0, linkage=linkage), float32)


def profile_longform(torch, lf, audio, top: int = 6):
    """One strict long-form run under torch.profiler: wall, device busy ms,
    the share of the wall with no device activity, device events, and the
    top kernels by device time. The profiler slows the host, so the idle
    share is an upper bound for unprofiled runs."""
    (_, wall_ms), device = traced(torch, lambda: timed(torch, lambda: strict_longform(torch, lf, audio)))
    check(bool(device), "profile: no device activity was traced")
    busy_ms = union_length((e.time_range.start, e.time_range.end) for e in device) / 1e3
    ranked = sorted(by_kernel(device).items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": len(device),
        "top": [{"name": name[:90], "device_ms": ms, "calls": n} for name, (ms, n) in ranked],
    }


def longform_phase(torch, counters):
    """parallel/longform.py at full width (default PyanNet and ECAPA-TDNN,
    seeded weights) on bench.py's synthetic clip extended. (a) 600 s (1191
    chunks): LongFormDiarizer(num_shards=4) against the single-shot request,
    both with stage 3 on the device (the merge loop at T = 1024): in the
    parity mode (float32, precision "highest") turns equal and embeddings
    at rtol 1e-3 / atol 1e-4; at the defaults embeddings within abs 0.02,
    turn equality printed; the fused stage 3 engaged (no host clusterer
    call, one linkage launch); a default run on the first 120 s profiled.
    (b) The parity mode card against CPU at
    reduced length (20 s, 4 shards). (c) 3600 s (7191 chunks):
    LongFormDiarizer(num_shards=8), window 3 (fused device stage 3) against
    the single-shot request (host route), each run once, the first at
    these shapes: walls, audio-s/s, peak device memory, launches,
    merge-loop T. After a pipeline's first request every
    dispatch runs under sync debug mode "error", and so does every
    long-form run but its fetches, which are counted. Returns each kernel's
    launches over the phase."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import device as devclu
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.longform import (
        LongFormDiarizer,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    totals = {name: 0 for name in counters}
    t_phase = time.perf_counter()

    def add(launches):
        for name, n in launches.items():
            totals[name] += n
        return launches

    # the merge loop's size T, as device_cluster hands it to the kernel
    merge_sizes = []
    real_linkage = devclu._linkage_labels

    def watched_linkage(embt, *args):
        merge_sizes.append(int(embt.shape[0]))
        return real_linkage(embt, *args)

    devclu._linkage_labels = watched_linkage
    try:
        f32 = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="float32", transfer_dtype="float32")
        sr = DEFAULT_CONFIG.segmentation.sample_rate
        S = DEFAULT_CONFIG.segmentation.num_speakers
        clip = synth_clip(600.0, seed=0, quantize=False)
        pipes = {}
        for mode, cfg, precision in (("float32", f32, "highest"), ("default", DEFAULT_CONFIG, "default")):
            pipe = SpeakerDiarizationPipeline(cfg, seed=0, precision=precision)
            pipes[mode] = pipe
            spy = pipe.clusterer = ClustererSpy(pipe.clusterer)
            lf = LongFormDiarizer(pipe, num_shards=4)
            # first requests at these shapes, outside the strict mode
            _, first_single_ms = timed(torch, lambda: pipe(clip))
            _, first_lf_ms = timed(torch, lambda: lf(clip))
            strict_dispatch(torch, pipe)
            requests, shards = record_requests(pipe), record_shards(pipe)
            (single, single_ms), single_launched = counted(
                torch, counters, lambda: timed(torch, lambda: pipe(clip))
            )
            add(single_launched)
            want = in_mode(per_request_launches(pipe, clip, counters), mode == "float32")
            check(
                single_launched == want,
                f"longform 600 s {mode}: single-shot launches {single_launched}, expected {want}",
            )
            check(requests[-1]["device_clu"] is not None, "longform 600 s: single shot not on the device route")
            merge_sizes.clear()
            spy.calls = 0
            (longf, lf_ms), lf_launched = counted(
                torch, counters, lambda: timed(torch, lambda: strict_longform(torch, lf, clip))
            )
            add(lf_launched)
            want = longform_launches(pipe, lf, len(clip), mode == "float32", 1)
            check(lf_launched == want, f"longform 600 s {mode}: launches {lf_launched}, expected {want}")
            check(spy.calls == 0, f"longform 600 s {mode}: the host clusterer ran ({spy.calls})")
            check(merge_sizes == [1024], f"longform 600 s {mode}: merge loop sizes {merge_sizes}")
            pend = requests[-1]
            rows = pend["num_chunks"] * S
            emb_s, ts_s = pend["emb"][:rows].float().cpu(), pend["too_short"][:rows].cpu()
            emb_l, ts_l = shard_embeddings(torch, shards[-4:], S)
            check(torch.equal(ts_s, ts_l), f"longform 600 s {mode}: too_short differs")
            valid = ~ts_s
            err = float((emb_l[valid] - emb_s[valid]).abs().max())
            equal_turns = same_turns(turns_of(longf), turns_of(single))
            if mode == "float32":
                check(
                    within(torch, emb_l[valid], emb_s[valid], 1e-3, 1e-4),
                    f"longform 600 s float32: embeddings differ (max abs {err})",
                )
                check(equal_turns, "longform 600 s float32: turns differ from the single-shot request's")
            else:
                check(err <= ENVELOPE, f"longform 600 s default: embeddings {err} apart (> {ENVELOPE})")
            check(turns_well_formed(longf, len(clip) / sr), f"longform 600 s {mode}: turns malformed")
            emit(
                {
                    "longform": f"600 s, 4 shards, {mode}",
                    "phase_elapsed_s": time.perf_counter() - t_phase,
                    "audio_s": len(clip) / sr,
                    "chunks": pend["num_chunks"],
                    "stage3_route": {"single_shot": "device", "longform": "device (fused)"},
                    "merge_loop_T": merge_sizes,
                    "first_wall_ms": {"single_shot": first_single_ms, "longform": first_lf_ms},
                    "wall_ms": {"single_shot": single_ms, "longform": lf_ms},
                    "audio_s_per_s": {
                        "single_shot": len(clip) / sr / (single_ms / 1e3),
                        "longform": len(clip) / sr / (lf_ms / 1e3),
                    },
                    "emb_max_abs_err_vs_single_shot": err,
                    "embedding_rows": int(valid.sum()),
                    "turns": len(single.turns()),
                    "turns_equal": equal_turns,
                    "strings_equal": str(longf) == str(single),
                    "host_clusterer_calls": spy.calls,
                    "longform_host_waits": lf.host_waits,
                    "launches": {"single_shot": single_launched, "longform": lf_launched},
                }
            )
        # profiled on the clip's first 120 s: a session that drops its
        # lead-in runs again, and at 600 s each run traced ~74,000 kernels
        profiled, launched = counted(
            torch, counters, lambda: profile_longform(torch, lf, clip[: 120 * sr])
        )
        add(launched)
        emit(
            dict(
                {"longform_profile": "120 s, 4 shards, default"},
                phase_elapsed_s=time.perf_counter() - t_phase,
                **profiled,
            )
        )

        # (b) the parity mode, card against CPU, at reduced length
        short = clip[: 20 * sr]
        cpu = SpeakerDiarizationPipeline(f32, seed=0, precision="highest", device="cpu")
        card = pipes["float32"]
        kept = {"cuda": record_shards(card), "cpu": record_shards(cpu)}
        (card_ann, card_ms), launched = counted(
            torch, counters, lambda: timed(torch, lambda: LongFormDiarizer(card, num_shards=4)(short))
        )
        add(launched)
        t0 = time.perf_counter()
        cpu_ann = LongFormDiarizer(cpu, num_shards=4)(short)
        cpu_s = time.perf_counter() - t0
        (e_g, t_g), (e_c, t_c) = (shard_embeddings(torch, kept[d][-4:], S) for d in ("cuda", "cpu"))
        check(torch.equal(t_g, t_c), "longform card vs cpu: too_short differs")
        valid = ~t_c
        err = float((e_g[valid] - e_c[valid]).abs().max())
        check(
            within(torch, e_g[valid], e_c[valid], 1e-3, 1e-4),
            f"longform card vs cpu: embeddings differ (max abs {err})",
        )
        check(same_turns(turns_of(card_ann), turns_of(cpu_ann)), "longform card vs cpu: turns differ")
        emit(
            {
                "longform": "20 s, 4 shards, float32, cuda vs cpu",
                "phase_elapsed_s": time.perf_counter() - t_phase,
                "emb_max_abs_err": err,
                "embedding_rows": int(valid.sum()),
                "turns": len(cpu_ann.turns()),
                "turns_equal": True,
                "card_wall_ms": card_ms,
                "cpu_wall_s": cpu_s,
                "launches": launched,
            }
        )
        del cpu, pipes["float32"], card

        # (c) an hour: 8 shards, window 3, against the single-shot request
        pipe = pipes["default"]
        spy = pipe.clusterer
        hour = synth_clip(3600.0, seed=0, quantize=False)
        lf = LongFormDiarizer(pipe, num_shards=8)
        merge_sizes.clear()
        spy.calls = 0
        torch.cuda.reset_peak_memory_stats()
        (longf, lf_ms), lf_launched = counted(
            torch, counters, lambda: timed(torch, lambda: strict_longform(torch, lf, hour))
        )
        add(lf_launched)
        lf_peak = torch.cuda.max_memory_allocated()
        want = longform_launches(pipe, lf, len(hour), False, 1)
        check(lf_launched == want, f"longform 3600 s: launches {lf_launched}, expected {want}")
        check(spy.calls == 0 and merge_sizes == [1024], f"longform 3600 s: host clusterer {spy.calls}, merge sizes {merge_sizes}")
        check(turns_well_formed(longf, len(hour) / sr), "longform 3600 s: turns malformed")
        torch.cuda.reset_peak_memory_stats()
        (single, single_ms), single_launched = counted(
            torch, counters, lambda: timed(torch, lambda: pipe(hour))
        )
        add(single_launched)
        single_peak = torch.cuda.max_memory_allocated()
        check(
            single_launched == dict(per_request_launches(pipe, hour, counters), linkage=0),
            f"longform 3600 s: single-shot launches {single_launched}",
        )
        check(spy.calls == 1, "longform 3600 s: the single-shot request did not take the host route")
        check(turns_well_formed(single, len(hour) / sr), "longform 3600 s: single-shot turns malformed")
        hour_s = len(hour) / sr
        emit(
            {
                "longform": "3600 s, 8 shards, window 3, default",
                "phase_elapsed_s": time.perf_counter() - t_phase,
                "audio_s": hour_s,
                "chunks": chunk_count(len(hour), pipe.config.segmentation.window_size, pipe.config.segmentation.step_size),
                "stage3_route": {"single_shot": "host", "longform": "device (fused)"},
                "merge_loop_T": merge_sizes,
                "wall_ms": {"longform": lf_ms, "single_shot": single_ms},
                "audio_s_per_s": {"longform": hour_s / (lf_ms / 1e3), "single_shot": hour_s / (single_ms / 1e3)},
                "peak_device_gib": {"longform": lf_peak / 2**30, "single_shot": single_peak / 2**30},
                "longform_host_waits": lf.host_waits,
                "turns": {"longform": len(longf.turns()), "single_shot": len(single.turns())},
                "turns_equal": same_turns(turns_of(longf), turns_of(single)),
                "launches": {"longform": lf_launched, "single_shot": single_launched},
            }
        )
    finally:
        devclu._linkage_labels = real_linkage
    return totals


def multirank_phase(torch, counters):
    """The data-parallel layer (parallel/mesh.py, parallel/sharding.py,
    the pipeline's ``mesh=``) at full width on the 59 s clip. (a) One NCCL
    rank on the card: the pipeline on the mesh equals the mesh-less one
    (strings, embeddings) with the same launches, every dispatch after its
    first under sync debug mode "error"; ``all_gather_embeddings`` of the
    request's embeddings under "error", and its time. (b) Two gloo ranks
    sharing cuda:0 (NCCL refuses two ranks on one card), spawned: the dry
    run's three cases (parallel/dryrun.py) on the mesh against one rank, in
    the parity mode (turns equal, embeddings at rtol 1e-3 / atol 1e-4) and
    at the defaults (embeddings within abs 0.02, turn equality printed);
    each rank runs half of the request's stage-2 batches on the mesh. Both
    ranks load one checkpoint written by ``save_checkpoint``. A rank that
    fails or times out fails the phase. Returns each kernel's launches over
    the phase, both ranks' included."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import (
        params_to_jax,
        save_checkpoint,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import _cuda_lib
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.mesh import make_mesh
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.sharding import (
        all_gather_embeddings,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import native_bindings

    totals = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            totals[name] += n
        return launches

    # the ranks load what the parent built (no-ops when main built them):
    # two ranks would race nvcc and g++ into the same _build/
    _cuda_lib.build()
    native_bindings.build()
    clip = synth_clip(59.0, seed=0, quantize=False)

    # (a) world size 1, NCCL
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}", world_size=1, rank=0
    )
    try:
        mesh = make_mesh()
        check(mesh.backend == "nccl" and mesh.device.type == "cuda", f"mesh {mesh}")
        single = SpeakerDiarizationPipeline(seed=0)
        sharded = SpeakerDiarizationPipeline(seed=0, mesh=mesh)
        want = single(clip)
        sharded(clip)  # the first request: NCCL makes its communicator
        strict_dispatch(torch, sharded)
        strict_dispatch(torch, single)
        reqs = {"single": record_requests(single), "mesh": record_requests(sharded)}
        (got, mesh_ms), launched = counted(torch, counters, lambda: timed(torch, lambda: sharded(clip)))
        add(launched)
        (again, single_ms), _ = counted(torch, counters, lambda: timed(torch, lambda: single(clip)))
        check(str(got) == str(want) == str(again), "multirank nccl: the mesh's turns differ")
        expected = per_request_launches(sharded, clip, counters)
        check(launched == expected, f"multirank nccl: launches {launched}, expected {expected}")
        per_rank = expected["pack_frames"] // 2  # a rank's block of 2
        emb_m, emb_s = reqs["mesh"][-1]["emb"], reqs["single"][-1]["emb"]
        check(torch.equal(emb_m, emb_s), "multirank nccl: embeddings differ from the mesh-less run")
        counts = [emb_m.shape[0]]
        all_gather_embeddings(emb_m, mesh, counts)  # warm
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gathered = all_gather_embeddings(emb_m, mesh, counts)
        finally:
            torch.cuda.set_sync_debug_mode(previous)
        check(torch.equal(gathered, emb_m), "multirank nccl: the gather changed the embeddings")
        gather_ms = time_ms(torch, lambda: all_gather_embeddings(emb_m, mesh, counts))
        feats = torch.zeros((128, 60, 293), device=mesh.device)
        feats_ms = time_ms(torch, lambda: all_gather_embeddings(feats, mesh, [128]))
        emit(
            {
                "multirank": "world 1, nccl, cuda:0",
                "turns": len(want.turns()),
                "strings_equal": True,
                "embeddings_equal": True,
                "wall_ms": {"mesh": mesh_ms, "meshless": single_ms},
                "launches": launched,
                "all_gather_ms": {
                    f"embeddings {tuple(emb_m.shape)} {emb_m.dtype}": gather_ms,
                    "sincnet features (128, 60, 293) float32": feats_ms,
                },
                "gather_sync_debug": "error",
            }
        )
        del single, sharded
    finally:
        dist.destroy_process_group()

    # (b) world size 2, gloo, both ranks on cuda:0
    f32 = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="float32", transfer_dtype="float32")
    tmp = tempfile.mkdtemp()
    try:
        source = SpeakerDiarizationPipeline(f32, seed=0, precision="highest")
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, params_to_jax(source.segmentation_model, source.embedding_model))
        del source
        for mode, kwargs in (
            ("float32", {"config": f32, "precision": "highest"}),
            ("default", {"config": DEFAULT_CONFIG}),
        ):
            t0 = time.perf_counter()
            reports = dryrun.dryrun_multichip(
                2,
                kwargs,
                clip,
                params=ckpt,
                device="cuda",
                share_card=True,
                require_equal=mode == "float32",
                timeout=600,
            )
            wall_s = time.perf_counter() - t0
            for r in reports:
                add(r["launches"])
                check(r["too_short_equal"], f"multirank gloo {mode}: too_short differs")
                if mode == "float32":
                    check(r["emb_within"], f"multirank gloo float32: embeddings differ ({r['emb_max_abs_err']})")
                else:
                    check(
                        r["emb_max_abs_err"] <= ENVELOPE,
                        f"multirank gloo default: embeddings {r['emb_max_abs_err']} apart",
                    )
                req = r["mesh_request_launches"]
                check(
                    req["pack_frames"] == per_rank and req["linkage"] == 1,
                    f"multirank gloo {mode}: rank {r['rank']} launched {req} in one mesh request",
                )
            emit(
                {
                    "multirank": f"world 2, gloo, both ranks on cuda:0, {mode}",
                    "wall_s": wall_s,
                    "ranks": reports,
                }
            )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return totals


def http_post(url, data=b""):
    """(status, body) of a POST: the JSON body, else the text."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, body, ctype = r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as err:
        status, body, ctype = err.code, err.read(), err.headers.get("Content-Type")
    return status, (json.loads(body) if ctype == "application/json" else body.decode())


def raw_post_status(url, path, headers):
    """The status of a POST sent with exactly ``headers`` and no body."""
    import http.client

    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.putrequest("POST", path)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        return conn.getresponse().status
    finally:
        conn.close()


def wav_bytes(clip: np.ndarray) -> bytes:
    """``clip`` (int16-exact floats) as a 16-bit RIFF WAV."""
    import tempfile

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.io import wav as wavio

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.wav")
        wavio.write_wav(path, clip * 32768.0, 16000, 16)
        with open(path, "rb") as f:
            return f.read()


class served:
    """runtime/server.py's ``serve`` for ``service`` on an ephemeral port,
    in a thread; ``url`` while open, stopped and closed on exit."""

    def __init__(self, service, **kwargs):
        import threading

        from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime.server import serve

        self.server = serve(service, host="127.0.0.1", port=0, **kwargs)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def concurrently(fns):
    """Each fn() in its own thread, all started together: their results, in
    order, and the wall ms until the last returned. A raise in one raises
    here."""
    import threading

    results, errors = [None] * len(fns), []

    def run(i):
        try:
            results[i] = fns[i]()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if errors:
        raise errors[0]
    return results, wall_ms


def server_phase(torch, counters):
    """The HTTP server (runtime/server.py) at full width on the card: the
    default pipeline (seeded weights) behind ``serve`` on an ephemeral port.
    ``/diarize`` of the 59 s clip as a 16-bit WAV, JSON and RTTM, equals a
    direct ``pipeline(clip)`` (three serial requests: client and server
    walls, launches a request as the main path's); four concurrent requests
    (59, 30, 12.3 and 45 s) each equal their serial answer, the wall of the
    four beside the serial sum; a float32 service at precision "highest"
    (whose requests share ``precision_scope`` across the server's threads)
    gives under four concurrent requests the turns and embeddings of its
    serial ones; an HTTP stream (open, 1 s int16 feeds, close) equals a
    ``StreamingDiarizer`` fed the same blocks directly, emission by
    emission; /health counts, 404, 413, a bad Content-Length, malformed
    integer queries (400) and the stream cap (429). Returns each kernel's
    launches over the phase."""
    import urllib.request

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.streaming import (
        StreamingDiarizer,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime.server import (
        DiarizationService,
        _turns_json,
    )

    def counts():
        return {name: getattr(k, attr) for name, (k, attr, _) in counters.items()}

    def since(before):
        return {name: n - before[name] for name, n in counts().items()}

    pipe = SpeakerDiarizationPipeline(seed=0)
    clip = synth_clip(59.0, seed=0, quantize=True)
    body = wav_bytes(clip)
    want = pipe(clip)  # warm
    expected = per_request_launches(pipe, clip, counters)
    for kernel, attr, _ in counters.values():
        setattr(kernel, attr, 0)
    service = DiarizationService(pipe, max_streams=2)
    report = {"server": "runtime/server.py, default pipeline on the card"}
    with served(service) as url:
        # serial requests: JSON equal to the direct call, launches as the
        # main path's, walls
        walls, server_walls = [], []
        for _ in range(3):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            status, got = http_post(f"{url}/diarize", body)
            walls.append((time.perf_counter() - t0) * 1e3)
            launched = since(before)
            check(status == 200, f"server: /diarize answered {status}: {got}")
            check(got["turns"] == _turns_json(want), "server: /diarize turns differ from the direct call")
            check(launched == expected, f"server: launches {launched}, expected {expected}")
            server_walls.append(got["wall_seconds"] * 1e3)
        status, rttm = http_post(f"{url}/diarize?format=rttm", body)
        check(status == 200 and rttm == want.to_rttm("stream") + "\n", "server: RTTM differs")
        report.update(
            {
                "turns": len(want.turns()),
                "json_equal_direct": True,
                "rttm_equal_direct": True,
                "request_wall_ms": walls,
                "server_wall_ms": server_walls,
                "launches_a_request": expected,
            }
        )
        # four concurrent requests, each against its serial answer
        lengths = (59.0, 30.0, 12.3, 45.0)
        bodies = [body] + [wav_bytes(clip[: int(s * 16000)]) for s in lengths[1:]]
        t0 = time.perf_counter()
        serial = [http_post(f"{url}/diarize", b)[1]["turns"] for b in bodies]
        serial_ms = (time.perf_counter() - t0) * 1e3
        answers, concurrent_ms = concurrently(
            [lambda b=b: http_post(f"{url}/diarize", b)[1]["turns"] for b in bodies]
        )
        check(answers == serial, "server: a concurrent request differs from its serial answer")
        report["concurrent"] = {"audio_s": lengths, "wall_ms": concurrent_ms, "serial_sum_ms": serial_ms}
        # an HTTP stream against StreamingDiarizer fed directly
        blocks = np.array_split(clip, 59)
        direct = StreamingDiarizer(pipe, emit_every=8)
        direct_emits = []
        for block in blocks:
            ann = direct.feed(block)
            direct_emits.append(None if ann is None else _turns_json(ann))
        direct_final = _turns_json(direct.flush())
        sid = http_post(f"{url}/stream/open?emit_every=8")[1]["stream_id"]
        feed_ms, http_emits = [], []
        for block in blocks:
            pcm = np.round(block * 32768.0).astype("<i2").tobytes()
            t0 = time.perf_counter()
            status, got = http_post(f"{url}/stream/feed?id={sid}", pcm)
            feed_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"server: stream feed answered {status}: {got}")
            http_emits.append(got["turns"])
        status, final = http_post(f"{url}/stream/close?id={sid}")
        check(status == 200 and final["stream_seconds"] == 59.0, f"server: close {status} {final}")
        check(http_emits == direct_emits, "server: the HTTP stream's emissions differ")
        check(final["turns"] == direct_final, "server: the HTTP stream's flush differs")
        emitting = [ms for ms, e in zip(feed_ms, http_emits) if e is not None]
        report["stream"] = {
            "feeds": len(blocks),
            "emissions": len(emitting),
            "emitting_feed_ms_median": statistics.median(emitting),
            "other_feed_ms_median": statistics.median(
                [ms for ms, e in zip(feed_ms, http_emits) if e is None]
            ),
            "equal_direct": True,
        }
        # the error answers
        health = json.load(urllib.request.urlopen(f"{url}/health"))
        a = http_post(f"{url}/stream/open")[1]["stream_id"]
        b = http_post(f"{url}/stream/open")[1]["stream_id"]
        answers = {
            "health_requests": health["requests"],
            "404": http_post(f"{url}/nope")[0],
            "bad_content_length": raw_post_status(url, "/diarize", {"Content-Length": "x"}),
            "malformed_emit_every": http_post(f"{url}/stream/open?emit_every=abc")[0],
            "malformed_num_speakers": http_post(f"{url}/diarize?num_speakers=two", body)[0],
            "429_third_stream": http_post(f"{url}/stream/open")[0],
            "unknown_stream": http_post(f"{url}/stream/feed?id=zz")[0],
        }
        for sid in (a, b):
            http_post(f"{url}/stream/close?id={sid}")
    with served(service, max_request_bytes=1024) as url:
        answers["413"] = http_post(f"{url}/diarize", body)[0]
    check(
        answers
        == {
            "health_requests": 4 + 2 * len(bodies),
            "404": 404,
            "bad_content_length": 400,
            "malformed_emit_every": 400,
            "malformed_num_speakers": 400,
            "429_third_stream": 429,
            "unknown_stream": 404,
            "413": 413,
        },
        f"server: error answers {answers}",
    )
    report["answers"] = answers
    # a float32 service at precision "highest": four concurrent requests
    # against serial ones, turns and embeddings
    f32 = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="float32", transfer_dtype="float32")
    hi = SpeakerDiarizationPipeline(f32, seed=0, precision="highest")
    hi(clip)  # warm
    kept = record_requests(hi)
    hi_service = DiarizationService(hi)
    with served(hi_service) as url:
        serial = [http_post(f"{url}/diarize", b)[1]["turns"] for b in bodies]
        serial_emb = {p["num_samples"]: p["emb"].clone() for p in kept}
        kept.clear()
        answers, hi_ms = concurrently(
            [lambda b=b: http_post(f"{url}/diarize", b)[1]["turns"] for b in bodies]
        )
    check(answers == serial, "server highest: a concurrent request's turns differ")
    errs = [float((p["emb"] - serial_emb[p["num_samples"]]).abs().max()) for p in kept]
    check(len(kept) == 4, f"server highest: {len(kept)} dispatches recorded")
    bit_equal = all(torch.equal(p["emb"], serial_emb[p["num_samples"]]) for p in kept)
    check(
        all(within(torch, p["emb"], serial_emb[p["num_samples"]], 1e-5, 1e-6) for p in kept),
        f"server highest: concurrent embeddings differ from serial ones by {max(errs)}",
    )
    report["highest"] = {
        "concurrent_wall_ms": hi_ms,
        "turns_equal": True,
        "embeddings_bit_equal": bit_equal,
        "embeddings_max_abs_err": max(errs),
        "tf32_flags_after": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
    }
    totals = counts()
    report["launches"] = totals
    emit(report)
    del pipe, hi
    return totals


def strict_send(torch, control):
    """From here on every broadcast of ``control`` (a runtime/server.py
    ``MeshControl``) runs under sync debug mode "error", as
    ``strict_dispatch`` does for a pipeline's dispatch."""
    send = control.send

    def strict(*args, **kwargs):
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return send(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(previous)

    control.send = strict
    return control


def mesh_clips():
    """The 59, 30, 12.3 and 45 s requests of the server phases."""
    clip = synth_clip(59.0, seed=0, quantize=True)
    return [clip[: int(s * 16000)] for s in (59.0, 30.0, 12.3, 45.0)]


def served_turns(url, body):
    """The JSON turns of a /diarize of ``body``, which must answer 200."""
    status, got = http_post(f"{url}/diarize", body)
    check(status == 200, f"server_mesh: /diarize answered {status}: {got}")
    return got["turns"]


def http_stream(url, blocks, emit_every=8):
    """An HTTP stream of ``blocks`` (int16 feeds): each feed's turns (None
    where it emitted nothing), then the close's."""
    sid = http_post(f"{url}/stream/open?emit_every={emit_every}")[1]["stream_id"]
    emits = []
    for block in blocks:
        pcm = np.round(block * 32768.0).astype("<i2").tobytes()
        status, got = http_post(f"{url}/stream/feed?id={sid}", pcm)
        check(status == 200, f"server_mesh: stream feed answered {status}: {got}")
        emits.append(got["turns"])
    status, final = http_post(f"{url}/stream/close?id={sid}")
    check(status == 200, f"server_mesh: stream close answered {status}: {final}")
    return emits, final["turns"]


def server_mesh_rank(mesh, ckpt):
    """One of two gloo ranks sharing cuda:0 in ``server_mesh_phase`` (b):
    the float32 "highest" pipeline on the mesh, each dispatch's kernel
    launches kept. A follower runs ``follow``; rank 0 serves and holds the
    served answers against direct calls of a one-rank pipeline on the same
    card, serial and concurrent, then sends ``stop``."""
    import torch

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import load_checkpoint
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.streaming import (
        StreamingDiarizer,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import server as srv

    f32 = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="float32", transfer_dtype="float32")
    params = load_checkpoint(ckpt)
    start = dryrun.kernel_launches()
    pipe = SpeakerDiarizationPipeline(f32, params=params, precision="highest", mesh=mesh)
    dispatches = []
    launch = pipe._dispatch

    def recording(*args, **kwargs):
        before = dryrun.kernel_launches()
        out = launch(*args, **kwargs)
        dispatches.append(dryrun._since(before))
        return out

    pipe._dispatch = recording
    control = srv.MeshControl(mesh, timeout=120.0)
    if mesh.rank:
        out = srv.follow(pipe, control)
        return {**out, "dispatch_launches": dispatches, "launches": dryrun._since(start)}
    single = SpeakerDiarizationPipeline(f32, params=params, precision="highest", device=mesh.device)
    clips = mesh_clips()
    bodies = [wav_bytes(c) for c in clips]
    direct = [srv._turns_json(single(c)) for c in clips]
    blocks = np.array_split(clips[0], 59)
    stream = StreamingDiarizer(single, emit_every=8)
    direct_emits = []
    for block in blocks:
        ann = stream.feed(block)
        direct_emits.append(None if ann is None else srv._turns_json(ann))
    direct_final = srv._turns_json(stream.flush())
    service = srv.DiarizationService(pipe, control=control)
    report = {}
    with served(service) as url:
        served_turns(url, bodies[0])  # warm: the mesh pipeline's first request
        serial_ms, serial = [], []
        for b in bodies:
            t0 = time.perf_counter()
            serial.append(served_turns(url, b))
            serial_ms.append((time.perf_counter() - t0) * 1e3)
        check(serial == direct, "server_mesh gloo: served turns differ from the one-rank call's")
        single_ms = [timed(torch, lambda c=c: single(c))[1] for c in clips]
        emits, final = http_stream(url, blocks)
        check(emits == direct_emits, "server_mesh gloo: the stream's emissions differ")
        check(final == direct_final, "server_mesh gloo: the stream's close differs from the flush")
        fns = [lambda b=b: served_turns(url, b) for b in bodies]
        fns.append(lambda: http_stream(url, blocks))
        answers, concurrent_ms = concurrently(fns)
        check(answers[:4] == serial, "server_mesh gloo: a concurrent request differs from serial")
        check(answers[4] == (emits, final), "server_mesh gloo: the interleaved stream differs")
        report.update(
            {
                "turns": [len(t) for t in serial],
                "served_equal_one_rank": True,
                "stream_equal_flush": True,
                "concurrent_equal_serial": True,
                "audio_s": [len(c) / 16000 for c in clips],
                "served_wall_ms": serial_ms,
                "one_rank_direct_ms": single_ms,
                "concurrent_with_stream_wall_ms": concurrent_ms,
                "stream_feeds": len(blocks),
            }
        )
    service.close()
    report["ops"] = dict(control.ops)
    return {**report, "dispatch_launches": dispatches, "launches": dryrun._since(start)}


def server_mesh_phase(torch, counters):
    """The server over a mesh (runtime/server.py ``--mesh``) at full width.
    (a) One NCCL rank on the card: the default pipeline on the mesh behind
    ``MeshControl`` and the mesh-less service, side by side: /diarize of the
    59 s clip (JSON and RTTM) equal string for string, launches a request
    as the main path's, each mesh dispatch and broadcast under sync debug
    mode "error" after the first; walls in turns (mesh-less, mesh, mesh,
    mesh-less), and four concurrent requests (59, 30, 12.3 and 45 s) on the
    mesh against their serial sum. (b) Two gloo ranks sharing cuda:0 (NCCL
    refuses two ranks on one card), spawned, float32 at precision
    "highest" (``server_mesh_rank``): served turns equal a one-rank call's,
    the HTTP stream (1 s feeds) equals ``StreamingDiarizer`` fed directly
    and its close the flush, the four requests and the stream at once
    equal serial ones, each rank runs half of a 59 s request's stage-2
    batches, and ``stop`` ends both ranks with exit 0 (spawn returns).
    Returns each kernel's launches over the phase, both ranks' included."""
    import shutil
    import tempfile
    import urllib.request

    import torch.distributed as dist

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import (
        params_to_jax,
        save_checkpoint,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import _cuda_lib
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.mesh import make_mesh
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import native_bindings
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import server as srv

    def counts():
        return {name: getattr(k, attr) for name, (k, attr, _) in counters.items()}

    totals = {name: 0 for name in counters}
    start = counts()
    # the ranks load what the parent built: two ranks would race nvcc and g++
    _cuda_lib.build()
    native_bindings.build()
    clips = mesh_clips()
    bodies = [wav_bytes(c) for c in clips]
    report = {"server_mesh": "runtime/server.py --mesh"}

    # (a) world size 1, NCCL
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}", world_size=1, rank=0
    )
    try:
        mesh = make_mesh()
        plain = SpeakerDiarizationPipeline(seed=0)
        on_mesh = srv.build_pipeline(mesh=mesh)
        control = srv.MeshControl(mesh)
        plain_service = srv.DiarizationService(plain)
        mesh_service = srv.DiarizationService(on_mesh, control=control)
        expected = per_request_launches(on_mesh, clips[0], counters)
        with served(plain_service) as plain_url, served(mesh_service) as mesh_url:
            want = http_post(f"{plain_url}/diarize", bodies[0])[1]
            http_post(f"{mesh_url}/diarize", bodies[0])  # the first: NCCL's communicator
            strict_dispatch(torch, on_mesh)
            strict_send(torch, control)
            walls = {"meshless": [], "mesh": []}
            for which in ("meshless", "mesh", "mesh", "meshless") * 2:
                url = mesh_url if which == "mesh" else plain_url
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                status, got = http_post(f"{url}/diarize", bodies[0])
                walls[which].append((time.perf_counter() - t0) * 1e3)
                check(status == 200, f"server_mesh nccl: /diarize answered {status}: {got}")
                check(got["turns"] == want["turns"], f"server_mesh nccl: {which} turns differ")
                launched = {n: c - before[n] for n, c in counts().items()}
                check(launched == expected, f"server_mesh nccl: {which} launched {launched}")
            rttm = [http_post(f"{u}/diarize?format=rttm", bodies[0])[1] for u in (plain_url, mesh_url)]
            check(rttm[0] == rttm[1], "server_mesh nccl: the RTTM differs from the mesh-less one")
            # the debug mode is the process's: a concurrent request's collect
            # (which waits for the card) would raise under another's dispatch
            del on_mesh._dispatch, on_mesh._run_range, control.send
            t0 = time.perf_counter()
            serial = [served_turns(mesh_url, b) for b in bodies]
            serial_ms = (time.perf_counter() - t0) * 1e3
            answers, concurrent_ms = concurrently(
                [lambda b=b: served_turns(mesh_url, b) for b in bodies]
            )
            check(answers == serial, "server_mesh nccl: a concurrent request differs from serial")
            health = json.load(urllib.request.urlopen(f"{mesh_url}/health"))
        mesh_service.close()
        report["nccl_world_1"] = {
            "turns": len(want["turns"]),
            "json_equal_meshless": True,
            "rttm_equal_meshless": True,
            "dispatch_sync_debug": "error",
            "request_wall_ms": walls,
            "concurrent": {
                "audio_s": [len(c) / 16000 for c in clips],
                "wall_ms": concurrent_ms,
                "serial_sum_ms": serial_ms,
            },
            "health": health,
            "ops": dict(control.ops),
        }
        del plain, on_mesh, plain_service, mesh_service
    finally:
        dist.destroy_process_group()
    totals = {n: c - start[n] for n, c in counts().items()}

    # (b) world size 2, gloo, both ranks on cuda:0
    f32 = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="float32", transfer_dtype="float32")
    tmp = tempfile.mkdtemp()
    try:
        source = SpeakerDiarizationPipeline(f32, seed=0, precision="highest")
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, params_to_jax(source.segmentation_model, source.embedding_model))
        del source
        t0 = time.perf_counter()
        ranks = dryrun.spawn(server_mesh_rank, 2, ckpt, device="cuda", share_card=True, timeout=600)
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rank0, follower = ranks
    half = expected["pack_frames"] // 2  # a rank's block of a 59 s request's batches
    for r in ranks:
        for name, n in r["launches"].items():
            totals[name] += n
        first = r["dispatch_launches"][0]
        check(
            first["pack_frames"] == first["asp_pool_float32"] == half and first["linkage"] == 1,
            f"server_mesh gloo: a rank launched {first} in the 59 s request",
        )
    ops = {k: v for k, v in follower["ops"].items() if k != "heartbeat"}
    check(
        ops == {k: v for k, v in rank0["ops"].items() if k != "heartbeat"} and follower["errors"] == 0,
        f"server_mesh gloo: the follower received {follower['ops']}, rank 0 sent {rank0['ops']}",
    )
    report["gloo_world_2_shared_card"] = {
        **{k: v for k, v in rank0.items() if k not in ("dispatch_launches", "launches")},
        "first_request_launches_a_rank": [r["dispatch_launches"][0] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "follower_errors": follower["errors"],
        "spawn_wall_s": wall_s,
    }
    report["launches"] = totals
    emit(report)
    return totals


def grads_of(torch, params):
    """{dot-joined key: a CPU copy of its gradient} of a parameter tree."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import flatten_pytree

    return {k: p.grad.detach().cpu() for k, p in flatten_pytree(params).items()}


# the card's float32 gradients against the CPU's: the largest relative L2
# distance of a whole gradient the check lets through, for each model. On
# an H100 the sound first steps read 3.1e-7 (PyanNet) and 1.45e-5 (ECAPA),
# and the same steps with cuDNN's TF32 on (``tf32_control``) 5.3e-5 and
# 8.2e-4; each limit lies near the geometric mean of its model's two
# readings, and the phase fails unless the control reads above it
GRAD_REL_L2 = {"pit_bce": 4e-6, "aam": 1e-4}


def grad_agreement(cpu: dict, card: dict) -> dict:
    """Card gradients against CPU ones: the relative L2 distance of the
    whole gradient (the check wants it within ``GRAD_REL_L2``), and leaf
    by leaf against an allowance of 1e-2 of the leaf's largest CPU gradient
    plus 1e-4 of the model's largest. Both devices
    round in float32, and a sum that cancels (a weight gradient over 9600
    frames) keeps the rounding of its terms: leaves deep below the LSTM
    (SincNet's, orders of magnitude below the model's largest) and biases
    whose gradient is 0 in exact arithmetic (a per-channel shift that an
    instance norm or the ASP softmax cancels) are rounding against
    themselves. Returns the worst leaf's largest difference over its
    allowance (<= 1 passes), its key, and the relative L2 distance."""
    top = max(float(g.abs().max()) for g in cpu.values())
    worst, key, num, den = 0.0, "", 0.0, 0.0
    for k, want in cpu.items():
        diff = (card[k] - want).double()
        allowance = 1e-2 * float(want.abs().max()) + 1e-4 * top
        if float(diff.abs().max()) / allowance > worst:
            worst, key = float(diff.abs().max()) / allowance, k
        num += float((diff**2).sum())
        den += float((want.double() ** 2).sum())
    return {"worst_over_allowance": worst, "worst_leaf": key, "rel_l2": (num / den) ** 0.5}


def tf32_control(torch, make_trainer, batch, cpu_grads: dict) -> dict:
    """``grad_agreement`` of the first step run with precision "default"
    (PyTorch's own flags: cuDNN's convolutions and RNNs in TF32, cuBLAS in
    float32), the precision that a ``precision_scope`` leaking its flags
    would give a "highest" step: the check must fail it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        trainer = make_trainer()
        trainer.step(*batch)
        return grad_agreement(cpu_grads, grads_of(torch, trainer.params))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def training_phase(torch, counters):
    """Training (models/training.py, models/trainer.py, utils/checkpoint.py)
    at full width on the card, TF32 off (``precision_scope("highest")``):

      - PIT-BCE on the default PyanNet, a batch of 32 x 80000 samples, 3
        classes: the first step's loss and gradients on the card against
        the same step on the CPU (loss rtol 1e-4; each leaf's gradients
        within their allowance, ``grad_agreement``; the step with cuDNN's
        TF32 on must fail that check, ``tf32_control``), then Adam steps timed (ms
        a step); the LSTM's cuDNN backward runs (its weights' gradients
        nonzero);
      - AAM-softmax on the default ECAPA-TDNN, features 32 x 300 frames x 80
        mels, a 7205-class head (speechbrain's VoxCeleb recipe), lr 1e-3:
        the same card-against-CPU check; the float32 ASP kernel launched
        once a forward; every trunk parameter with a gradient, nonzero but
        the ASP conv's bias (0 in exact arithmetic: the softmax cancels it);
        the BatchNorm running statistics moved; the kernel's backward
        against autograd through ``asp_pool_plain`` on the step's own ASP
        inputs; ms a step;
      - resume: under ``torch.use_deterministic_algorithms(True)``, PyanNet
        steps 1-2, a checkpoint, a fresh trainer restoring it and steps 3-4
        bit-equal to four uninterrupted steps (losses and every state leaf);
        ECAPA's reflect padding has no deterministic CUDA backward, so it
        is not run there;
      - data-parallel: parallel/dryrun.py ``train_case`` (a slim PyanNet's
        PIT-BCE Adam step) on an NCCL mesh of world 1 in this process, and
        on two gloo ranks sharing cuda:0 with uneven blocks (5 rows), each
        equal to one process.

    Returns each kernel's launches over the phase."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ecapa as ecapa_mod
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import training as T
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import (
        ecapa_tree,
        pyannet_tree,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import (
        EcapaConfig,
        EcapaTDNN,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
        PyanNet,
        PyanNetConfig,
        pyannet_num_frames,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.trainer import (
        Trainer,
        segmentation_trainer,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.mesh import make_mesh
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        precision_scope,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils.checkpoint import tree_leaves

    for kernel, attr, _ in counters.values():
        setattr(kernel, attr, 0)
    rng = np.random.default_rng(0)
    report = {"training": "full width, precision highest"}

    def timed_steps(trainer, batch, steps=3):
        """(host ms of each step, ended by a wait for the card; the losses)."""
        times, losses = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.step(*batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times, losses

    # --- PIT-BCE, default PyanNet
    seg_cfg = PyanNetConfig()
    seg_params = pyannet_tree(PyanNet(seg_cfg))
    frames = pyannet_num_frames(80000, seg_cfg)
    seg_batch = (
        (0.1 * rng.normal(size=(32, 80000))).astype(np.float32),
        (rng.uniform(size=(32, frames, seg_cfg.num_classes)) > 0.7).astype(np.float32),
    )
    with precision_scope("highest"):
        cpu = segmentation_trainer(seg_params, seg_cfg, device="cpu")
        card = segmentation_trainer(seg_params, seg_cfg)
        loss_cpu, loss_card = cpu.step(*seg_batch), card.step(*seg_batch)
        cpu_grads = grads_of(torch, cpu.params)
        agree = grad_agreement(cpu_grads, grads_of(torch, card.params))
        lstm_grad = float(card.params["lstm"][0]["fwd"]["weight_hh"].grad.abs().max())
        seg_ms, seg_losses = timed_steps(card, seg_batch)
    control = tf32_control(
        torch, lambda: segmentation_trainer(seg_params, seg_cfg), seg_batch, cpu_grads
    )
    check(
        np.isfinite(loss_card) and abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu),
        f"training pit-bce: loss {loss_card} on the card, {loss_cpu} on the CPU",
    )
    check(
        agree["worst_over_allowance"] <= 1 and agree["rel_l2"] <= GRAD_REL_L2["pit_bce"],
        f"training pit-bce: gradients {agree}",
    )
    check(
        control["rel_l2"] > GRAD_REL_L2["pit_bce"],
        f"training pit-bce: the TF32 control passes the gradient check {control}",
    )
    check(lstm_grad > 0, "training pit-bce: no LSTM gradient")
    report["pit_bce"] = {
        "batch": [32, 80000],
        "loss_card": loss_card,
        "loss_cpu": loss_cpu,
        "gradients": agree,
        "gradients_tf32_control": control,
        "lstm_backward": "cudnn, train mode",
        "ms_a_step": seg_ms,
        "losses": [loss_card] + seg_losses,
    }
    del cpu, card, cpu_grads

    # --- AAM-softmax, default ECAPA-TDNN, 7205 classes
    emb_cfg = EcapaConfig()
    both = {
        "params": ecapa_tree(EcapaTDNN(emb_cfg)),
        "head": T.init_aam_head(torch.Generator().manual_seed(0), emb_cfg.emb_dim, 7205),
    }
    emb_batch = (
        rng.normal(size=(32, 300, 80)).astype(np.float32),
        rng.uniform(0.6, 1.0, size=32).astype(np.float32),
        rng.integers(0, 7205, size=32),
    )
    seen = []
    real_asp = ecapa_mod.asp_pool

    def watched_asp(*args, **kwargs):
        if not seen:
            seen.append([t.detach().clone() for t in args[:5]])
        return real_asp(*args, **kwargs)

    def make(mesh):
        return T.make_embedding_train_step(emb_cfg, mesh)

    with precision_scope("highest"):
        cpu = Trainer(both, make, device="cpu")
        card = Trainer(both, make)
        loss_cpu = cpu.step(*emb_batch)
        ecapa_mod.asp_pool = watched_asp
        try:
            before = asp_cuda.asp_pool.float32_launches
            loss_card = card.step(*emb_batch)
            launched = asp_cuda.asp_pool.float32_launches - before
        finally:
            ecapa_mod.asp_pool = real_asp
        card_grads = grads_of(torch, card.params)
        cpu_grads = grads_of(torch, cpu.params)
        agree = grad_agreement(cpu_grads, card_grads)
        trunk = {k: g for k, g in card_grads.items() if k.startswith("params.")}
        zero = [k for k, g in trunk.items() if not float(g.abs().max()) > 0]
        bn_before = both["params"]["mfa"]["bn"]["running_var"]
        emb_ms, emb_losses = timed_steps(card, emb_batch)
        bn_moved = not np.array_equal(card.params["params"]["mfa"]["bn"]["running_var"].detach().cpu().numpy(), bn_before)
        # the kernel's backward on the step's own ASP inputs
        x, a, w, b, mask = seen[0]
        leaves = [t.requires_grad_() for t in (x, a, w, b)]
        mean, std = asp_cuda.asp_pool(*leaves, mask)
        gm, gs = torch.randn_like(mean), torch.randn_like(std)
        got = torch.autograd.grad((mean * gm + std * gs).sum(), leaves)
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        pm, ps = asp_cuda.asp_pool_plain(*ref, mask)
        want = torch.autograd.grad((pm * gm + ps * gs).sum(), ref)
        bwd = {
            name: float((g - h).abs().max()) / float(h.abs().max())
            for name, g, h in zip(("x", "a_tanh", "w"), got, want)
        }
        bias_rel = max(float(got[3].abs().max()), float(want[3].abs().max())) / float(want[2].abs().max())
        fwd_ms = time_ms(torch, lambda: asp_cuda.asp_pool(*leaves, mask), reps=10)
        bwd_ms = time_ms(
            torch,
            lambda: asp_cuda.asp_pool_backward(*[t.detach() for t in leaves], mask, 1e-12, gm, gs),
            reps=10,
        )
    control = tf32_control(torch, lambda: Trainer(both, make), emb_batch, cpu_grads)
    check(launched == 1, f"training aam: the float32 ASP kernel launched {launched} times a step")
    check(
        np.isfinite(loss_card) and abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu),
        f"training aam: loss {loss_card} on the card, {loss_cpu} on the CPU",
    )
    check(
        agree["worst_over_allowance"] <= 1 and agree["rel_l2"] <= GRAD_REL_L2["aam"],
        f"training aam: gradients {agree}",
    )
    check(
        control["rel_l2"] > GRAD_REL_L2["aam"],
        f"training aam: the TF32 control passes the gradient check {control}",
    )
    check(zero == ["params.asp.conv.bias"] or not zero, f"training aam: no gradient for {zero}")
    check(bn_moved, "training aam: the BatchNorm running statistics did not move")
    check(max(bwd.values()) <= 1e-4 and bias_rel <= 1e-3, f"training aam: ASP backward {bwd}, bias {bias_rel}")
    report["aam"] = {
        "feats": [32, 300, 80],
        "classes": 7205,
        "loss_card": loss_card,
        "loss_cpu": loss_cpu,
        "gradients": agree,
        "gradients_tf32_control": control,
        "asp_float32_launches_a_step": launched,
        "trunk_leaves": len(trunk),
        "trunk_leaves_zero_grad": zero,
        "batchnorm_statistics_moved": bn_moved,
        "asp_backward_rel_err": bwd,
        "asp_bias_grad_rel": bias_rel,
        "asp_forward_kernel_ms": fwd_ms,
        "asp_backward_ms": bwd_ms,
        "ms_a_step": emb_ms,
        "losses": [loss_card] + emb_losses,
    }
    del cpu, card, seen, cpu_grads

    # --- resume, deterministic
    tmp = tempfile.mkdtemp()
    torch.use_deterministic_algorithms(True)
    try:
        with precision_scope("highest"):
            batches = [
                ((0.1 * rng.normal(size=(32, 80000))).astype(np.float32), seg_batch[1])
                for _ in range(4)
            ]
            ref = segmentation_trainer(seg_params, seg_cfg)
            ref_losses = [ref.step(*b) for b in batches]
            first = segmentation_trainer(seg_params, seg_cfg)
            losses = [first.step(*b) for b in batches[:2]]
            first.save_checkpoint(tmp)
            fresh = segmentation_trainer(pyannet_tree(PyanNet(seg_cfg, torch.Generator().manual_seed(9))), seg_cfg)
            check(fresh.restore_checkpoint(tmp) == 2, "training resume: wrong step restored")
            losses += [fresh.step(*b) for b in batches[2:]]
            state_equal = all(
                torch.equal(torch.as_tensor(p).cpu(), torch.as_tensor(q).cpu())
                for p, q in zip(tree_leaves(T.train_state_tree(ref.state)), tree_leaves(T.train_state_tree(fresh.state)))
            )
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    check(losses == ref_losses and state_equal, f"training resume: {losses} against {ref_losses}")
    report["resume"] = {"deterministic": True, "losses": losses, "bit_equal": True}
    del ref, first, fresh

    # --- data-parallel: NCCL world 1, then two gloo ranks on cuda:0
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}", world_size=1, rank=0
    )
    try:
        nccl = dryrun.train_case(make_mesh())
    finally:
        dist.destroy_process_group()
    gloo = dryrun.spawn(dryrun.train_case, 2, 5, device="cuda", share_card=True, timeout=300)
    check(
        [r["rows"] for r in gloo] == [3, 2]
        and gloo[0]["loss"] == gloo[1]["loss"]
        and gloo[0]["params_digest"] == gloo[1]["params_digest"],
        f"training dp: the gloo ranks differ {gloo}",
    )
    report["data_parallel"] = {"nccl_world_1": nccl, "gloo_world_2_cuda0": gloo}
    totals = {name: getattr(k, attr) for name, (k, attr, _) in counters.items()}
    report["launches"] = totals
    emit(report)
    return totals


def accuracy_loop_phase(torch, counters):
    """The closed accuracy loop of the JAX package's
    tests/test_accuracy_loop.py on the card (tests/_torch_accuracy.py):
    PyanNet (small widths) trained with PIT-BCE from its seeded init until
    its loss is below 0.06 after step 300, ECAPA-TDNN (small widths) 150
    AAM-softmax steps with a 2-class head on the front-end's features, both
    at precision "highest" under deterministic algorithms (``main`` sets
    the cuBLAS workspace this needs); the two speakers' embeddings must
    separate; the tiny1s pipeline with the trained weights at the port's
    defaults diarizes a composed 12 s conversation with ``num_speakers=2``
    (the host clustering route) at DER < 0.25 with exactly 2 speakers. One
    more request without a bound (stage 3 and its merge-loop kernel on the
    card) is reported only. Emits steps, losses, separation, DER, labels,
    wall seconds of each part (and the host's seconds making the training
    batches), the kernels launched in each part and the card; returns each
    kernel's launches over the phase."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _torch_accuracy import failures, run_accuracy_loop

    for kernel, attr, _ in counters.values():
        setattr(kernel, attr, 0)
    parts = {}

    def mark(part):
        parts[part] = {name: getattr(k, attr) for name, (k, attr, _) in counters.items()}

    report = run_accuracy_loop(mark=mark)
    previous = dict.fromkeys(counters, 0)
    launches = {}
    for part, now in parts.items():
        launches[part] = {name: now[name] - previous[name] for name in now}
        previous = now
    emit(
        {
            "accuracy_loop": report,
            "launches": launches,
            "failed_thresholds": failures(report),
            "nvidia_smi": nvidia_smi_line(),
        }
    )
    check(not failures(report), f"accuracy loop: {failures(report)}")
    training, diarization = launches["training"], launches["diarization"]
    check(
        training["log_mel"] > 0 and training["asp_pool_float32"] > 0,
        f"accuracy loop: training launched {training}",
    )
    check(
        min(diarization[k] for k in ("pack_frames", "log_mel", "asp_pool")) > 0,
        f"accuracy loop: the diarization launched {diarization}",
    )
    return previous


def main() -> int:
    # the training phase's resume check and the accuracy loop run cuBLAS in
    # deterministic mode, which needs this set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import (
        _cuda_lib,
        asp_cuda,
        frontend_cuda,
        linkage_cuda,
        pack_cuda,
    )

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import native_bindings

    smi = nvidia_smi_line()
    build_s = _cuda_lib.build()
    native_build_s = native_bindings.build()
    ptxas = {
        name: [
            ln.strip()
            for ln in _cuda_lib.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln
        ]
        for name in _cuda_lib.KERNELS
    }
    emit(
        {
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "build_s": build_s,
            "native_build_s": native_build_s,
            "ptxas": ptxas,
        }
    )
    # each phase's host wall seconds, printed before the summary
    phase_s = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(torch, *args)
        phase_s[phase.__name__] = time.perf_counter() - t0
        return out

    kernels = run(kernel_phase)
    clustering = run(clustering_phase)
    # the linkage kernel at the main path's merge-loop size (T = 384)
    kernels["linkage"] = clustering["blobs_T384_chunks128"]
    run(parity_phase)
    run(default_numerics_phase)
    counters = {
        "pack_frames": (pack_cuda.pack_frames, "launches", None),
        "log_mel": (frontend_cuda.log_mel_spectrogram, "launches", None),
        "asp_pool": (asp_cuda.asp_pool, "bfloat16_launches", None),
        # the float32 kernel serves precision="highest": none on the main path
        "asp_pool_float32": (asp_cuda.asp_pool, "float32_launches", 0),
        # the whole merge loop of stage 3: one launch a request
        "linkage": (linkage_cuda.linkage_labels, "launches", 1),
    }
    totals, expected = run(main_path_phase, counters)
    # the float32 path: the float32 kernel, counted from 0 over its requests
    totals["asp_pool_float32"] = run(float32_requests_phase, counters)["asp_pool_float32"]
    # the other paths: every kernel's launches there added
    for phase in (
        entry_points_phase,
        layouts_phase,
        ingest_phase,
        streaming_phase,
        longform_phase,
        multirank_phase,
        server_phase,
        server_mesh_phase,
        training_phase,
        accuracy_loop_phase,
    ):
        for name, n in run(phase, counters).items():
            totals[name] += n
    run(sinc_conv_phase)
    emit({"phase_wall_s": phase_s})
    pkg = "pyannote_audio_speaker_diarization_cpp_tpu_torch"
    tpu = "pyannote_audio_speaker_diarization_cpp_tpu"
    rows = [
        ("pack_frames", "pack_frames", f"{pkg}/csrc/pack.cu", f"{tpu}/ops/pack_pallas.py:93"),
        ("log_mel", "log_mel", f"{pkg}/csrc/frontend.cu", f"{tpu}/ops/frontend_pallas.py:67"),
        ("asp_pool", "asp_pool_bfloat16", f"{pkg}/csrc/asp.cu", f"{tpu}/ops/asp_pallas.py:71"),
        (
            "asp_pool_float32",
            "asp_pool_float32",
            f"{pkg}/csrc/asp.cu",
            f"{tpu}/ops/asp_pallas.py:71",
        ),
        (
            "linkage",
            "linkage",
            f"{pkg}/csrc/linkage.cu",
            f"{tpu}/clustering/device.py:138",
        ),
    ]
    summary = []
    for name, key, source, replaces in rows:
        r = kernels[key]
        summary.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": totals[name],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": None,
            }
        )
    emit({"kernels": summary, "launches_expected_per_request": expected})
    print(smi, flush=True)
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
