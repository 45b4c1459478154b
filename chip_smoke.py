#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a JSON line on stdout:
  1. device: the card (as nvidia-smi reports its name and power limit),
     torch/CUDA versions, and the wall time of building the CUDA kernels
     from csrc/ (one nvcc per source, all started together);
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
  8. the kernel summary line (float32 ASP's launches from phase 7, the
     others' from phase 6), the nvidia-smi line, and last
     {"ok": true, "device": {...}}.

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


def profile_call(torch, fn, reps: int = 10):
    """(device kernels and copies a fn() call runs, their device ms a call),
    from ``reps`` warm calls under torch.profiler: the kernels' own run time,
    without the launch and event latency that a CUDA-event timing includes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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


def run_small5s(device: str, float32: bool, params=None, device_clustering="auto"):
    """One request of the small5s test configuration (the real 5 s / 0.5 s
    recipe, small model widths) on the 12.3 s int16 clip: float32 compute
    and transfer at precision "highest" (TF32 off), or the defaults (bf16
    ECAPA trunk, f16 transfer, precision "default"). ``params``: a
    checkpoint tree, else seeded random weights. ``device_clustering``:
    "auto" must take the device stage 3, False the host route. Returns its
    embeddings, too_short flags, segmentations (on the CPU), the device
    stage 3's clusters (None on the host route) and turns."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
        precision_scope,
    )

    cfg = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)
    if float32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32", transfer_dtype="float32")
    pipe = SpeakerDiarizationPipeline(
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
    )
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
    # PyTorch's sync debug mode: all of them, and those inside stage 3
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
            pending = pipe._dispatch(clip)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            ecapa.asp_pool, mk.pack_frames = real_asp, real_pack
            diarization.stage3 = real_stage3
    torch.cuda.synchronize()
    def sync_lines(ws):
        return [str(w.message).splitlines()[0] for w in ws if "synchroniz" in str(w.message)]

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


def profile_request(torch, pipe, clip):
    """One more (uncounted) request under torch.profiler: device time by
    kernel, and the share of the request's wall time in which no device
    activity (kernel, copy, memset) ran. The profiler slows the host, so
    this idle share is an upper bound for the unprofiled requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(clip)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(device), "profile: no device activity was traced")
    busy_ms = union_length((e.time_range.start, e.time_range.end) for e in device) / 1e3
    by_name = {}
    for e in device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += (e.time_range.end - e.time_range.start) / 1e3
        acc[1] += 1
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(clip)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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


def main() -> int:
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

    smi = nvidia_smi_line()
    build_s = _cuda_lib.build()
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
            "ptxas": ptxas,
        }
    )
    kernels = kernel_phase(torch)
    clustering = clustering_phase(torch)
    # the linkage kernel at the main path's merge-loop size (T = 384)
    kernels["linkage"] = clustering["blobs_T384_chunks128"]
    parity_phase(torch)
    default_numerics_phase(torch)
    counters = {
        "pack_frames": (pack_cuda.pack_frames, "launches", None),
        "log_mel": (frontend_cuda.log_mel_spectrogram, "launches", None),
        "asp_pool": (asp_cuda.asp_pool, "bfloat16_launches", None),
        # the float32 kernel serves precision="highest": none on the main path
        "asp_pool_float32": (asp_cuda.asp_pool, "float32_launches", 0),
        # the whole merge loop of stage 3: one launch a request
        "linkage": (linkage_cuda.linkage_labels, "launches", 1),
    }
    totals, expected = main_path_phase(torch, counters)
    # this slice's path: the float32 kernel, counted from 0 over its requests
    totals["asp_pool_float32"] = float32_requests_phase(torch, counters)["asp_pool_float32"]
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
