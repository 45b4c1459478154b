#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a JSON line on stdout:
  1. device: the card (as nvidia-smi reports its name and power limit),
     torch/CUDA versions, and the wall time of building the CUDA kernels
     from csrc/ (one nvcc per source, all started together);
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the main path gives it (a 32-row stage-2 batch
     of 5 s windows), with its time, the plain version's time and the
     least time the card could take for the same work;
  3. parity: a small-model pipeline (real 5 s / 0.5 s recipe) run with the
     same weights on the card and on the CPU, in float32 with TF32 off:
     embeddings must agree and the turns must be equal;
  4. requests: the main path at full model width (default PyanNet and
     ECAPA-TDNN, default config: bf16 ECAPA trunk, f16 transfer), seeded
     random weights, three requests on a synthetic 59 s clip; every kernel
     must launch 12 times per request (128 padded chunks x 3 speakers / 32);
     then one more request under torch.profiler (device time by kernel);
  5. the kernel summary line, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.

Any failed check raises: the script then exits non-zero before the last
line. It imports nothing of JAX, and fails without a CUDA device or
without the package beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

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


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after ``warmup`` calls
    (no L2 flush between calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str):
    """(least ms, what bounds it): bytes over the memory rate vs operations
    over the peak rate of the operands' type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(torch, got, want, rtol, atol) -> bool:
    return bool(torch.isclose(got.float(), want.float(), rtol=rtol, atol=atol).all())


def kernel_phase(torch):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import FrontendConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import (
        asp_cuda,
        frontend as fe,
        frontend_cuda,
        pack_cuda,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {}

    # --- pack: 32 windows, keep masks of speech runs (p_keep cycling) ------
    wav = torch.from_numpy(rng.normal(size=(BATCH, WINDOW)).astype(np.float32)).to(dev)
    p_keep = np.array([0.0, 0.3, 0.7, 1.0] * (BATCH // 4))[:, None]
    runs = np.repeat(rng.uniform(size=(BATCH, FRAMES // 8 + 1)), 8, axis=1)[:, :FRAMES]
    keep = torch.from_numpy(runs < p_keep).to(dev)
    packed_k, lens_k = pack_cuda.pack_frames(wav, keep)
    packed_p, lens_p = pack_cuda.pack_frames_plain(wav, keep)
    torch.cuda.synchronize()
    exact = torch.equal(packed_k, packed_p) and torch.equal(lens_k, lens_p)
    err = float((packed_k - packed_p).abs().max())
    check(exact, f"pack kernel differs from its plain version (max abs {err})")
    # needed traffic: the kept samples read, every output written, the keep
    # flags (uint8) read and the lengths written
    kept = float(lens_p.sum())
    nbytes = 4.0 * (BATCH * WINDOW + kept) + BATCH * FRAMES + 4.0 * BATCH
    b, by = bound_ms(nbytes, 0.0, "float32")
    results["pack_frames"] = dict(
        max_abs_err=err,
        tolerance="bit-exact",
        kept_share=kept / (BATCH * WINDOW),
        bound_bytes=nbytes,
        ms=time_ms(torch, lambda: pack_cuda.pack_frames(wav, keep)),
        plain_ms=time_ms(torch, lambda: pack_cuda.pack_frames_plain(wav, keep)),
        bound_ms=b,
        bound_by=by,
        shapes="wav (32, 80000) f32, keep (32, 293) -> (32, 80000) f32, (32,) i32",
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
    frames = out_k.shape[1]
    win, ncol = basis.shape
    nf, n_mels = mel.shape
    flops = 2.0 * BATCH * frames * (win * ncol + nf * n_mels)
    nbytes = 4.0 * (BATCH * WINDOW + BATCH * frames * n_mels + basis.numel() + mel.numel())
    b, by = bound_ms(nbytes, flops, "float32")
    results["log_mel"] = dict(
        max_abs_err=err,
        tolerance="rtol 1e-4, atol 1e-3 (dB)",
        bound_bytes=nbytes,
        bound_flops=flops,
        ms=time_ms(torch, lambda: frontend_cuda.log_mel_spectrogram(*args)),
        plain_ms=time_ms(torch, lambda: frontend_cuda.log_mel_spectrogram_plain(*args)),
        bound_ms=b,
        bound_by=by,
        shapes=f"x (32, 80000) f32 -> (32, {frames}, 80) f32",
    )

    # --- ASP tail: x (32, 3072, 501), attention (32, 128, 501) --------------
    C, A, T = 3072, 128, frames
    x32 = torch.from_numpy(rng.normal(size=(BATCH, C, T)).astype(np.float32)).to(dev)
    a32 = torch.tanh(
        torch.from_numpy(rng.normal(size=(BATCH, A, T)).astype(np.float32)).to(dev)
    )
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
        x, a, w = x32.to(tdt), a32.to(tdt), w32.to(tdt)
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
        b, by = bound_ms(nbytes, flops, dtype)
        results[f"asp_pool_{dtype}"] = dict(
            max_abs_err=err,
            tolerance=f"mean rtol/atol {tol['mean']}, std rtol/atol {tol['std']}",
            valid_share=valid / (BATCH * T),
            bound_bytes=nbytes,
            bound_flops=flops,
            ms=time_ms(torch, lambda: asp_cuda.asp_pool(x, a, w, b32, mask)),
            plain_ms=time_ms(torch, lambda: asp_cuda.asp_pool_plain(x, a, w, b32, mask)),
            bound_ms=b,
            bound_by=by,
            shapes=f"x (32, 3072, {T}) {dtype}, a_tanh (32, 128, {T}) -> 2 x (32, 3072)",
        )
    for name, r in results.items():
        emit({"kernel": name, **r})
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


def parity_phase(torch):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
        precision_scope,
    )

    # the small5s test configuration: real recipe, small model widths
    small_pyannet = PyanNetConfig(
        num_filters=32, conv_channels=16, lstm_hidden=16, lstm_layers=2, linear_hidden=16
    )
    small_ecapa = EcapaConfig(
        channels=(64, 64, 64, 64, 128), attention_channels=16, se_channels=16, emb_dim=32
    )
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, chunk_bucket=4, compute_dtype="float32", transfer_dtype="float32"
    )
    clip = synth_clip(12.3, seed=977, quantize=True)
    out = {}
    for device in ("cuda", "cpu"):
        pipe = SpeakerDiarizationPipeline(
            cfg,
            seed=0,
            seg_batch=4,
            emb_batch=4,
            precision="highest",
            pyannet_cfg=small_pyannet,
            ecapa_cfg=small_ecapa,
            device=device,
        )
        with precision_scope("highest"):
            pending = pipe._dispatch(clip)
        out[device] = dict(
            emb=pending["emb"].float().cpu(),
            too_short=pending["too_short"].cpu(),
            segs=pending["segmentations"].cpu(),
            turns=turns_of(pipe(clip)),
        )
    g, c = out["cuda"], out["cpu"]
    valid = ~c["too_short"]
    emb_err = float((g["emb"][valid] - c["emb"][valid]).abs().max())
    seg_err = float((g["segs"] - c["segs"]).abs().max())
    check(torch.equal(g["too_short"], c["too_short"]), "parity: too_short differs")
    check(
        within(torch, g["emb"][valid], c["emb"][valid], 1e-3, 1e-4),
        f"parity: embeddings differ (max abs {emb_err})",
    )
    check(same_turns(g["turns"], c["turns"]), "parity: turns differ between cuda and cpu")
    emit(
        {
            "parity": "small5s cuda vs cpu, float32, TF32 off",
            "clip_s": 12.3,
            "emb_max_abs_err": emb_err,
            "seg_max_abs_err": seg_err,
            "embedding_rows": int(valid.sum()),
            "turns": len(c["turns"]),
            "turns_equal": True,
        }
    )


def main_path_phase(torch, counters):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    pipe = SpeakerDiarizationPipeline(seed=0)  # default config, full widths, cuda
    seg = pipe.config.segmentation
    clip = synth_clip(59.0, seed=0, quantize=False)
    padded = pipe.chunk_lattice(chunk_count(len(clip), seg.window_size, seg.step_size))
    expected = padded * seg.num_speakers // pipe.emb_batch
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        annotation = pipe(clip)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {name: fn.launches - before[name] for name, fn in counters.items()}
        check(
            all(n == expected for n in launched.values()),
            f"main path: launches {launched}, expected {expected} per request",
        )
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
                "device_ms": {"stage1": t.stage1_ms, "stage2": t.stage2_ms, "post": t.post_ms},
                "padded_chunks": padded,
                "turns": len(annotation.turns()),
                "speakers": len(annotation.labels),
                "launches": launched,
                "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            }
        )
    totals = {name: fn.launches for name, fn in counters.items()}
    # outputs: finite embeddings of the expected shape (one more, uncounted run)
    pending = pipe._dispatch(clip)
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
    return totals, expected


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
    emit(
        {
            "profile": "one 59 s request under torch.profiler",
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [
                {"name": name[:90], "device_ms": ms, "calls": n} for name, (ms, n) in top
            ],
        }
    )


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
        pack_cuda,
    )

    smi = nvidia_smi_line()
    build_s = _cuda_lib.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _cuda_lib.BUILD_LOG.items()
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
    parity_phase(torch)
    counters = {
        "pack_frames": pack_cuda.pack_frames,
        "log_mel": frontend_cuda.log_mel_spectrogram,
        "asp_pool": asp_cuda.asp_pool,
    }
    totals, expected = main_path_phase(torch, counters)
    pkg = "pyannote_audio_speaker_diarization_cpp_tpu_torch"
    tpu = "pyannote_audio_speaker_diarization_cpp_tpu"
    rows = [
        ("pack_frames", "pack_frames", f"{pkg}/csrc/pack.cu", f"{tpu}/ops/pack_pallas.py:93"),
        ("log_mel", "log_mel", f"{pkg}/csrc/frontend.cu", f"{tpu}/ops/frontend_pallas.py:67"),
        ("asp_pool", "asp_pool_bfloat16", f"{pkg}/csrc/asp.cu", f"{tpu}/ops/asp_pallas.py:71"),
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
