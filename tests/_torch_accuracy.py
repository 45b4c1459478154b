"""The closed accuracy loop of tests/test_accuracy_loop.py, in the port.

Train the port's PyanNet (PIT-BCE) and ECAPA-TDNN (AAM-softmax) from their
seeded inits on synthetic two-speaker tones, check that the two speakers'
embeddings separate, then diarize a composed 12 s conversation with the
port's full pipeline and score it against the truth. The data, the steps,
the stop rule and every threshold are the JAX test's: numpy's
``default_rng(0)`` drawn in the same order, batch 16, PyanNet trained
until its loss is below 0.06 after step 300 (at most 1000 steps), ECAPA
150 steps with a 2-class head on the port's front-end features. Only the
initial weights differ: they come from ``torch.Generator`` seeds, not the
JAX PRNG.

The JAX test is deterministic (fixed seeds, XLA's CPU backend), and so is
this loop: the training runs under ``torch.use_deterministic_algorithms``
(on the card this needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the
first cuBLAS call, as chip_smoke.py does; ECAPA's reflect-pad backward has
no deterministic CUDA kernel and only warns). Without it the card's
kernels make every run a different trajectory, and the batch on which the
loss first dips below the target decides how well the model detects
speech: three such runs on an H100 gave DER 0.115, 0.366 and 0.207. On the
CPU the trajectory depends on the torch thread count.

``run_accuracy_loop(device)`` runs it on ``device`` ("cpu", or None for the
CUDA card) and returns its report; ``failures(report)`` lists the
thresholds it missed. It imports no JAX: chip_smoke.py runs it on the card,
tests/test_torch_accuracy_loop.py on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from _torch_cfg import SMALL_ECAPA, SMALL_PYANNET, TINY1S_CFG, make_tiny1s_pipeline
from pyannote_audio_speaker_diarization_cpp_tpu_torch.core.annotation import Annotation
from pyannote_audio_speaker_diarization_cpp_tpu_torch.metrics.der import (
    der,
    diarization_error_rate,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import convert
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import training as T
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaTDNN
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
    PyanNet,
    pyannet_num_frames,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend as FE
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    precision_scope,
    resolve_device,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils.checkpoint import tree_map

SR = 16000
BATCH = 16
# the JAX test's thresholds
SEG_TARGET, SEG_MIN_STEPS, SEG_MAX_STEPS, SEG_LOSS_MAX = 0.06, 300, 1000, 0.12
ECAPA_STEPS = 150
SEPARATION_MARGIN = 0.05
DER_MAX = 0.25
SEGMENTS = [(0, 0.0, 3.0), (1, 3.5, 6.5), (0, 7.0, 9.0), (1, 9.5, 12.0)]


def _tone(rng, speaker: int, n: int) -> np.ndarray:
    """Two synthetic 'speakers' with distinct harmonic stacks."""
    t = np.arange(n) / SR
    f0 = 300.0 if speaker == 0 else 1200.0
    x = sum(
        0.3 / k * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi))
        for k in (1, 2, 3)
    )
    return x.astype(np.float32)


def _make_window(rng, frames: int):
    """1 s training window with random A/B/silence structure + labels."""
    wav = np.zeros(SR, np.float32)
    lab = np.zeros((frames, 3), np.float32)
    tpos = 0
    slot_of = {}
    while tpos < SR:
        seg = int(rng.uniform(0.2, 1.5) * SR)
        kind = rng.integers(0, 3)  # A / B / silence
        if kind < 2:
            slot_of.setdefault(kind, len(slot_of))
            s = slot_of[kind]
            wav[tpos : tpos + seg] += _tone(rng, kind, min(seg, SR - tpos))
            f0, f1 = int(tpos / SR * frames), int(min(tpos + seg, SR) / SR * frames)
            lab[f0:f1, s] = 1.0
        tpos += seg
    wav += 0.01 * rng.normal(size=SR).astype(np.float32)
    return wav, lab


def _numpy_tree(params):
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def initial_weights(seed: int = 0) -> dict:
    """The port's seeded inits: PyanNet from ``seed``, the ECAPA trunk from
    ``seed + 2`` and the AAM head from ``seed + 1`` (the JAX test's keys 0,
    2 and 1), as trees in the JAX package's layout."""
    return {
        "segmentation": convert.pyannet_tree(
            PyanNet(SMALL_PYANNET, torch.Generator().manual_seed(seed))
        ),
        "embedding": convert.ecapa_tree(
            EcapaTDNN(SMALL_ECAPA, torch.Generator().manual_seed(seed + 2))
        ),
        "head": T.init_aam_head(torch.Generator().manual_seed(seed + 1), SMALL_ECAPA.emb_dim, 2),
    }


def _train_pyannet(rng, device, params):
    """PIT-BCE Adam steps on batches of 16 windows until the loss target.
    Returns (tree, steps, final loss, host seconds spent making batches)."""
    frames = pyannet_num_frames(SR, SMALL_PYANNET)
    state = T.init_train_state(params, device=device)
    step = T.make_segmentation_train_step(SMALL_PYANNET)
    loss, data_s = None, 0.0
    for it in range(SEG_MAX_STEPS):
        t0 = time.perf_counter()
        ws, ls = zip(*[_make_window(rng, frames) for _ in range(BATCH)])
        data_s += time.perf_counter() - t0
        state, loss = step(state, np.stack(ws), np.stack(ls))
        loss = float(loss)
        # the JAX test's stop: a loss target, not a step count
        if it >= SEG_MIN_STEPS and loss < SEG_TARGET:
            break
    return _numpy_tree(state.params), it + 1, loss, data_s


def _train_ecapa(rng, device, params, head):
    """AAM-softmax Adam steps with a 2-class head on front-end features.
    Returns (trunk tree, final loss, host seconds spent making batches)."""
    fcfg = TINY1S_CFG.frontend
    state = T.init_train_state({"params": params, "head": head}, device=device)
    step = T.make_embedding_train_step(SMALL_ECAPA)
    lens = torch.ones(BATCH, device=device)
    loss, data_s = None, 0.0
    for _ in range(ECAPA_STEPS):
        t0 = time.perf_counter()
        labs = rng.integers(0, 2, size=BATCH)
        wavs = np.stack([_tone(rng, l, SR) for l in labs])
        data_s += time.perf_counter() - t0
        with torch.no_grad():
            feats = FE.compute_features(torch.from_numpy(wavs).to(device), lens, fcfg)
        state, loss = step(state, feats, lens, labs)
    return _numpy_tree(state.params["params"]), float(loss), data_s


def _separation(rng, emb_tree, device):
    """(within, across): cosine of same-speaker and cross-speaker clips."""
    model = EcapaTDNN(SMALL_ECAPA).to(device).eval()
    model.load_state_dict(convert.ecapa_state_from_tree(emb_tree))
    evalw = np.stack([_tone(rng, l, SR) for l in (0, 1, 0, 1, 0, 1)])
    lens6 = torch.ones(6, device=device)
    with torch.inference_mode():
        feats = FE.compute_features(torch.from_numpy(evalw).to(device), lens6, TINY1S_CFG.frontend)
        embs = model(feats, lens6).cpu().numpy().astype(np.float64)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    within = (embs[0] @ embs[2] + embs[1] @ embs[3]) / 2
    across = embs[0] @ embs[1]
    return float(within), float(across)


def _conversation(rng) -> np.ndarray:
    n = int(12.0 * SR)
    wav = 0.01 * rng.normal(size=n).astype(np.float32)
    for spk, s, e in SEGMENTS:
        wav[int(s * SR) : int(e * SR)] += _tone(rng, spk, int(e * SR) - int(s * SR))
    return wav


def _truth() -> Annotation:
    truth = Annotation()
    for spk, s, e in SEGMENTS:
        truth.add(s, e, spk)
    return truth


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    duration, the previous setting restored afterwards."""
    previous = (
        torch.are_deterministic_algorithms_enabled(),
        torch.is_deterministic_algorithms_warn_only_enabled(),
    )
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(previous[0], warn_only=previous[1])


def run_accuracy_loop(
    device=None, mark: Optional[Callable[[str], None]] = None, init: Optional[dict] = None
) -> dict:
    """Train both models on ``device`` (None: the CUDA card), diarize the
    conversation there with ``num_speakers=2`` (the host clustering route,
    as the JAX test) and once without (stage 3 on the device, reported
    only). Returns the numbers, the wall seconds of each part and the
    host seconds spent making the training data.
    ``mark``: called with each part's name ("training", "diarization",
    "device_route") as it ends. ``init``: the initial weights, as
    ``initial_weights`` returns them (default ``initial_weights(0)``)."""
    device = resolve_device(device)
    init = init or initial_weights(0)
    mark = mark or (lambda part: None)
    rng = np.random.default_rng(0)
    seconds, data_s = {}, {}
    t_all = time.perf_counter()
    with precision_scope("highest"), _deterministic():
        t0 = time.perf_counter()
        seg_tree, seg_steps, seg_loss, data_s["pyannet"] = _train_pyannet(
            rng, device, init["segmentation"]
        )
        _sync(device)
        seconds["pyannet_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        emb_tree, ecapa_loss, data_s["ecapa"] = _train_ecapa(
            rng, device, init["embedding"], init["head"]
        )
        _sync(device)
        seconds["ecapa_train"] = time.perf_counter() - t0
        within, across = _separation(rng, emb_tree, device)
    mark("training")

    wav = _conversation(rng)
    truth = _truth()
    pipe = make_tiny1s_pipeline(
        params={"segmentation": seg_tree, "embedding": emb_tree}, device=device
    )
    t0 = time.perf_counter()
    hyp = pipe(wav, num_speakers=2)
    seconds["diarization"] = time.perf_counter() - t0
    mark("diarization")
    # no bound: stage 3 (the merge-loop kernel on the card) clusters the
    # conversation on the device route
    with precision_scope(pipe.precision):
        pending = pipe._dispatch(wav)
        auto = pipe._collect(pending)
    dc = pending["device_clu"]
    mark("device_route")
    seconds["phase"] = time.perf_counter() - t_all
    components = diarization_error_rate(truth, hyp)
    return {
        "pyannet_steps": seg_steps,
        "pyannet_loss": seg_loss,
        "ecapa_loss": ecapa_loss,
        "within": within,
        "across": across,
        "der": components.der,
        "missed_s": components.missed,
        "false_alarm_s": components.false_alarm,
        "confusion_s": components.confusion,
        "labels": len({t.label for t in hyp.turns()}),
        "device_route": {
            "taken": dc is not None,
            "num_large": None if dc is None else int(dc["num_large"]),
            "der": der(truth, auto),
            "labels": len({t.label for t in auto.turns()}),
        },
        "seconds": seconds,
        # of the training seconds, the host's making of the batches
        "data_seconds": data_s,
    }


def failures(report: dict) -> list:
    """The JAX test's thresholds ``report`` misses (empty when it passes)."""
    missed = []
    if not report["pyannet_loss"] < SEG_LOSS_MAX:
        missed.append(f"segmentation did not converge: loss {report['pyannet_loss']}")
    if not report["within"] > report["across"] + SEPARATION_MARGIN:
        missed.append(f"embeddings do not separate: {report['within']}, {report['across']}")
    if not report["der"] < DER_MAX:
        missed.append(f"DER vs ground truth too high: {report['der']:.4f}")
    if report["labels"] != 2:
        missed.append(f"{report['labels']} speakers, expected 2")
    return missed
