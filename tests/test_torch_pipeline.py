"""The port's SpeakerDiarizationPipeline against the JAX pipeline, on the CPU.

Both run the same weights in the bit-conservative mode: float32 compute and
transfer, HIGHEST precision (TF32 off on the port's side), host clustering
on the JAX side (device_clustering=False). Two kinds of check:

  - STAGE-ISOLATED: each port stage is driven from the JAX side's previous
    stage output, so one near-threshold flip cannot cascade: discrete
    results must match exactly, floats at rtol 1e-3 / atol 1e-4.
  - END TO END: both sides run independently; binarized frames must agree
    wherever the scores are not within float noise of the onset threshold,
    and the turns must be equal up to a permutation of the labels.

This file covers the tiny1s configuration (1 s / 0.5 s windows, small
models, a seeded JAX init); test_torch_pipeline_small5s.py covers the real
5 s / 0.5 s recipe with the in-repo gate checkpoint.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from _cfg import SMALL_ECAPA, SMALL_PYANNET, TINY1S_CFG
from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.diarization import (
    SpeakerDiarizationPipeline as JaxPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch import config as tcfg
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import device_chunks
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
    finalize_embeddings,
    precision_scope,
)

RTOL, ATOL = 1e-3, 1e-4


def synth_audio(seconds: float, seed: int = 977, sr: int = 16000) -> np.ndarray:
    """Multi-tone + noise, int16-quantized (the golden-dump family)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (
        0.30 * np.sin(2 * np.pi * 220.0 * t)
        + 0.20 * np.sin(2 * np.pi * 1100.0 * t * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t)))
        + 0.30 * np.sin(2 * np.pi * 3.1 * t) * rng.standard_normal(t.shape)
    )
    q = np.clip(np.round(x * 20000.0), -32768, 32767).astype(np.int16)
    return q.astype(np.float32) / 32768.0


def port_config(cfg) -> tcfg.DiarizationConfig:
    """A JAX-package DiarizationConfig as the port's (same field values)."""
    fields = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            value = getattr(tcfg, type(value).__name__)(**dataclasses.asdict(value))
        fields[f.name] = value
    return tcfg.DiarizationConfig(**fields)


def build_pair(jax_cfg, batch, params=None, seed=0):
    """(jax pipeline, port pipeline) on the same weights, conservative mode."""
    jax_cfg = dataclasses.replace(jax_cfg, compute_dtype="float32", transfer_dtype="float32")
    jp = JaxPipeline(
        jax_cfg,
        params=params,
        seed=seed,
        seg_batch=batch,
        emb_batch=batch,
        pyannet_cfg=SMALL_PYANNET,
        ecapa_cfg=SMALL_ECAPA,
        precision=jax.lax.Precision.HIGHEST,
        device_clustering=False,
    )
    tp = SpeakerDiarizationPipeline(
        port_config(jax_cfg),
        params=jax.tree.map(np.asarray, jp.params),
        seg_batch=batch,
        emb_batch=batch,
        precision="highest",
        pyannet_cfg=PyanNetConfig(**dataclasses.asdict(SMALL_PYANNET)),
        ecapa_cfg=EcapaConfig(**dataclasses.asdict(SMALL_ECAPA)),
        device="cpu",
    )
    return jp, tp


def run_stages(jp, tp, audio):
    """JAX stage outputs on the port's host prep, and the port's stage-1
    outputs on the same inputs."""
    _, _, wav_padded, vf, vs = tp._prepare(audio)
    jwav = jax.numpy.asarray(wav_padded)
    j1 = jax.device_get(
        jp._stage1(jp.params["segmentation"], jwav, jax.numpy.asarray(vf), jax.numpy.asarray(vs))
    )
    j2 = jax.device_get(jp._stage2(jp.params["embedding"], jwav, j1[2]))
    seg = tp.config.segmentation
    chunks = device_chunks(torch.from_numpy(wav_padded), len(vf), seg.window_size, seg.step_size)
    with precision_scope("highest"), torch.inference_mode():
        t1 = tp._stage1(chunks, vf, vs)
    return dict(jax1=j1, jax2=j2, port1=[t.numpy() for t in t1], chunks=chunks, vf=vf)


def margin_aware_agree(seg_a, seg_b, bin_a, bin_b, onset):
    """Binarized bits agree on every frame whose score is decided (farther
    from the onset than twice the score deviation), and almost everywhere."""
    margin = max(2.0 * np.abs(seg_a - seg_b).max(), 1e-6)
    decided = np.abs(seg_a - onset) > margin
    agree = bin_a == bin_b
    assert agree[decided].mean() > 0.999
    assert agree.mean() > 0.995


def same_turns(ann_a, ann_b):
    """Equal turn boundaries, labels equal up to a bijection."""
    a, b = ann_a.turns(), ann_b.turns()
    assert len(a) == len(b)
    mapping = {}
    for x, y in zip(a, b):
        assert (x.start, x.end) == (y.start, y.end)
        assert mapping.setdefault(x.label, y.label) == y.label
    assert len(set(mapping.values())) == len(mapping)


def check_stage1(stages, onset):
    jsegs, jbin = stages["jax1"][0], stages["jax1"][1]
    tsegs, tbin = stages["port1"][0], stages["port1"][1]
    np.testing.assert_allclose(tsegs, jsegs, rtol=RTOL, atol=ATOL)
    margin_aware_agree(jsegs, tsegs, jbin, tbin, onset)


def check_post_process(tp, stages):
    """The port's post-processing on the JAX scores: exact."""
    segs, vf = stages["jax1"][0], stages["vf"]
    with torch.inference_mode():
        got = tp._post_process(torch.from_numpy(np.array(segs)), torch.from_numpy(vf))
    for want, t in zip(stages["jax1"][1:], got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))


def check_stage2(tp, stages):
    """The port's stage 2 on the JAX masks: embeddings close, too_short exact."""
    chosen = torch.from_numpy(np.array(stages["jax1"][2]))
    with precision_scope("highest"), torch.inference_mode():
        emb, too_short = tp._stage2(stages["chunks"], chosen)
    jemb, jshort = stages["jax2"]
    np.testing.assert_array_equal(too_short.numpy(), jshort)
    keep = ~jshort
    np.testing.assert_allclose(emb.numpy()[keep], np.asarray(jemb)[keep], rtol=RTOL, atol=ATOL)


def check_collect(jp, tp, audio):
    """The port's stage 3 (host clustering, post-aggregation, decode) on the
    JAX stage outputs: the same turns, labels included."""
    jpending = jp._dispatch(audio)
    tpending = tp._dispatch(audio)
    for key in ("segmentations", "count_raw", "inactive", "emb", "too_short"):
        tpending[key] = torch.from_numpy(np.array(jax.device_get(jpending[key])))
    want = jp._collect(jpending)
    got = tp._collect(tpending)
    assert str(got) == str(want)
    return want


def check_finalize(jp, tp, audio):
    """The port's ``finalize`` (host clustering, reconstruct, decode) on the
    JAX stage outputs: the same turns, labels included, as the JAX
    package's ``finalize``."""
    jpending, tpending = jp._dispatch(audio), tp._dispatch(audio)
    n = jpending["num_chunks"]
    segs, binarized, emb, too_short, count_raw = (
        np.array(jax.device_get(jpending[key]))
        for key in ("segmentations", "binarized", "emb", "too_short", "count_raw")
    )
    embeddings = finalize_embeddings(emb, too_short, n, tp.config.segmentation.num_speakers)
    count = np.rint(count_raw[: jpending["real_plan"].num_frames]).astype(np.int64)
    want = jp.finalize(
        segs[:n], binarized[:n], embeddings.copy(), count,
        jpending["count_frames"], jpending["chunk_frames"],
    )
    got = tp.finalize(
        segs[:n], binarized[:n], embeddings.copy(), count,
        tpending["count_frames"], tpending["chunk_frames"],
    )
    assert len(want.turns()) > 0
    assert str(got) == str(want)


def check_end_to_end(jp, tp, audio, onset):
    jpending, tpending = jp._dispatch(audio), tp._dispatch(audio)
    margin_aware_agree(
        np.asarray(jpending["segmentations"]),
        tpending["segmentations"].numpy(),
        np.asarray(jpending["binarized"]),
        tpending["binarized"].numpy(),
        onset,
    )
    want, got = jp(audio), tp(audio)
    assert len(want.turns()) > 0
    same_turns(want, got)


# ---------------------------------------------------------------------------
# tiny1s
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny1s():
    jp, tp = build_pair(TINY1S_CFG, batch=8)
    audio = synth_audio(6.3)
    return jp, tp, audio, run_stages(jp, tp, audio)


def test_tiny1s_stage1_close(tiny1s):
    check_stage1(tiny1s[3], TINY1S_CFG.segmentation.onset)


def test_tiny1s_post_process_exact(tiny1s):
    check_post_process(tiny1s[1], tiny1s[3])


def test_tiny1s_stage2_from_jax_masks(tiny1s):
    check_stage2(tiny1s[1], tiny1s[3])


def test_tiny1s_collect_from_jax_outputs(tiny1s):
    check_collect(*tiny1s[:3])


def test_tiny1s_finalize_from_jax_outputs(tiny1s):
    check_finalize(*tiny1s[:3])


def test_tiny1s_end_to_end_turns(tiny1s):
    check_end_to_end(*tiny1s[:3], TINY1S_CFG.segmentation.onset)


# ---------------------------------------------------------------------------
# device rule and precision flags
# ---------------------------------------------------------------------------


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeakerDiarizationPipeline()
    with pytest.raises(RuntimeError):
        SpeakerDiarizationPipeline(device="cuda")


def test_precision_scope_restores_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with precision_scope("highest"):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved
    with pytest.raises(ValueError):
        with precision_scope("bf16"):
            pass
