"""The port at its default numerics against the JAX package, on the CPU.

The defaults are a bf16 ECAPA trunk (``compute_dtype``), f16 embedding
transfer (``transfer_dtype``) and ``precision="default"``. Each
configuration runs three ways on the same weights and audio: the port at
its defaults, the JAX package at its defaults, and the JAX package in
float32 at HIGHEST precision. The reference envelope (embedding abs 0.02,
BASELINE.md) is taken against the JAX float32 run: the JAX default ASP tail
runs its score conv, softmax and statistics in bf16 (models/ecapa.py, the
jnp form), while the port's runs them in float32, so the two default runs
sit further apart than either sits from float32.

Both packages run stage 3 at their default, ``device_clustering="auto"``:
the device route, whose activations are float16 on both sides, so the
turn comparison covers that cast.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax

from _cfg import SMALL_ECAPA, SMALL_PYANNET, TINY1S_CFG
from pyannote_audio_speaker_diarization_cpp_tpu.config import DEFAULT_CONFIG
from pyannote_audio_speaker_diarization_cpp_tpu.models.convert import load_checkpoint
from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.diarization import (
    SpeakerDiarizationPipeline as JaxPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
)
from test_torch_pipeline import port_config, same_turns, synth_audio

GATE_CKPT = os.path.join(os.path.dirname(__file__), "goldens", "gate_ckpt")
ENVELOPE = 0.02  # embedding abs, against the JAX float32 HIGHEST run
# port default vs JAX default: measured 0.03125 on small5s (one bf16 step at
# the embeddings' scale) and 0.0078 on tiny1s; the bound records that gap
DEFAULT_GAP = 0.05


def run_three(cfg, batch, params, audio):
    """{"port", "jax", "jax_f32"}: (embeddings (rows, D) float32, too_short,
    annotation) of one request each, on the same weights."""
    models = dict(seg_batch=batch, emb_batch=batch, pyannet_cfg=SMALL_PYANNET, ecapa_cfg=SMALL_ECAPA)
    jax_default = JaxPipeline(cfg, params=params, seed=0, **models)
    params = jax.tree.map(np.asarray, jax_default.params)
    jax_f32 = JaxPipeline(
        dataclasses.replace(cfg, compute_dtype="float32", transfer_dtype="float32"),
        params=params,
        precision=jax.lax.Precision.HIGHEST,
        **models,
    )
    port = SpeakerDiarizationPipeline(
        port_config(cfg),
        params=params,
        seg_batch=batch,
        emb_batch=batch,
        pyannet_cfg=PyanNetConfig(**dataclasses.asdict(SMALL_PYANNET)),
        ecapa_cfg=EcapaConfig(**dataclasses.asdict(SMALL_ECAPA)),
        device="cpu",
    )
    assert port.precision == "default" and port_config(cfg).compute_dtype == "bfloat16"
    out = {}
    for name, pipe in (("port", port), ("jax", jax_default), ("jax_f32", jax_f32)):
        pending = pipe._dispatch(audio)
        assert pending["device_clu"] is not None  # both defaults: stage 3 on the device
        emb, too_short = (np.asarray(jax.device_get(pending[k])) for k in ("emb", "too_short"))
        out[name] = (emb.astype(np.float32), too_short, pipe(audio))
    return out


@pytest.fixture(scope="module")
def small5s():
    cfg = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)
    return run_three(cfg, 4, load_checkpoint(GATE_CKPT), synth_audio(12.3))


@pytest.fixture(scope="module")
def tiny1s():
    return run_three(TINY1S_CFG, 8, None, synth_audio(6.3))


CONFIGS = ["small5s", "tiny1s"]


def _emb_gap(out, other):
    valid = ~out["jax_f32"][1]
    assert valid.any()
    return float(np.abs(out["port"][0][valid] - out[other][0][valid]).max())


@pytest.mark.parametrize("config", CONFIGS)
def test_default_too_short_equal(config, request):
    out = request.getfixturevalue(config)
    np.testing.assert_array_equal(out["port"][1], out["jax_f32"][1])
    np.testing.assert_array_equal(out["jax"][1], out["jax_f32"][1])


@pytest.mark.parametrize("config", CONFIGS)
def test_default_embeddings_within_envelope_of_jax_float32(config, request):
    # measured 0.0112 (small5s) and 0.0053 (tiny1s)
    assert _emb_gap(request.getfixturevalue(config), "jax_f32") <= ENVELOPE


@pytest.mark.parametrize("config", CONFIGS)
def test_default_turns_equal_jax_default(config, request):
    out = request.getfixturevalue(config)
    assert len(out["jax"][2].turns()) > 0
    same_turns(out["jax"][2], out["port"][2])


@pytest.mark.parametrize("config", CONFIGS)
def test_default_embeddings_near_jax_default(config, request):
    assert _emb_gap(request.getfixturevalue(config), "jax") <= DEFAULT_GAP
