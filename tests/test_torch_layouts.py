"""The port's ECAPA trunk layouts ("nhc", "gemm") and the two forms of its
SincNet conv against the JAX package, on the CPU, in float32 at HIGHEST
precision (rtol 1e-3 / atol 1e-4).

Each layout runs on the same weights and state dict as "nch": its
embeddings must match the JAX package's same layout and the port's "nch",
and a tiny1s pipeline in that layout must give the JAX pipeline's turns in
that layout and the port's "nch" turns. The polyphase and strided sinc
convs must both match the JAX package's ``sincnet_forward``, on lengths
that divide by the stride and one that does not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cfg import SMALL_ECAPA, SMALL_PYANNET, TINY1S_CFG
from pyannote_audio_speaker_diarization_cpp_tpu.models import ecapa as jecapa
from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as jpyannet
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import convert as tconvert
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ecapa as tecapa
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import pyannet as tpyannet
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.embedding import EmbeddingPipeline
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import (
    build_pair,
    check_stage2,
    port_config,
    run_stages,
    same_turns,
    synth_audio,
)

RTOL, ATOL = 1e-3, 1e-4
HIGHEST = jax.lax.Precision.HIGHEST
LAYOUTS = ("nhc", "gemm")


@pytest.fixture(scope="module")
def params():
    tree = {
        "segmentation": jpyannet.init_pyannet(jax.random.PRNGKey(0), SMALL_PYANNET),
        "embedding": jecapa.init_ecapa(jax.random.PRNGKey(1), SMALL_ECAPA),
    }
    return jax.tree.map(np.asarray, tree)


def port_ecapa(params, layout):
    cfg = tecapa.EcapaConfig(**dataclasses.asdict(SMALL_ECAPA))
    model = tecapa.EcapaTDNN(cfg, layout=layout)
    model.load_state_dict(tconvert.ecapa_state_from_tree(params["embedding"]))
    return model.eval()


@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(4, 149, SMALL_ECAPA.in_channels)).astype(np.float32)
    return feats, np.array([1.0, 0.71, 0.4, 0.05], np.float32)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ecapa_layout_matches_jax_and_nch(params, features, layout):
    feats, lens = features
    want = np.asarray(
        jecapa.ecapa_forward(
            params["embedding"], jnp.asarray(feats), jnp.asarray(lens), SMALL_ECAPA,
            precision=HIGHEST, layout=layout,
        )
    )
    with torch.inference_mode():
        x, n = torch.from_numpy(feats), torch.from_numpy(lens)
        got = port_ecapa(params, layout)(x, n).numpy()
        nch = port_ecapa(params, "nch")(x, n).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, nch, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_channels_last_pooling_hands_the_kernel_its_layout(params, features, layout, monkeypatch):
    """In a channels-last layout the fused ASP tail still gets x as a
    contiguous (B, C, T) copy and tanh(attn) in rows padded to 8 frames,
    the layout the card's kernel reads without another copy."""
    seen = []
    real = tecapa.asp_pool

    def watched(x, a_tanh, w, bias, mask, eps=1e-12):
        seen.append((x, a_tanh))
        return real(x, a_tanh, w, bias, mask, eps)

    monkeypatch.setattr(tecapa, "asp_pool", watched)
    feats, lens = features
    with torch.inference_mode():
        port_ecapa(params, layout)(torch.from_numpy(feats), torch.from_numpy(lens))
    (x, a_tanh), = seen
    B, T = feats.shape[:2]
    assert x.shape == (B, SMALL_ECAPA.channels[-1], T) and x.is_contiguous()
    assert a_tanh.shape == (B, SMALL_ECAPA.attention_channels, T)
    assert a_tanh.stride(2) == 1 and a_tanh.stride(1) % 8 == 0 and a_tanh.stride(1) >= T


@pytest.mark.parametrize(
    "stride,dilation,padding,pad_mode",
    [(1, 1, "same", "reflect"), (2, 1, "same", "zeros"), (3, 2, "same", "reflect"), (2, 1, 1, "zeros")],
)
def test_conv1d_nhc_matches_jax(stride, dilation, padding, pad_mode):
    from pyannote_audio_speaker_diarization_cpp_tpu.models import layers as jlayers
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import layers as tlayers

    rng = np.random.default_rng(stride * 10 + dilation)
    x = rng.normal(size=(2, 37, 6)).astype(np.float32)
    w = rng.normal(size=(5, 6, 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = jlayers.conv1d_nhc(
        jnp.asarray(x), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, stride, dilation,
        padding, pad_mode, HIGHEST,
    )
    got = tlayers.conv1d_nhc(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), dilation, padding,
        pad_mode, stride,
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_unknown_layout_raises():
    cfg = port_config(TINY1S_CFG)
    with pytest.raises(ValueError, match="ecapa_layout"):
        SpeakerDiarizationPipeline(cfg, device="cpu", ecapa_layout="bogus")
    with pytest.raises(ValueError, match="ecapa_layout"):
        EmbeddingPipeline(cfg, device="cpu", ecapa_layout="bogus")
    assert SpeakerDiarizationPipeline(cfg, device="cpu").ecapa_layout == "nch"


@pytest.fixture(scope="module")
def nch_turns():
    jp, tp = build_pair(TINY1S_CFG, batch=8)
    audio = synth_audio(6.3)
    return audio, str(tp(audio))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pipeline_layout_matches_jax_and_nch(nch_turns, layout):
    """tiny1s in one layout through both packages: stage 2 on the JAX masks
    (embeddings close, too_short exact), then the turns: equal to the JAX
    pipeline's in that layout and to the port's "nch" turns."""
    audio, want_nch = nch_turns
    jp, tp = build_pair(TINY1S_CFG, batch=8, ecapa_layout=layout)
    assert tp.embedding_model.layout == layout
    check_stage2(tp, run_stages(jp, tp, audio))
    got = tp(audio)
    assert got.turns()
    same_turns(jp(audio), got)
    assert str(got) == want_nch


def test_embedding_pipeline_layouts_agree(params):
    cfg = port_config(TINY1S_CFG)
    ecapa_cfg = tecapa.EcapaConfig(**dataclasses.asdict(SMALL_ECAPA))
    rng = np.random.default_rng(3)
    wav = (0.1 * rng.normal(size=(3, 16000))).astype(np.float32)
    masks = (rng.uniform(size=(3, cfg.segmentation.num_frames)) > 0.3).astype(np.float32)
    out = {}
    for layout in ("nch",) + LAYOUTS:
        pipe = EmbeddingPipeline(
            cfg, params=params, ecapa_cfg=ecapa_cfg, device="cpu", ecapa_layout=layout,
            precision="highest",
        )
        out[layout] = (pipe(wav), pipe(wav, masks))
    for layout in LAYOUTS:
        for got, want in zip(out[layout], out["nch"]):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the SincNet conv: polyphase and strided
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("polyphase", [True, False])
@pytest.mark.parametrize("n", [16000, 16005, 80000])
def test_sinc_conv_forms_match_jax_sincnet(params, polyphase, n, monkeypatch):
    cfg = tpyannet.PyanNetConfig(**dataclasses.asdict(SMALL_PYANNET))
    model = tconvert.build_pyannet(params["segmentation"], cfg).eval()
    forms, real = [], tpyannet.sinc_conv

    def sinc_conv(x, filters, stride):
        forms.append(polyphase and x.shape[-1] % stride == 0)
        return real(x, filters, stride, polyphase)

    monkeypatch.setattr(tpyannet, "sinc_conv", sinc_conv)
    rng = np.random.default_rng(n)
    x = (0.1 * rng.normal(size=(2, n))).astype(np.float32)
    valid = np.array([n, n - 4321])
    want = np.asarray(
        jpyannet.sincnet_forward(
            jnp.asarray(x), params["segmentation"]["sincnet"], SMALL_PYANNET,
            precision=HIGHEST, valid_samples=jnp.asarray(valid),
        )
    )
    with torch.inference_mode():
        got = model.sincnet(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    assert forms == [polyphase and n % cfg.stride == 0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sinc_conv_forms_agree_on_a_baked_filterbank():
    """Both forms of ``sinc_conv`` on one filterbank, at the frame count the
    strided conv gives, across lengths around a multiple of the stride."""
    rng = np.random.default_rng(7)
    filters = torch.from_numpy(rng.normal(size=(16, 1, 251)).astype(np.float32))
    for n in (2510, 2511, 2519, 2520):
        x = torch.from_numpy(rng.normal(size=(3, 1, n)).astype(np.float32))
        strided = tpyannet.sinc_conv(x, filters, 10, polyphase=False)
        poly = tpyannet.sinc_conv(x, filters, 10)
        assert poly.shape == strided.shape == (3, 16, (n - 251) // 10 + 1)
        torch.testing.assert_close(poly, strided, rtol=RTOL, atol=ATOL)
