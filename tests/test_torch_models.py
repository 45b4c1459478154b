"""The port's PyanNet and ECAPA-TDNN modules against the JAX package's
forwards, with the same weights (a JAX init with a fixed seed, carried over
by params_from_jax), in float32 at HIGHEST precision; and checkpoint
loading, including the in-repo gate checkpoint."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _cfg import SMALL_ECAPA, SMALL_PYANNET
from pyannote_audio_speaker_diarization_cpp_tpu.models import convert as jconvert
from pyannote_audio_speaker_diarization_cpp_tpu.models import ecapa as jecapa
from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as jpyannet
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import convert as tconvert
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ecapa as tecapa
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import pyannet as tpyannet

RTOL, ATOL = 1e-3, 1e-4
HIGHEST = jax.lax.Precision.HIGHEST
GATE_CKPT = os.path.join(os.path.dirname(__file__), "goldens", "gate_ckpt")


def port_pyannet_cfg(cfg):
    return tpyannet.PyanNetConfig(**dataclasses.asdict(cfg))


def port_ecapa_cfg(cfg):
    return tecapa.EcapaConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def params():
    tree = {
        "segmentation": jpyannet.init_pyannet(jax.random.PRNGKey(0), SMALL_PYANNET),
        "embedding": jecapa.init_ecapa(jax.random.PRNGKey(1), SMALL_ECAPA),
    }
    return jax.tree.map(np.asarray, tree)


def _pyannet(params):
    seg_state, _ = tconvert.params_from_jax(params)
    model = tpyannet.PyanNet(port_pyannet_cfg(SMALL_PYANNET))
    model.load_state_dict(seg_state)
    return model.eval()


def _ecapa(params):
    _, emb_state = tconvert.params_from_jax(params)
    model = tecapa.EcapaTDNN(port_ecapa_cfg(SMALL_ECAPA))
    model.load_state_dict(emb_state)
    return model.eval()


@pytest.mark.parametrize("n", [16000, 80000])
def test_pyannet_matches_jax_with_short_orphan(params, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(4, n)).astype(np.float32)
    # full rows, a short orphan (scored at its true length), a padding row
    valid = np.array([n, n, int(0.55 * n), 0], np.int32)
    x[2, valid[2] :] = 0.0
    x[3] = 0.0
    want = np.asarray(
        jpyannet.pyannet_forward(
            params["segmentation"], jnp.asarray(x), SMALL_PYANNET, HIGHEST,
            valid_samples=jnp.asarray(valid),
        )
    )
    with torch.no_grad():
        got = _pyannet(params)(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the orphan's valid frames equal a true-length run
    frames = tpyannet.pyannet_num_frames(int(valid[2]), port_pyannet_cfg(SMALL_PYANNET))
    with torch.no_grad():
        alone = _pyannet(params)(torch.from_numpy(x[2:3, : valid[2]])).numpy()
    np.testing.assert_allclose(got[2, :frames], alone[0], rtol=RTOL, atol=ATOL)


def test_pyannet_unmasked_matches_jax(params):
    x = np.random.default_rng(3).normal(size=(3, 16000)).astype(np.float32)
    want = np.asarray(
        jpyannet.pyannet_forward(params["segmentation"], jnp.asarray(x), SMALL_PYANNET, HIGHEST)
    )
    with torch.no_grad():
        got = _pyannet(params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_valid_chain_and_num_frames_equal():
    v = np.array([0, 250, 251, 1000, 16000, 47123, 80000], np.int32)
    for cfg in (SMALL_PYANNET, jpyannet.PyanNetConfig()):
        want = jpyannet.pyannet_valid_chain(jnp.asarray(v), cfg)
        got = tpyannet.pyannet_valid_chain(torch.from_numpy(v), port_pyannet_cfg(cfg))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for n in (16000, 80000, 47123):
            assert jpyannet.pyannet_num_frames(n, cfg) == tpyannet.pyannet_num_frames(
                n, port_pyannet_cfg(cfg)
            )


def test_ecapa_matches_jax(params):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(4, 101, 80)).astype(np.float32)
    lengths = np.array([1.0, 0.5, 0.31, 0.9], np.float32)
    want = np.asarray(
        jecapa.ecapa_forward(
            params["embedding"], jnp.asarray(feats), jnp.asarray(lengths), SMALL_ECAPA, HIGHEST
        )
    )
    with torch.no_grad():
        got = _ecapa(params)(torch.from_numpy(feats), torch.from_numpy(lengths)).numpy()
    assert got.shape == (4, SMALL_ECAPA.emb_dim)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gate_checkpoint_loads_and_matches_jax():
    jparams = jconvert.load_checkpoint(GATE_CKPT)
    tparams = tconvert.load_checkpoint(GATE_CKPT)
    jflat = {
        name: jconvert.flatten_pytree(tree) for name, tree in jparams.items()
    }
    for name, tree in tparams.items():
        flat = tconvert.flatten_pytree(tree)
        assert flat.keys() == jflat[name].keys()
        for key in flat:
            np.testing.assert_array_equal(flat[key], np.asarray(jflat[name][key]))
    model = _ecapa(tparams)
    feats = np.random.default_rng(5).normal(size=(2, 61, 80)).astype(np.float32)
    lengths = np.array([1.0, 0.7], np.float32)
    want = np.asarray(
        jecapa.ecapa_forward(
            jparams["embedding"], jnp.asarray(feats), jnp.asarray(lengths), SMALL_ECAPA, HIGHEST
        )
    )
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _pyannet(tparams)  # strict load of the segmentation state


def test_checkpoint_round_trip(params, tmp_path):
    tconvert.save_checkpoint(str(tmp_path), params)
    back = jconvert.load_checkpoint(str(tmp_path))  # readable by the JAX package
    for name in params:
        a = tconvert.flatten_pytree(params[name])
        b = jconvert.flatten_pytree(back[name])
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_seeded_init_is_deterministic():
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        return tpyannet.PyanNet(port_pyannet_cfg(SMALL_PYANNET), generator=g).state_dict()

    a, b, c = build(3), build(3), build(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
