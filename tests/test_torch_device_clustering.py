"""The port's device clustering (clustering/device.py, the merge loop's plain
version in ops/linkage_cuda.py) and its fused pipeline stage 3, against the
JAX package on the CPU.

The same embeddings, made with numpy from a seed, go through the JAX
``device_cluster`` (jit on the CPU) and the port's: ``num_large`` must be
equal and ``hard`` partition-equal (the same partition up to a label
bijection, -2 rows exactly equal). The pipeline checks run tiny1s with
``device_clustering="auto"`` on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _cfg import TINY1S_CFG
from pyannote_audio_speaker_diarization_cpp_tpu.clustering.base import filter_embeddings
from pyannote_audio_speaker_diarization_cpp_tpu.clustering.device import (
    device_cluster as jax_device_cluster,
    select_train_rows as jax_select_train_rows,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.base import (
    AgglomerativeClustering,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.device import (
    _linkage_labels,
    device_cluster,
    initial_distances,
    select_train_rows,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
    post_cluster,
)
from test_device_clustering import _blob_embeddings, _partitions_equal
from test_torch_pipeline import build_pair, same_turns

THRESHOLD = ClusteringConfig().threshold
jit_cluster = jax.jit(jax_device_cluster, static_argnums=(3, 4, 5))


def _both(flat, valid, inactive, k_max=8):
    """(jax hard, jax num_large, port hard, port num_large) on the same rows."""
    j = jit_cluster(jnp.asarray(flat), jnp.asarray(valid), jnp.asarray(inactive), THRESHOLD, 15, k_max)
    t = device_cluster(
        torch.from_numpy(flat), torch.from_numpy(valid), torch.from_numpy(inactive), THRESHOLD, 15, k_max
    )
    assert t.hard.dtype == torch.int32 and t.num_large.dtype == torch.int32
    return np.asarray(j.hard), int(j.num_large), t.hard.numpy(), int(t.num_large)


def _check_equal(emb3, nanmask):
    d = emb3.shape[-1]
    flat = np.nan_to_num(emb3.reshape(-1, d)).astype(np.float32)
    valid = ~nanmask.reshape(-1)
    jh, jn, th, tn = _both(flat, valid, ~valid)
    assert tn == jn
    assert _partitions_equal(th, jh)
    return th, tn


@pytest.mark.parametrize("trial", range(5))
def test_separated_blobs_match_jax(trial):
    r = np.random.default_rng(100 + trial)
    K = int(r.integers(2, 6))
    emb, nanmask = _blob_embeddings(r, int(r.integers(12, 50)), K)
    _, num_large = _check_equal(emb, nanmask)
    assert num_large >= 1


def test_single_cluster_and_single_valid_row():
    r = np.random.default_rng(3)
    emb = r.normal(size=(1, 48)) + 0.02 * r.normal(size=(18, 3, 48))
    hard, num_large = _check_equal(emb, np.zeros((18, 3), bool))
    assert num_large == 1 and set(hard) == {0}
    emb = r.normal(size=(1, 3, 16))
    nm = np.array([[False, True, True]])
    emb[0, 1:] = np.nan
    hard, num_large = _check_equal(emb, nm)
    assert num_large == 1 and hard[0] == 0 and (hard[1:] == -2).all()


def test_small_cluster_reassigned_to_nearest_large():
    r = np.random.default_rng(11)
    emb, nm = _blob_embeddings(r, 40, 2, noise=0.05, nan_frac=0.0)
    outlier = r.normal(size=32) * 5
    for idx in [(0, 0), (1, 1), (2, 2), (3, 0)]:
        emb[idx] = outlier + 0.05 * r.normal(size=32)
    _, num_large = _check_equal(emb, nm)
    assert num_large == 2


def test_num_large_zero():
    r = np.random.default_rng(5)
    emb = r.normal(size=(30, 3, 48))
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)  # ~orthogonal: no merges
    _, num_large = _check_equal(emb, np.zeros((30, 3), bool))
    assert num_large == 0


def test_invalid_but_active_row_gets_cluster_zero():
    r = np.random.default_rng(21)
    emb, _ = _blob_embeddings(r, 20, 2, nan_frac=0.0)
    flat = emb.reshape(-1, 32).astype(np.float32)
    valid = np.ones(60, bool)
    valid[5] = False  # too short but active
    jh, jn, th, tn = _both(flat, valid, np.zeros(60, bool))
    assert th[5] == 0 and jh[5] == 0
    assert tn == jn and _partitions_equal(th, jh)


@pytest.mark.parametrize("num_chunks", [400, 768, 1536])
def test_capped_sizes_match_jax(num_chunks):
    """Above the 1000-row train cap both cluster the same strided subsample
    (T = 1024 from 1200 rows up)."""
    r = np.random.default_rng(num_chunks)
    emb, nanmask = _blob_embeddings(r, num_chunks, 5, dim=192, nan_frac=0.1)
    _check_equal(emb, nanmask)


@pytest.mark.parametrize("R,cap", [(60, 1000), (1000, 1000), (2500, 1000), (700, 128)])
def test_select_train_rows_exact(R, cap):
    r = np.random.default_rng(7 + R)
    valid = r.random(R) < 0.85
    T = min(R, -(-cap // 128) * 128)
    jsel, jtvalid, jK = jax.jit(jax_select_train_rows, static_argnums=(1, 2))(
        jnp.asarray(valid), T, cap
    )
    jsel, jtvalid = np.asarray(jsel), np.asarray(jtvalid)
    sel, tvalid, K = select_train_rows(torch.from_numpy(valid), T, cap)
    assert int(K) == int(jK)
    np.testing.assert_array_equal(tvalid.numpy(), jtvalid)
    np.testing.assert_array_equal(sel.numpy()[tvalid.numpy()], jsel[jtvalid])
    # and the host's own cap picks those rows
    emb3 = r.normal(size=(R, 1, 8))
    emb3[~valid] = np.nan
    _, host_rows, _ = filter_embeddings(emb3, max_num_embeddings=cap)
    np.testing.assert_array_equal(sel.numpy()[tvalid.numpy()], host_rows)


def _train_rows(seed, T, K, d=32, valid_frac=0.9):
    r = np.random.default_rng(seed)
    centers = r.normal(size=(K, d))
    x = centers[r.integers(0, K, T)] + 0.3 * r.normal(size=(T, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    tvalid = np.arange(T) < int(valid_frac * T)
    x[~tvalid] = 0.0
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(tvalid)


@pytest.mark.parametrize("seed,T,K", [(0, 64, 3), (1, 128, 1), (2, 96, 6)])
def test_linkage_early_exit_equals_full_run(seed, T, K):
    """After the first refused merge the body changes nothing that decides
    rep: stopping there and running all T - 1 steps agree."""
    embt, tvalid = _train_rows(seed, T, K)
    D0 = initial_distances(embt, tvalid)
    early = linkage_cuda.linkage_labels_plain(D0, embt, tvalid, THRESHOLD)
    full = linkage_cuda.linkage_labels_plain(D0, embt, tvalid, THRESHOLD, early_exit=False)
    steps = int(early.steps)
    assert steps < T - 1 and int(full.steps) == T - 1
    assert torch.equal(early.rep, full.rep)
    assert torch.equal(early.merges, full.merges) and torch.equal(early.dists, full.dists)
    rep = early.rep
    assert int(rep.min()) >= 0 and int(rep.max()) < 2 * T
    # the merge log: one pair a merge, the refused step's distance above the
    # threshold, nothing past it
    assert bool((early.merges[: steps - 1] >= 0).all()) and bool((early.merges[steps - 1 :] == -1).all())
    assert bool((early.dists[: steps - 1] <= THRESHOLD).all()) and float(early.dists[steps - 1]) > THRESHOLD
    assert bool(torch.isinf(early.dists[steps:]).all())
    # the wrapper on a CPU tensor is the plain version
    got = linkage_cuda.linkage_labels(D0, embt, tvalid, THRESHOLD)
    assert all(torch.equal(a, b) for a, b in zip(got, early))
    assert torch.equal(_linkage_labels(embt, tvalid, THRESHOLD), rep)


def test_centroid_distances_order():
    """The merge loop's fixed summation order is a Euclidean distance."""
    r = np.random.default_rng(4)
    for d in (192, 32, 48, 7):
        c = torch.from_numpy(r.normal(size=(50, d)).astype(np.float32))
        got = linkage_cuda.centroid_distances(c, c[3])
        want = torch.from_numpy(np.linalg.norm(c.double().numpy() - c[3].double().numpy(), axis=1))
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
        assert got[3] == 0.0


def test_linkage_wrapper_rejects_shapes():
    embt, tvalid = _train_rows(0, 16, 2)
    with pytest.raises(ValueError):
        linkage_cuda.linkage_labels(torch.zeros(16, 15), embt, tvalid, THRESHOLD)
    with pytest.raises(ValueError):
        linkage_cuda.linkage_labels(torch.zeros(16, 16), embt, tvalid[:8], THRESHOLD)


# ---------------------------------------------------------------------------
# the fused pipeline stage 3 (tiny1s)
# ---------------------------------------------------------------------------


def _wav(seconds, seed):
    return (0.1 * np.random.default_rng(seed).normal(size=seconds * 16000)).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    """(JAX auto, port auto, port host route) on the same weights."""
    jp, tp = build_pair(TINY1S_CFG, batch=8, device_clustering="auto")
    host = SpeakerDiarizationPipeline(
        tp.config,
        params=jax.tree.map(np.asarray, jp.params),
        seg_batch=8,
        emb_batch=8,
        precision="highest",
        pyannet_cfg=tp.pyannet_cfg,
        ecapa_cfg=tp.ecapa_cfg,
        device="cpu",
        device_clustering=False,
    )
    return jp, tp, host


def _turns(ann):
    return [(round(t.start, 4), round(t.end, 4), t.label) for t in ann.turns()]


@pytest.mark.parametrize("seconds,seed", [(3, 1), (5, 2), (6, 7)])
def test_pipeline_turns_equal_jax_device_path(pipes, seconds, seed):
    jp, tp, _ = pipes
    wav = _wav(seconds, seed)
    assert tp._dispatch(wav)["device_clu"] is not None
    assert jp._dispatch(wav)["device_clu"] is not None
    want, got = jp(wav), tp(wav)
    assert len(want.turns()) > 0
    same_turns(want, got)


def test_stage3_activations_match_post_cluster(pipes):
    """The fused float16 activations against post_cluster driven by the same
    hard labels, within the float16 rounding."""
    _, tp, _ = pipes
    pending = tp._dispatch(_wav(5, 13))
    dc = pending["device_clu"]
    assert dc["activations"].dtype == torch.float16
    hard = dc["hard"].reshape(pending["num_padded"], -1)
    assert int(dc["num_large"]) >= 1
    membership = (hard[:, :, None] == torch.arange(tp.k_max)) & (hard >= 0)[:, :, None]
    plan = tp._diarization_plan(pending["num_padded"])
    ref = post_cluster(
        pending["segmentations"], membership, torch.from_numpy(plan.start_frames), plan.num_frames
    )
    np.testing.assert_allclose(dc["activations"].float().numpy(), ref.numpy(), atol=2e-3)


def test_bounds_take_host_path(pipes):
    _, tp, host = pipes
    wav = _wav(4, 9)
    pending = tp._dispatch(wav, num_speakers=2)
    assert pending["device_clu"] is None
    assert _turns(tp._collect(pending, num_speakers=2)) == _turns(host(wav, num_speakers=2))


def test_rows_cap_takes_host_path(pipes):
    jp, tp, _ = pipes
    small = SpeakerDiarizationPipeline(
        tp.config,
        params=jax.tree.map(np.asarray, jp.params),
        seg_batch=8,
        emb_batch=8,
        pyannet_cfg=tp.pyannet_cfg,
        ecapa_cfg=tp.ecapa_cfg,
        device="cpu",
        device_cluster_rows=8,
    )
    pending = small._dispatch(_wav(5, 2))
    assert pending["device_clu"] is None
    assert small._collect(pending) is not None


def test_num_large_zero_falls_back_to_host(pipes):
    _, tp, host = pipes
    wav = _wav(4, 44)
    pending = tp._dispatch(wav)
    assert pending["device_clu"] is not None
    pending["device_clu"]["num_large"] = torch.tensor(0, dtype=torch.int32)
    got = _turns(tp._collect(pending))
    want = _turns(host(wav))
    assert [(s, e) for s, e, _ in got] == [(s, e) for s, e, _ in want]


def _port_tiny(**kwargs):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
    from test_torch_pipeline import port_config

    from _cfg import SMALL_ECAPA, SMALL_PYANNET

    return SpeakerDiarizationPipeline(
        port_config(TINY1S_CFG),
        seg_batch=8,
        emb_batch=8,
        pyannet_cfg=PyanNetConfig(**dataclasses.asdict(SMALL_PYANNET)),
        ecapa_cfg=EcapaConfig(**dataclasses.asdict(SMALL_ECAPA)),
        device="cpu",
        **kwargs,
    )


def test_eligibility_of_large_and_missing_caps():
    """As the JAX package decides it: a large finite cap or no cap sizes the
    merge loop past 1536 rows, and takes the host path there."""
    p = _port_tiny(clusterer=AgglomerativeClustering(ClusteringConfig(), max_num_embeddings=5000))
    assert not p._device_clu_eligible(4000, None, None, None)
    assert p._device_clu_eligible(900, None, None, None)
    p2 = _port_tiny(clusterer=AgglomerativeClustering(ClusteringConfig(), max_num_embeddings=None))
    assert not p2._device_clu_eligible(4000, None, None, None)
    assert p2._device_clu_eligible(1200, None, None, None)
    assert not p2._device_clu_eligible(1200, 2, None, None)
    assert _port_tiny()._device_clu_eligible(6144, None, None, None)
    assert not _port_tiny(device_clustering=False)._device_clu_eligible(60, None, None, None)


def test_incompatible_clusterer_raises():
    constrained = AgglomerativeClustering(ClusteringConfig(), constrained_assignment=True)
    with pytest.raises(ValueError):
        _port_tiny(device_clustering=True, clusterer=constrained)
    assert not _port_tiny(clusterer=constrained)._device_clu_enabled
