"""The port's long-form diarization (parallel/longform.py) on the CPU: its
shard plan and its two device building blocks against the JAX package's,
its turns against the JAX package's LongFormDiarizer on the same weights
and audio (equal up to a permutation of the labels, the rule between the
packages), and, within the port, long-form against the single-shot
pipeline string for string: shard counts, WAV partial reads, the in-flight
window, simulated processes, the fused device stage 3 and the host path.

Both packages run the bit-conservative mode (float32 compute and transfer,
HIGHEST precision / TF32 off); the building blocks' counts are exact and
their activations at rtol 1e-3 / atol 1e-4."""

import dataclasses
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _cfg import TINY1S_CFG
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import RTOL, ATOL, build_pair, same_turns, synth_audio
from pyannote_audio_speaker_diarization_cpp_tpu.parallel.longform import (
    LongFormDiarizer as JaxLongFormDiarizer,
    plan_shards as jax_plan_shards,
)
from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.diarization import (
    _count_parts as jax_count_parts,
    _post_cluster_from_hard as jax_post_cluster_from_hard,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.io import wav as wavio
from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.longform import (
    LocalComm,
    LongFormDiarizer,
    plan_shards,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
    count_parts,
    post_cluster_from_hard,
)

WINDOW, STEP = 80000, 8000


def _noise(num_samples, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=num_samples)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX pipeline, port pipeline), tiny1s, device clustering "auto" on
    both, same weights."""
    return build_pair(TINY1S_CFG, batch=8, device_clustering="auto")


@pytest.fixture(scope="module")
def tiny(pair):
    return pair[1]


@pytest.fixture(scope="module")
def tiny_host(pair):
    """The port pipeline on the same weights with host clustering."""
    tp = pair[1]
    return SpeakerDiarizationPipeline(
        tp.config,
        params=jax.tree.map(np.asarray, pair[0].params),
        seg_batch=8,
        emb_batch=8,
        precision="highest",
        pyannet_cfg=tp.pyannet_cfg,
        ecapa_cfg=tp.ecapa_cfg,
        device="cpu",
        device_clustering=False,
    )


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_chunks,num_shards", [(10, 3), (7, 7), (5, 8), (111, 4)])
def test_plan_shards_equals_jax(num_chunks, num_shards):
    got = plan_shards(num_chunks, num_shards, WINDOW, STEP)
    want = jax_plan_shards(num_chunks, num_shards, WINDOW, STEP)
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    assert [s.num_chunks for s in got] == [s.num_chunks for s in want]
    assert sum(s.num_chunks for s in got) == num_chunks


def test_plan_shards_halo_is_bounded():
    shards = plan_shards(100, 4, WINDOW, STEP)
    for s in shards[:-1]:
        assert s.sample_hi - s.chunk_hi * STEP <= WINDOW - STEP  # <= 4.5 s halo


# ---------------------------------------------------------------------------
# the device building blocks against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_count_parts_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n, F, S = 16, 59, 3
    binarized = (rng.uniform(size=(n, F, S)) > 0.6).astype(np.float32)
    valid = np.full(n, F, np.int32)
    valid[11:] = 0  # padding chunks
    valid[10] = 23  # an orphan
    start = np.zeros(n, np.int32)
    start[:11] = np.arange(11) * 29 + 5
    num_frames, left, right = 512, 5, 6
    got = count_parts(
        torch.from_numpy(binarized),
        torch.from_numpy(valid),
        torch.from_numpy(start),
        num_frames,
        left,
        right,
    )
    want = jax_count_parts(
        jnp.asarray(binarized), jnp.asarray(valid), jnp.asarray(start), num_frames, left, right
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1].sum()) == 11 * (F - left - right)


def test_post_cluster_from_hard_equals_jax():
    rng = np.random.default_rng(2)
    n, F, S, k_max = 8, 59, 3, 4
    segs = rng.uniform(size=(n, F, S)).astype(np.float32)
    ofs = 2 * S * 5
    hard_all = rng.integers(-2, k_max, size=ofs + n * S + 9).astype(np.int32)
    start = (np.arange(n) * 29).astype(np.int32)
    got = post_cluster_from_hard(
        torch.from_numpy(segs), torch.from_numpy(hard_all), ofs, torch.from_numpy(start), 512, k_max
    )
    want = jax_post_cluster_from_hard(
        jnp.asarray(segs),
        jnp.asarray(hard_all),
        jnp.asarray(ofs, jnp.int32),
        jnp.asarray(start),
        512,
        k_max,
    )
    assert got.shape == (512, k_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the port's long-form against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_clustering", ["auto", False])
def test_longform_equals_jax_longform(pair, tiny_host, device_clustering):
    jp, tp = pair
    if not device_clustering:
        jp, tp = _jax_host_pipeline(pair), tiny_host
    audio = synth_audio(10.3)
    want = JaxLongFormDiarizer(jp, num_shards=3)(audio)
    got = LongFormDiarizer(tp, num_shards=3)(audio)
    assert len(want.turns()) > 0
    same_turns(want, got)


def _jax_host_pipeline(pair):
    from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.diarization import (
        SpeakerDiarizationPipeline as JaxPipeline,
    )

    jp = pair[0]
    return JaxPipeline(
        jp.config,
        params=jp.params,
        seg_batch=8,
        emb_batch=8,
        pyannet_cfg=jp.pyannet_cfg,
        ecapa_cfg=jp.ecapa_cfg,
        precision=jax.lax.Precision.HIGHEST,
        device_clustering=False,
    )


# ---------------------------------------------------------------------------
# the port's long-form against its single-shot pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards,waits", [(1, 2), (3, 4)])
def test_longform_equals_single_shot(tiny, num_shards, waits):
    audio = _noise(10 * 16000 + 3777, seed=5)
    lf = LongFormDiarizer(tiny, num_shards=num_shards)
    assert isinstance(lf.comm, LocalComm) and not lf._multihost
    got = lf(audio)
    assert str(got) == str(tiny(audio))
    # one collect a shard, one for the fused stage 3's result
    assert lf.host_waits == waits


def test_longform_from_wav_file_partial_reads(tiny, monkeypatch):
    audio = _noise(8 * 16000 + 123, seed=7)
    reads = []
    real_read = wavio.read_wav

    def counted_read(path, start_frame=0, max_frames=None):
        if isinstance(path, str):  # read_wav opens the file and calls itself
            reads.append((start_frame, max_frames))
        return real_read(path, start_frame=start_frame, max_frames=max_frames)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "long.wav")
        wavio.write_wav(path, (audio * 32768).round(), 16000, 16)
        quantized = wavio.read_wav(path).normalized_mono()
        monkeypatch.setattr(wavio, "read_wav", counted_read)
        got = LongFormDiarizer(tiny, num_shards=4)(path)
    assert str(got) == str(tiny(quantized))
    # four partial reads, each no longer than its shard's span and halo
    assert len(reads) == 4 and all(m < len(audio) for _, m in reads)


def test_longform_inflight_window_one_equals_default(tiny):
    audio = _noise(8 * 16000 + 100, seed=23)
    a = LongFormDiarizer(tiny, num_shards=4, max_inflight_shards=1)(audio)
    b = LongFormDiarizer(tiny, num_shards=4)(audio)
    assert str(a) == str(b) == str(tiny(audio))


def test_longform_fused_stage3_engages_and_matches_host(tiny, tiny_host, monkeypatch):
    """An eligible request takes the fused device stage 3 (the host
    clusterer is never called) and equals the host-clustering long-form."""
    audio = _noise(9 * 16000 + 555, seed=21)
    lf_dev = LongFormDiarizer(tiny, num_shards=3)
    assert lf_dev._device_clu_eligible(100, None, None, None)
    lf_host = LongFormDiarizer(tiny_host, num_shards=3)
    assert not lf_host._device_clu_eligible(100, None, None, None)
    calls = []
    real = tiny.clusterer

    class Spy:
        config = real.config
        max_num_embeddings = real.max_num_embeddings
        constrained_assignment = real.constrained_assignment

        def __call__(self, *a, **k):
            calls.append(1)
            return real(*a, **k)

    monkeypatch.setattr(tiny, "clusterer", Spy())
    dev = str(lf_dev(audio))
    assert not calls, "the fused long-form stage 3 fell back to host clustering"
    assert dev == str(lf_host(audio))


def test_longform_fused_stage3_out_of_range_falls_back_to_host(tiny, tiny_host, monkeypatch):
    """A fused stage 3 that finds no cluster (num_large 0) hands the
    request to the host clusterer, from the still resident embeddings."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import device as devclu

    real = devclu.device_cluster

    def no_cluster(*args, **kwargs):
        res = real(*args, **kwargs)
        return res._replace(num_large=torch.zeros_like(res.num_large))

    monkeypatch.setattr(devclu, "device_cluster", no_cluster)
    audio = _noise(7 * 16000 + 321, seed=24)
    lf = LongFormDiarizer(tiny, num_shards=3)
    got = lf(audio)
    # three collects, the fused result, the embeddings, the activations
    assert lf.host_waits == 6
    assert str(got) == str(LongFormDiarizer(tiny_host, num_shards=3)(audio))


def test_longform_bounds_take_host_path(tiny, tiny_host):
    audio = _noise(6 * 16000, seed=22)
    lf = LongFormDiarizer(tiny, num_shards=2)
    assert not lf._device_clu_eligible(100, 2, None, None)
    got = lf(audio, num_speakers=2)
    assert lf.host_waits == 3  # two collects, one post-clustering fetch
    assert str(got) == str(LongFormDiarizer(tiny_host, num_shards=2)(audio, num_speakers=2))
    assert str(got) == str(tiny(audio, num_speakers=2))


def test_longform_rejects_a_shard_count_off_the_processes(tiny):
    with pytest.raises(ValueError, match="one shard per process"):
        LongFormDiarizer(tiny, num_shards=3, comm=FakeComm(_Rendezvous(2), 0))


# ---------------------------------------------------------------------------
# the one-shard-a-process branch, with simulated processes
# ---------------------------------------------------------------------------


class _Rendezvous:
    """A collective for threads: each deposits its array, a barrier, all
    read the stack (an all-gather's contract)."""

    def __init__(self, world: int):
        self.world = world
        self.barrier = threading.Barrier(world)
        self.bufs = [None] * world

    def allgather(self, rank: int, x: np.ndarray) -> np.ndarray:
        self.bufs[rank] = np.asarray(x)
        self.barrier.wait()
        out = np.stack(self.bufs)
        self.barrier.wait()  # every thread read before the next round
        return out


class FakeComm:
    def __init__(self, rendezvous: _Rendezvous, rank: int):
        self._rdv = rendezvous
        self._rank = rank

    def process_count(self) -> int:
        return self._rdv.world

    def process_index(self) -> int:
        return self._rank

    def allgather(self, x: np.ndarray) -> np.ndarray:
        return self._rdv.allgather(self._rank, x)


def _run_simulated_processes(pipeline, audio, world: int):
    rdv = _Rendezvous(world)
    results = [None] * world
    errors = []

    def worker(rank):
        try:
            lf = LongFormDiarizer(pipeline, comm=FakeComm(rdv, rank))
            assert lf._multihost and lf.num_shards == world
            results[rank] = lf(audio)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append((rank, e))
            rdv.barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "simulated processes deadlocked"
    assert not errors, errors
    return results


def test_processes_uneven_shards_with_orphan(tiny):
    """2 processes, 9 chunks (5 + 4), a short orphan tail in the last."""
    audio = _noise(int(4.8 * 16000), seed=11)
    single = str(tiny(audio))
    for rank, ann in enumerate(_run_simulated_processes(tiny, audio, world=2)):
        assert str(ann) == single, f"process {rank} diverged"


def test_processes_more_than_chunks(tiny):
    """3 processes, 1 chunk: two own empty shards and still join every
    collective."""
    audio = _noise(int(0.9 * 16000), seed=12)
    single = str(tiny(audio))
    for rank, ann in enumerate(_run_simulated_processes(tiny, audio, world=3)):
        assert str(ann) == single, f"process {rank} diverged"
