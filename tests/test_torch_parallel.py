"""The port's data-parallel layer on the CPU (parallel/mesh.py,
parallel/sharding.py, parallel/dryrun.py and the pipeline's ``mesh=``):
the split and gather helpers, a one-rank gloo group in this process, and
real two-rank gloo groups in spawned processes, where every entry point of
the pipeline on the mesh must equal the mesh-less pipeline string for
string (each rank runs its block of whole batches, so the libraries see
the calls one rank sees)."""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_threads import two_torch_threads  # noqa: F401
from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import (
    DiarizationConfig,
    SegmentationConfig,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
    PyanNetConfig,
    pyannet_num_frames,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun
from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.longform import (
    LongFormDiarizer,
    TorchHostComm,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.mesh import (
    DataMesh,
    backend_for,
    batch_counts,
    batch_spec,
    make_mesh,
    replicated,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel.sharding import (
    all_gather_embeddings,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.streaming import (
    StreamingDiarizer,
)

# tiny1s (1 s / 0.5 s windows) at the small model widths, float32 parity
# mode; batches of 2 so that a 2-rank mesh splits every stage
TINY = dict(
    config=DiarizationConfig(
        segmentation=SegmentationConfig(
            duration=1.0, step=0.5, batch_size=8, num_frames=pyannet_num_frames(16000)
        ),
        chunk_bucket=8,
        compute_dtype="float32",
        transfer_dtype="float32",
    ),
    pyannet_cfg=PyanNetConfig(
        num_filters=32, conv_channels=16, lstm_hidden=16, lstm_layers=2, linear_hidden=16
    ),
    ecapa_cfg=EcapaConfig(
        in_channels=80,
        channels=(64, 64, 64, 64, 128),
        attention_channels=16,
        se_channels=16,
        emb_dim=32,
    ),
    seg_batch=2,
    emb_batch=2,
    precision="highest",
)


def _audio(seconds, seed):
    return dryrun.synthetic_clip(seconds, seed=seed)


def _fake_mesh(rank, world):
    return DataMesh(None, rank, world, torch.device("cpu"), "gloo")


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_batches,world", [(8, 2), (7, 3), (1, 4), (0, 2), (5, 1)])
def test_batch_spec_blocks_cover_in_rank_order(num_batches, world):
    counts = batch_counts(_fake_mesh(0, world), num_batches)
    assert sum(counts) == num_batches and max(counts) - min(counts) <= 1
    blocks = [list(batch_spec(_fake_mesh(r, world), num_batches)) for r in range(world)]
    assert [len(b) for b in blocks] == counts
    assert sum(blocks, []) == list(range(num_batches))


def test_backend_for_device():
    assert backend_for("cpu") == "gloo"
    assert backend_for(torch.device("cuda", 0)) == "nccl"


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()


def test_pipeline_mesh_batches_must_divide():
    mesh = types.SimpleNamespace(device=torch.device("cpu"), world_size=3)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        SpeakerDiarizationPipeline(mesh=mesh, **TINY)


# ---------------------------------------------------------------------------
# a one-rank gloo group in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_make_mesh_on_gloo(mesh1):
    assert (mesh1.rank, mesh1.world_size) == (0, 1)
    assert mesh1.backend == "gloo" and mesh1.device == torch.device("cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bool])
def test_all_gather_one_rank(mesh1, dtype):
    x = (torch.arange(12).reshape(4, 3) % 3 == 0).to(dtype)
    for counts in ([4], None):
        got = all_gather_embeddings(x, mesh1, counts)
        assert got.dtype == dtype and torch.equal(got, x)
    assert torch.equal(replicated(mesh1, x[:0], [0]), x[:0])
    with pytest.raises(ValueError, match="counts say"):
        all_gather_embeddings(x, mesh1, [3])


def test_torch_host_comm_one_rank(mesh1):
    comm = TorchHostComm()
    assert (comm.process_count(), comm.process_index()) == (1, 0)
    for x in (np.arange(6.0).reshape(2, 3), np.array([[True, False]])):
        got = comm.allgather(x)
        assert got.dtype == x.dtype and np.array_equal(got, x[None])


@pytest.fixture(scope="module")
def pair1(mesh1):
    """(mesh-less pipeline, the same pipeline on the one-rank mesh)."""
    return (
        SpeakerDiarizationPipeline(device="cpu", **TINY),
        SpeakerDiarizationPipeline(mesh=mesh1, **TINY),
    )


def test_pipeline_on_one_rank_mesh_equals_meshless(pair1):
    single, sharded = pair1
    audio = _audio(5.3, seed=0)
    for kwargs in ({}, {"num_speakers": 2}):
        assert str(sharded(audio, **kwargs)) == str(single(audio, **kwargs))
    a, b = single.run_chunks(audio, 9), sharded.run_chunks(audio, 9)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert sharded.warmup(2.0) == single.warmup(2.0)
    lf = LongFormDiarizer(sharded, num_shards=2, comm=TorchHostComm())
    assert not lf._multihost
    assert str(lf(audio)) == str(LongFormDiarizer(single, num_shards=2)(audio))


def test_longform_one_shard_a_process_takes_a_meshless_pipeline(pair1):
    class TwoProcesses:
        def process_count(self):
            return 2

        def process_index(self):
            return 0

    with pytest.raises(ValueError, match="mesh-less pipeline"):
        LongFormDiarizer(pair1[1], comm=TwoProcesses())


# ---------------------------------------------------------------------------
# real two-rank gloo groups, spawned
# ---------------------------------------------------------------------------


def _entry_points(single, sharded, audio, other):
    """Every entry point of the pipeline on the mesh against the mesh-less
    pipeline: True where they agree string for string."""
    out = {"call": str(sharded(audio)) == str(single(audio))}
    out["bounds"] = str(sharded(audio, num_speakers=2)) == str(single(audio, num_speakers=2))
    out["map"] = [str(a) for a in sharded.map([audio, other])] == [
        str(single(audio)),
        str(single(other)),
    ]
    a, b = single.run_chunks(audio, 9), sharded.run_chunks(audio, 9)
    out["run_chunks"] = all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    out["stage2_internals"] = all(
        np.array_equal(x, y)
        for x, y in zip(single.stage2_internals(audio, 9), sharded.stage2_internals(audio, 9))
    )
    out["warmup"] = sharded.warmup(2.0) == single.warmup(2.0)
    out["longform"] = str(LongFormDiarizer(sharded, num_shards=2)(audio)) == str(
        LongFormDiarizer(single, num_shards=2)(audio)
    )
    streams = [StreamingDiarizer(p, emit_every=4) for p in (single, sharded)]
    for piece in np.array_split(audio, 3):
        for s in streams:
            s.feed(piece)
    out["stream"] = str(streams[0].flush()) == str(streams[1].flush())
    return out


def _mesh_rank(mesh):
    """One rank of the spawned 2-rank group: the gather of uneven blocks,
    then every entry point on the mesh against the mesh-less pipeline, with
    batches of 2 (every rank runs batches of both stages) and with one
    SincNet batch of 16 (rank 1 runs none and sends an empty block)."""
    out = {}
    rows = (3, 5)[mesh.rank]
    block = torch.arange(rows * 4, dtype=torch.float32).reshape(rows, 4) + 100 * mesh.rank
    want = torch.cat(
        [torch.arange(n * 4, dtype=torch.float32).reshape(n, 4) + 100 * r for r, n in enumerate((3, 5))]
    )
    # every rank joins every gather (no short-circuit)
    gathered = [
        (all_gather_embeddings(block, mesh, [3, 5]), want),
        (all_gather_embeddings(block, mesh), want),
        (all_gather_embeddings(block[:0] if mesh.rank else block, mesh), want[:3]),
        (all_gather_embeddings(block > 104, mesh), want > 104),
    ]
    out["gather"] = all(torch.equal(got, exp) for got, exp in gathered)
    audio, other = _audio(5.3, seed=0), _audio(3.1, seed=1)
    for name, seg_batch in (("batches_of_2", 2), ("one_sincnet_batch", 16)):
        kwargs = dict(TINY, seg_batch=seg_batch)
        single = SpeakerDiarizationPipeline(device="cpu", **kwargs)
        sharded = SpeakerDiarizationPipeline(mesh=mesh, **kwargs)
        calls = []
        sharded.segmentation_model.sincnet.register_forward_hook(lambda *_: calls.append(1))
        sharded(audio)
        # 10 chunks in 16 padded: 8 SincNet batches of 2, 4 on each rank;
        # or 1 batch of 16, on rank 0
        out[name] = {"sincnet_batches": len(calls), **_entry_points(single, sharded, audio, other)}
    # one shard a process over the same group, mesh-less pipelines
    per_process = LongFormDiarizer(single, comm=TorchHostComm(mesh.group))
    out["one_shard_a_process"] = (
        per_process._multihost and str(per_process(audio)) == str(single(audio))
    )
    return out


def test_two_gloo_ranks_equal_one_rank():
    results = dryrun.spawn(_mesh_rank, 2, device="cpu", threads=2, timeout=300)
    entry_points = dict.fromkeys(
        ("call", "bounds", "map", "run_chunks", "stage2_internals", "warmup", "longform", "stream"),
        True,
    )
    for rank, out in enumerate(results):
        assert out == {
            "gather": True,
            "batches_of_2": {"sincnet_batches": 4, **entry_points},
            "one_sincnet_batch": {"sincnet_batches": 1 - rank, **entry_points},
            "one_shard_a_process": True,
        }, (rank, out)


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


def test_dryrun_cases_on_two_gloo_ranks():
    """The dry run's three cases (1: num_speakers=2, 1b: device clustering,
    1c: long-form with 2 shards) on a 2-rank mesh against one rank; then a
    rank that raises fails the spawn."""
    reports = dryrun.dryrun_multichip(
        2, dict(TINY), _audio(5.3, seed=0), device="cpu", threads=2, timeout=300
    )
    for r in reports:
        assert r["emb_max_abs_err"] == 0.0 and r["too_short_equal"] and r["embedding_rows"] > 0
        assert all(r[case]["turns_equal"] and r[case]["turns"] > 0 for case in ("1", "1b", "1c"))
    assert [r["rank"] for r in reports] == [0, 1]
    with pytest.raises(Exception, match="rank 1 fails"):
        dryrun.spawn(_failing_rank, 2, device="cpu", threads=1, timeout=120)


def test_spawn_runs_on_the_card_by_default(monkeypatch):
    """Without ``device`` the ranks go to the card (NCCL), and with no card
    the spawn refuses before it starts a process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for run in (
        lambda: dryrun.spawn(_failing_rank, 2),
        lambda: dryrun.dryrun_multichip(2, dict(TINY), _audio(1.0, seed=0)),
    ):
        with pytest.raises(RuntimeError, match="need 2 CUDA card"):
            run()
