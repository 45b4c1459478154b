"""When stage 2 replays its captured CUDA graph (pipelines/stage2_graph.py),
checked on the CPU with the tiny1s pipeline.

The rule reads only what a call can observe: a CUDA device, a full batch,
and no request for the packed signals. On the CPU every batch runs
eagerly and the ``dispatch.stage2`` span counts ``replayed == 0``. The
graph key changes with each TF32 flag, the trunk's dtype and layout. With
the capture replaced by a stand-in that runs the chain eagerly, the
pipeline captures once for every request length and precision it sees and
replays every full batch. The card tests (tests/test_torch_cuda.py) hold
the real graph against the eager chain.
"""

import numpy as np
import pytest
import torch

from _torch_cfg import TINY1S_CFG, make_tiny1s_pipeline
from _torch_threads import two_torch_threads  # noqa: F401
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import stage2_graph as sg
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    StageTimings,
    precision_scope,
)

CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")
S = TINY1S_CFG.segmentation.num_speakers


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (t % 2 < 1) + 0.1 * rng.normal(size=t.shape)
    return x.astype(np.float32)


def _stage2_inputs(pipe, num_chunks, seed=0):
    """(chunks (n, window), chosen (n, S, F)) of random windows and 0/1
    masks."""
    rng = np.random.default_rng(seed)
    seg = pipe.config.segmentation
    chunks = torch.from_numpy(rng.normal(size=(num_chunks, seg.window_size)).astype(np.float32))
    chosen = torch.from_numpy(
        (rng.uniform(size=(num_chunks, S, seg.num_frames)) < 0.6).astype(np.float32)
    )
    return chunks, chosen


@pytest.fixture(scope="module")
def pipe():
    return make_tiny1s_pipeline(device="cpu")


@pytest.mark.parametrize(
    "device,rows,with_internals,engaged",
    [
        (CUDA, 32, False, True),
        (CPU, 32, False, False),
        (CUDA, 31, False, False),
        (CUDA, 32, True, False),
    ],
    ids=["cuda_full_batch", "cpu", "short_batch", "with_internals"],
)
def test_the_rule(device, rows, with_internals, engaged):
    assert sg.engages(device, rows, 32, with_internals) is engaged


def _key(emb_dtype=torch.bfloat16, layout="nch"):
    return sg.graph_key(
        CUDA, (32, 80000, 293), (torch.float32, torch.float32), emb_dtype, layout
    )


@pytest.mark.parametrize(
    "change", ["matmul_tf32", "cudnn_tf32", "cudnn_deterministic", "emb_dtype", "layout"]
)
def test_the_graph_key_changes(change):
    flags = {
        "matmul_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
        "cudnn_tf32": (torch.backends.cudnn, "allow_tf32"),
        "cudnn_deterministic": (torch.backends.cudnn, "deterministic"),
    }
    base = _key()
    assert _key() == base
    if change in flags:
        owner, name = flags[change]
        saved = getattr(owner, name)
        setattr(owner, name, not saved)
        try:
            assert _key() != base
        finally:
            setattr(owner, name, saved)
        assert _key() == base
    elif change == "emb_dtype":
        assert _key(emb_dtype=torch.float32) != base
    else:
        assert _key(layout="nhc") != base


def test_the_graph_key_of_each_precision():
    """A graph captured at the defaults never replays under "highest"."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with precision_scope("default"):
        default = _key()
    with precision_scope("highest"):
        highest = _key()
    assert default[5:7] == flags and highest[5:7] == (False, False)
    assert (default == highest) == (flags == (False, False))


def test_a_request_on_the_cpu_runs_eagerly(pipe):
    t = StageTimings()
    pending = pipe._dispatch(_audio(5.0), timings=t)
    counts = {s.name: s.counters for s in t.spans}["dispatch.stage2"]
    rows = pending["num_padded"] * S
    assert counts == {"batches": rows // pipe.emb_batch, "replayed": 0}
    assert pipe.stage2_graph_captures == 0 and not pipe._stage2_graphs


@pytest.mark.parametrize("num_chunks,with_internals", [(3, False), (8, True)],
                         ids=["short_batch", "with_internals"])
def test_stage2_asks_the_rule_and_runs_eagerly(pipe, monkeypatch, num_chunks, with_internals):
    """``_stage2`` asks the rule with the pipeline's device, each batch's
    row count and ``with_internals``, and returns what the eager chain gives
    batch by batch."""
    asked, real = [], sg.engages

    def spy(*args):
        asked.append(args)
        return real(*args)

    monkeypatch.setattr(sg, "engages", spy)
    chunks, chosen = _stage2_inputs(pipe, num_chunks)
    counts = {}
    with torch.inference_mode():
        out = pipe._stage2(chunks, chosen, with_internals, counts=counts)
        rows = chosen.reshape(num_chunks * S, -1)
        index = torch.arange(rows.shape[0]) // S
        eb = pipe.emb_batch
        want = [pipe._stage2_batch(chunks[index[i : i + eb]], rows[i : i + eb])
                for i in range(0, rows.shape[0], eb)]
    sizes = [min(eb, rows.shape[0] - i) for i in range(0, rows.shape[0], eb)]
    assert asked == [(CPU, n, eb, with_internals) for n in sizes]
    assert counts == {"batches": len(sizes), "replayed": 0}
    assert len(out) == (4 if with_internals else 2)
    for k, got in enumerate(out):
        assert torch.equal(got.to(want[0][k].dtype), torch.cat([w[k] for w in want])), k


class EagerStandIn:
    """Stage2Graph's interface, running the chain eagerly: the pipeline's
    cache and its bookkeeping, on the CPU."""

    made = []

    def __init__(self, chain, chunks, index, masks):
        self.chain, self.calls = chain, 0
        EagerStandIn.made.append(self)

    def __call__(self, chunks, index, masks):
        self.calls += 1
        return self.chain(chunks[index], masks)


def test_one_capture_serves_every_length_and_precision(monkeypatch):
    """With a stand-in capture that engages on the CPU: two request lengths
    in different chunk buckets share one capture and replay every batch,
    with the eager path's embeddings; "highest" captures its own."""
    pipe = make_tiny1s_pipeline(device="cpu")
    eager = {}
    for seconds in (5.0, 3.0):
        t = StageTimings()
        eager[seconds] = pipe._dispatch(_audio(seconds), timings=t)
    EagerStandIn.made = []
    monkeypatch.setattr(sg, "Stage2Graph", EagerStandIn)
    monkeypatch.setattr(sg, "engages", lambda device, rows, batch, internals: (
        rows == batch and not internals))
    padded = set()
    for seconds in (5.0, 3.0):
        t = StageTimings()
        pending = pipe._dispatch(_audio(seconds), timings=t)
        counts = {s.name: s.counters for s in t.spans}["dispatch.stage2"]
        assert counts["replayed"] == counts["batches"] == pending["num_padded"] * S // pipe.emb_batch
        assert torch.equal(pending["emb"], eager[seconds]["emb"])
        assert torch.equal(pending["too_short"], eager[seconds]["too_short"])
        padded.add(pending["num_padded"])
    assert len(padded) == 2
    assert pipe.stage2_graph_captures == 1 and len(EagerStandIn.made) == 1
    with precision_scope("highest"):
        pipe._dispatch(_audio(3.0))
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        assert pipe.stage2_graph_captures == 2 and len(pipe._stage2_graphs) == 2


def test_the_launch_counters_exist():
    for fn, attr in sg.LAUNCH_COUNTERS:
        assert isinstance(getattr(fn, attr), int), (fn, attr)
