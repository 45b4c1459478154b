"""The port's differential dumps against the JAX package's, on the CPU.

The port's ``run_with_dumps`` and the JAX package's run live on the same
audio (tests/test_golden_dumps.py's ``synth_wav``) and the same weights (the
small5s configuration, seed-0 JAX init, float32 and HIGHEST on both sides),
each writing the reference's text dumps; ``compare_dumps`` then holds every
one of the 39 checklist names at the reference's tolerances (exact for
discrete tensors, rtol 1e-3 / atol 1e-4 for floats). The stage-1 names and
the stage-2 inputs are also held against the committed goldens
(tests/goldens/dumps_small.npz), which do not depend on the ECAPA trunk's
dtype. The text format must be the JAX module's, byte for byte.
"""

import dataclasses
import os

import numpy as np
import pytest

from pyannote_audio_speaker_diarization_cpp_tpu.config import DEFAULT_CONFIG
from pyannote_audio_speaker_diarization_cpp_tpu.utils import debug_dump as jdd
from pyannote_audio_speaker_diarization_cpp_tpu.utils.instrumented import (
    run_with_dumps as jax_run_with_dumps,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils import debug_dump as tdd
from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils.instrumented import run_with_dumps
from test_golden_dumps import CHECKLIST, GOLDEN_PATH, synth_wav
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import build_pair, same_turns

SMALL5S_CFG = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)

STAGE1_NAMES = [
    "segmentations",
    "binarize_score",
    "on",
    "same_as",
    "samples",
    "well_defined_idx",
    "initial_state",
    "binary_ndarray",
    "binarized_segmentations",
    "clean_segmentations",
    "batch_masks",
    "trimmed",
    "sum_trimmed",
    "count_data",
    "count",
]
STAGE2_INPUTS = ["masks", "imasks", "signals", "wav_lens", "final_wav_lens"]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("dumps"))
    jp, tp = build_pair(SMALL5S_CFG, batch=4, seed=0)
    audio = synth_wav()
    jdump = jdd.DumpSession(directory=directory, prefix="jax")
    tdump = tdd.DumpSession(directory=directory, prefix="torch")
    want = jax_run_with_dumps(jp, audio, jdump)
    got = run_with_dumps(tp, audio, tdump)
    return dict(dir=directory, jdump=jdump, tdump=tdump, want=want, got=got, tp=tp, audio=audio)


def test_every_checklist_name_matches_the_jax_dump(live):
    results = tdd.compare_dumps(live["dir"], ours="torch", theirs="jax", names=CHECKLIST)
    assert [r.name for r in results] == CHECKLIST
    bad = [f"{r.name}: {r.status} {r.detail}" for r in results if r.status != "match"]
    assert not bad, "\n".join(bad)
    assert len(live["want"].turns()) > 0
    same_turns(live["want"], live["got"])


def test_stage1_and_stage2_inputs_match_the_goldens(live):
    golden = tdd.load_npz(GOLDEN_PATH)
    names = STAGE1_NAMES + STAGE2_INPUTS
    results = tdd.compare_tensors(
        {n: live["tdump"].tensors[n] for n in names}, {n: golden[n] for n in names}
    )
    assert sorted(r.name for r in results) == sorted(names)
    bad = [f"{r.name}: {r.status} {r.detail}" for r in results if r.status != "match"]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize(
    "name",
    [
        "count",  # int64
        "on",  # bool
        "embeddings",  # float64, 3-D, NaN rows
        "final_wav_lens",  # float32
        "hard_clusters",  # negative ints
        "soft_clusters",
        "clustered_segmentations",  # NaN, 3-D
        "sorted_speakers",
    ],
)
def test_text_format_is_the_jax_modules_byte_for_byte(live, name):
    arr = live["tdump"].tensors[name]
    text = tdd.format_tensor(arr)
    assert text == jdd.format_tensor(arr)
    np.testing.assert_array_equal(tdd.parse_tensor(text), jdd.parse_tensor(text))
    with open(os.path.join(live["dir"], f"torch_{name}.txt")) as f:
        assert f.read() == text


def test_call_with_dump_records_what_run_with_dumps_does(live):
    """``__call__(dump=...)`` fetches every stage output and runs the host
    twin: its tensors and turns are run_with_dumps' own."""
    dump = tdd.DumpSession(write_text=False)
    annotation = live["tp"](live["audio"], dump=dump)
    assert str(annotation) == str(live["got"])
    names = sorted(set(dump.tensors) - {"embeddings"})
    assert {"segmentations", "count", "hard_clusters", "discrete_diarization"} <= set(names)
    assert set(names) <= set(CHECKLIST)
    results = tdd.compare_tensors(dump.tensors, {n: live["tdump"].tensors[n] for n in names})
    bad = [f"{r.name}: {r.status} {r.detail}" for r in results if r.status != "match"]
    assert not bad, "\n".join(bad)
    np.testing.assert_array_equal(dump.tensors["embeddings"], live["tdump"].tensors["embeddings"])
