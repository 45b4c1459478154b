"""The port's command line against the JAX pipeline, on the CPU.

``cli.main`` runs with ``--device cpu`` and the pipeline constructor
replaced by a small-width factory (tiny1s, the JAX package's seeded weights,
float32 at HIGHEST, host clustering on both sides). The printed turn lines,
the ``== path`` headers of a several-file run (through ``map``) and the RTTM
must be what the JAX pipeline's turns give in the same format; the stderr
timing lines must be there; a converted ``.npz`` directory loads, a partial
one warns and keeps seed-0 weights for the other model; a pyannote ``.ckpt``,
a constant-folded segment ONNX and a speechbrain ``embedding_model.ckpt``
load into the weights the JAX package's CLI would load from them, and an
empty directory raises ``FileNotFoundError``, as there.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _cfg import SMALL_ECAPA, SMALL_PYANNET, TINY1S_CFG
from pyannote_audio_speaker_diarization_cpp_tpu.models import ingest as jingest
from pyannote_audio_speaker_diarization_cpp_tpu_torch import cli
from pyannote_audio_speaker_diarization_cpp_tpu_torch.io.wav import write_wav
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import convert as tconvert
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import save_checkpoint
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
)
from _torch_threads import two_torch_threads  # noqa: F401
from test_convert_real_scale import (
    make_pyannote_pyannet_state_dict,
    make_speechbrain_ecapa_state_dict,
)
from test_ingest import _write_segment_onnx
from test_torch_pipeline import build_pair, synth_audio


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jp, tp = build_pair(TINY1S_CFG, batch=8)
    params = jax.tree.map(np.asarray, jp.params)
    directory = tmp_path_factory.mktemp("cli")
    paths = []
    for seconds, seed in ((2.3, 1), (3.0, 2)):
        path = str(directory / f"clip_{seed}.wav")
        write_wav(path, synth_audio(seconds, seed=seed) * 32768.0, 16000)
        paths.append(path)
    return dict(jp=jp, tp=tp, params=params, paths=paths, dir=directory)


@pytest.fixture
def built(setup, monkeypatch):
    """Replaces the CLI's pipeline constructor; returns a record of the
    arguments the CLI gave it, the last pipeline built and its calls to
    ``map``."""
    tp = setup["tp"]
    record = {"kwargs": [], "map_calls": 0}

    def factory(params=None, seed=0, seg_batch=None, emb_batch=None, device=None):
        record["kwargs"].append(dict(params=params, seed=seed, device=device))
        pipe = SpeakerDiarizationPipeline(
            tp.config,
            params=setup["params"] if params is None else params,
            seed=seed,
            seg_batch=8,
            emb_batch=8,
            precision="highest",
            pyannet_cfg=tp.pyannet_cfg,
            ecapa_cfg=tp.ecapa_cfg,
            device=device,
            device_clustering=False,
        )
        real_map = pipe.map

        def counted_map(*args, **kwargs):
            record["map_calls"] += 1
            return real_map(*args, **kwargs)

        pipe.map = counted_map
        record["pipeline"] = pipe
        return pipe

    monkeypatch.setattr(cli, "SpeakerDiarizationPipeline", factory)
    return record


def turn_lines(annotation):
    return [
        f"[{t.start:.3f} -- {t.end:.3f}] --> Speaker_{t.label}" for t in annotation.turns()
    ]


def test_one_file_prints_the_jax_turns(setup, built, capsys):
    path = setup["paths"][0]
    assert cli.main([path, "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    want = turn_lines(setup["jp"](path))
    assert want and out.splitlines() == want
    assert built["kwargs"][0]["device"] == "cpu" and built["kwargs"][0]["params"] is None
    assert built["map_calls"] == 0
    for stage in ("Segmentation", "Embedding", "Fetch", "Clustering", "Total"):
        assert f"{stage} time: " in err
    assert "Embedding time: 0ms" in err  # stage 2's CUDA-event time: none on the CPU


def test_two_files_run_through_map_with_headers_and_rttm(setup, built, capsys, tmp_path):
    rttm = tmp_path / "out.rttm"
    paths = setup["paths"]
    assert cli.main([*paths, "--device", "cpu", "--rttm", str(rttm)]) == 0
    out, _ = capsys.readouterr()
    annotations = [setup["jp"](p) for p in paths]
    want = []
    for path, annotation in zip(paths, annotations):
        want += [f"== {path}"] + turn_lines(annotation)
    assert out.splitlines() == want
    assert built["map_calls"] == 1
    assert rttm.read_text() == "".join(a.to_rttm(p) + "\n" for p, a in zip(paths, annotations))


def test_npz_checkpoint_directory_loads(setup, built, capsys, tmp_path):
    save_checkpoint(str(tmp_path / "ckpt"), setup["params"])
    path = setup["paths"][1]
    assert cli.main([path, "--device", "cpu", "--checkpoint", str(tmp_path / "ckpt")]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines() == turn_lines(setup["jp"](path))
    assert "warning" not in err
    assert set(built["kwargs"][0]["params"]) == {"segmentation", "embedding"}


def test_partial_artifact_warns_and_keeps_seed0_weights(setup, built, capsys, tmp_path):
    save_checkpoint(str(tmp_path / "seg"), {"segmentation": setup["params"]["segmentation"]})
    assert cli.main([setup["paths"][0], "--device", "cpu", "--seg-model", str(tmp_path / "seg")]) == 0
    _, err = capsys.readouterr()
    assert "warning: no embedding weights" in err and "seed-0" in err
    assert set(built["kwargs"][0]["params"]) == {"segmentation"}
    assert built["kwargs"][0]["seed"] == 0
    # the embedding model is the seed-0 init, the segmentation model the file's
    pipe = built["pipeline"]
    seeded = SpeakerDiarizationPipeline(
        pipe.config, seed=0, pyannet_cfg=pipe.pyannet_cfg, ecapa_cfg=pipe.ecapa_cfg, device="cpu"
    )
    for name, value in seeded.embedding_model.state_dict().items():
        assert torch.equal(pipe.embedding_model.state_dict()[name], value), name
    loaded = setup["tp"].segmentation_model.state_dict()
    for name, value in pipe.segmentation_model.state_dict().items():
        assert torch.equal(loaded[name], value), name


# the JAX package's load_params_auto reads a PyanNet at the published layer
# counts and filterbank (4 LSTM layers, 80 filters of 251 taps: the folded
# ONNX filterbank is found by that shape); the other widths stay small
INGEST_PYANNET = dataclasses.replace(SMALL_PYANNET, num_filters=80, lstm_layers=4)


@pytest.fixture(scope="module")
def ingest_artifacts(tmp_path_factory):
    """A pyannote Lightning ``.ckpt``, a constant-folded segment ONNX, a
    speechbrain ``embedding_model.ckpt`` and an empty directory."""
    directory = tmp_path_factory.mktemp("ingest")
    rng = np.random.default_rng(21)
    seg = make_pyannote_pyannet_state_dict(rng, INGEST_PYANNET)
    emb = make_speechbrain_ecapa_state_dict(rng, SMALL_ECAPA)
    torch.save(
        {"state_dict": {k: torch.from_numpy(v.copy()) for k, v in seg.items()}},
        str(directory / "model.ckpt"),
    )
    _write_segment_onnx(str(directory / "segment2.onnx"), seg, INGEST_PYANNET, folded=True)
    torch.save(
        {k: torch.from_numpy(np.asarray(v).copy()) for k, v in emb.items()},
        str(directory / "embedding_model.ckpt"),
    )
    (directory / "empty_dir").mkdir()
    return directory


@pytest.mark.parametrize(
    "flag, artifact, part",
    [
        ("--checkpoint", "model.ckpt", "segmentation"),
        ("--seg-model", "segment2.onnx", "segmentation"),
        ("--emb-model", "embedding_model.ckpt", "embedding"),
        ("--checkpoint", "empty_dir", None),
    ],
)
def test_ingested_artifacts_load_as_the_jax_cli_loads_them(
    setup, ingest_artifacts, monkeypatch, capsys, flag, artifact, part
):
    """The CLI reads every artifact through models/ingest.py: the pipeline
    gets the part the JAX package's ``load_params_auto`` reads from the
    file (the folded ONNX as a baked filterbank), seed-0 weights for the
    other part with a warning, and runs; an empty directory raises
    ``FileNotFoundError``, as in the JAX package."""
    tp = setup["tp"]
    built = []

    def factory(params=None, seed=0, seg_batch=None, emb_batch=None, device=None):
        pipe = SpeakerDiarizationPipeline(
            tp.config,
            params=params,
            seed=seed,
            seg_batch=8,
            emb_batch=8,
            precision="highest",
            pyannet_cfg=PyanNetConfig(**dataclasses.asdict(INGEST_PYANNET)),
            ecapa_cfg=tp.ecapa_cfg,
            device=device,
            device_clustering=False,
        )
        built.append((params, pipe))
        return pipe

    monkeypatch.setattr(cli, "SpeakerDiarizationPipeline", factory)
    path = str(ingest_artifacts / artifact)
    argv = [setup["paths"][0], "--device", "cpu", flag, path]
    if part is None:
        with pytest.raises(FileNotFoundError, match="no loadable weights"):
            jingest.load_params_auto(path)
        with pytest.raises(FileNotFoundError, match="no loadable weights"):
            cli.main(argv)
        assert not built
        return
    assert cli.main(argv) == 0
    out, err = capsys.readouterr()
    assert out.splitlines() and "warning: no" in err
    (params, pipe), = built
    assert set(params) == {part}
    want = jax.tree.map(np.asarray, jingest.load_params_auto(path)[part])
    model = pipe.segmentation_model if part == "segmentation" else pipe.embedding_model
    state = (
        tconvert.pyannet_state_from_tree(want)
        if part == "segmentation"
        else tconvert.ecapa_state_from_tree(want)
    )
    assert sorted(model.state_dict()) == sorted(state)
    for name, value in state.items():
        assert torch.equal(model.state_dict()[name], value), name
    if artifact == "segment2.onnx":
        assert model.sincnet.sinc.baked


def test_device_defaults_to_the_card(setup, built, capsys):
    """Without --device the pipeline is asked for the card (device None),
    which raises on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([setup["paths"][0]])
    assert built["kwargs"][0]["device"] is None


def test_params_to_jax_inverts_params_from_jax(setup):
    """The port's models saved in the JAX layout (what chip_smoke.py hands
    the CLI) are the JAX tree they were loaded from, key for key."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import (
        flatten_pytree,
        params_to_jax,
    )

    tp = setup["tp"]
    got = flatten_pytree(params_to_jax(tp.segmentation_model, tp.embedding_model))
    want = flatten_pytree(setup["params"])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value, np.float32), err_msg=key)
