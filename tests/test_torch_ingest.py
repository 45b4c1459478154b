"""The port's weight ingest (models/ingest.py, the converters in
models/convert.py) against the JAX package's, and the baked sinc filterbank
an ingested constant-folded export gives, on the CPU.

The artifacts are written in the formats the published models ship in
(``torch.save`` zip archives, ONNX protobuf) from the JAX tests' own
fixture builders, at the published widths, once for the module. Every
reader must give arrays exactly equal to the JAX package's; a malicious
pickle must stay inert; the converters must round-trip; and a PyanNet tree
whose filterbank is baked must load in the port and match the JAX
package's segmentations and turns (small5s, float32).
"""

import os

import jax
import numpy as np
import pytest
import torch

from pyannote_audio_speaker_diarization_cpp_tpu.models import convert as jconvert
from pyannote_audio_speaker_diarization_cpp_tpu.models import ingest as jingest
from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as jpyannet
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import convert as tconvert
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import ingest as tingest
from _cfg import SMALL_PYANNET
from _torch_threads import two_torch_threads  # noqa: F401
from test_convert_real_scale import (
    make_pyannote_pyannet_state_dict,
    make_speechbrain_ecapa_state_dict,
)
from test_ingest import WeirdHyperparams, _pb_model, _pb_node, _pb_tensor, _write_segment_onnx
from test_torch_pipeline import build_pair, check_end_to_end, check_stage1, run_stages, synth_audio

GATE_CKPT = os.path.join(os.path.dirname(__file__), "goldens", "gate_ckpt")


def _torch_sd(sd, dtype=None, view=False):
    """numpy state dict -> torch tensors for ``torch.save``; ``view``: each
    2-D tensor saved as a transposed view (storage strides not row-major)."""
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        t = torch.from_numpy(v.T.copy()).t() if view and v.ndim == 2 else torch.from_numpy(v.copy())
        out[k] = t if dtype is None or not t.is_floating_point() else t.to(dtype)
    return out


def _gemm_onnx(path, sd, cfg, trans_b):
    """segment ONNX whose linears are single Gemm nodes, the weight renamed
    (transposed when ``trans_b`` is 0) and the bias under its own name."""
    inits, nodes, skip = [], [], set()
    names = [f"linear.{i}" for i in range(cfg.linear_layers)] + ["classifier"]
    for i, name in enumerate(names):
        w = np.asarray(sd[f"{name}.weight"])
        wname = f"onnx::Gemm_{100 + i}"
        inits.append(_pb_tensor(wname, w if trans_b else np.ascontiguousarray(w.T)))
        nodes.append(
            _pb_node(
                "Gemm",
                [f"/x_{i}", wname, f"{name}.bias"],
                [f"/x_{i + 1}"],
                int_attrs={"transB": 1} if trans_b else None,
            )
        )
        skip.add(f"{name}.weight")
    inits += [_pb_tensor(k, np.asarray(v)) for k, v in sd.items() if k not in skip]
    with open(path, "wb") as f:
        f.write(_pb_model(inits, nodes))


def _ecapa_onnx(path, sd, rng):
    inits = [
        _pb_tensor(f"embedding_model.{k}", np.asarray(v))
        for k, v in sd.items()
        if not k.endswith("num_batches_tracked")
    ]
    # emd4.onnx also carries the constant-folded mel filterbank matrix
    inits.append(_pb_tensor("onnx::MatMul_7", rng.normal(size=(201, 80)).astype(np.float32)))
    with open(path, "wb") as f:
        f.write(_pb_model(inits, []))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Every artifact kind at the published widths, written once: name ->
    path (each loaded by ``load_params_auto``)."""
    root = tmp_path_factory.mktemp("artifacts")
    rng = np.random.default_rng(11)
    cfg = jpyannet.PyanNetConfig()
    seg = make_pyannote_pyannet_state_dict(rng, cfg)
    emb = make_speechbrain_ecapa_state_dict(rng)
    paths = {}

    def path(name, *parts):
        d = root / name
        d.mkdir()
        paths[name] = str(d.joinpath(*parts)) if parts else str(d)
        return paths[name]

    lightning = {"hyper_parameters": WeirdHyperparams(), "pytorch-lightning_version": "1.9.0"}
    torch.save(dict(lightning, state_dict=_torch_sd(seg)), path("lightning", "pytorch_model.bin"))
    torch.save(
        {"state_dict": {f"model.{k}": v for k, v in _torch_sd(seg).items()}},
        path("model_prefixed", "wrapped.ckpt"),
    )
    torch.save(_torch_sd(emb), os.path.join(path("savedir"), "embedding_model.ckpt"))
    torch.save({"state_dict": _torch_sd(seg, torch.bfloat16)}, path("bf16", "bf16.ckpt"))
    torch.save({"state_dict": _torch_sd(seg, view=True)}, path("view", "view.ckpt"))
    _write_segment_onnx(path("onnx_parametric", "segment2.onnx"), seg, cfg, folded=False)
    _write_segment_onnx(path("onnx_folded", "segment2.onnx"), seg, cfg, folded=True)
    _ecapa_onnx(path("onnx_ecapa", "emd4.onnx"), emb, rng)
    _gemm_onnx(path("onnx_gemm", "gemm.onnx"), seg, cfg, trans_b=True)
    _gemm_onnx(path("onnx_gemm_transb0", "gemm.onnx"), seg, cfg, trans_b=False)
    mixed = path("mixed")
    torch.save({"state_dict": _torch_sd(seg)}, os.path.join(mixed, "pytorch_model.bin"))
    torch.save(_torch_sd(emb), os.path.join(mixed, "embedding_model.ckpt"))
    tconvert.save_checkpoint(
        path("npz"),
        {
            "segmentation": tconvert.pyannet_from_pyannote(seg),
            "embedding": tconvert.ecapa_from_speechbrain(emb),
        },
    )
    return dict(paths=paths, seg=seg, emb=emb)


def assert_trees_equal(got, want):
    """Same keys and exactly equal arrays (the port's numpy against the JAX
    package's arrays)."""
    got, want = tconvert.flatten_pytree(got), tconvert.flatten_pytree(want)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)


KINDS = {
    "lightning": {"segmentation"},
    "model_prefixed": {"segmentation"},
    "savedir": {"embedding"},
    "bf16": {"segmentation"},
    "view": {"segmentation"},
    "onnx_parametric": {"segmentation"},
    "onnx_folded": {"segmentation"},
    "onnx_ecapa": {"embedding"},
    "onnx_gemm": {"segmentation"},
    "onnx_gemm_transb0": {"segmentation"},
    "mixed": {"segmentation", "embedding"},
    "npz": {"segmentation", "embedding"},
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_load_params_auto_equals_the_jax_package(artifacts, kind):
    path = artifacts["paths"][kind]
    got, want = tingest.load_params_auto(path), jingest.load_params_auto(path)
    assert set(got) == set(want) == KINDS[kind]
    assert_trees_equal(got, want)
    if kind == "onnx_folded":
        assert set(got["segmentation"]["sincnet"]["sinc"]) == {"filters"}
        assert isinstance(got["segmentation"]["sincnet"]["sinc"]["filters"], np.ndarray)


def test_artifact_loaders_equal_the_jax_package(artifacts):
    """The per-format loaders (savedir and its ``.ckpt``, Lightning, each
    ONNX reader) give what the JAX package's give."""
    paths = artifacts["paths"]
    for fn, path in (
        ("load_speechbrain_checkpoint", paths["savedir"]),
        ("load_speechbrain_checkpoint", os.path.join(paths["savedir"], "embedding_model.ckpt")),
        ("load_pyannote_checkpoint", paths["lightning"]),
        ("load_pyannote_checkpoint", paths["model_prefixed"]),
        ("pyannet_from_onnx", paths["onnx_folded"]),
        ("ecapa_from_onnx", paths["onnx_ecapa"]),
    ):
        assert_trees_equal(getattr(tingest, fn)(path), getattr(jingest, fn)(path))


def test_read_torch_checkpoint_matches_torch_load(tmp_path):
    rng = np.random.default_rng(0)
    payload = {
        "f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "f64": torch.from_numpy(rng.normal(size=(7,))),
        "i64": torch.from_numpy(rng.integers(0, 100, size=(4, 2))),
        "bool": torch.tensor([True, False, True]),
        "f16": torch.from_numpy(rng.normal(size=(5,)).astype(np.float16)),
        "bf16": torch.arange(16, dtype=torch.float32).reshape(4, 4).div(7).bfloat16(),
    }
    path = str(tmp_path / "mix.ckpt")
    torch.save(payload, path)
    got = tingest.read_torch_checkpoint(path)
    ref = torch.load(path, map_location="cpu", weights_only=True)
    jax_got = jingest.read_torch_checkpoint(path)
    for k, v in ref.items():
        want = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        np.testing.assert_array_equal(got[k], want)
        assert got[k].dtype == want.dtype == jax_got[k].dtype, k


PWNED = []


class _EvilReduce:
    """Pickles to a REDUCE of builtins.eval, the shape a crafted checkpoint
    would use to run code on load."""

    def __reduce__(self):
        return (eval, ("__import__('test_torch_ingest').PWNED.append('rce')",))


def test_malicious_checkpoint_loads_inertly(tmp_path):
    sd = {"layer.weight": torch.randn(2, 2)}
    path = str(tmp_path / "evil.ckpt")
    torch.save({"state_dict": sd, "payload": _EvilReduce(), "tags": {"a"}}, path)
    PWNED.clear()
    loaded = tingest.read_torch_checkpoint(path)
    assert PWNED == []  # eval never ran
    assert isinstance(loaded["payload"], tingest._Stub)
    assert loaded["tags"] == {"a"}  # the data-container builtins still resolve
    np.testing.assert_array_equal(loaded["state_dict"]["layer.weight"], sd["layer.weight"].numpy())


def test_converters_round_trip_and_equal_the_jax_package(artifacts):
    seg, emb = artifacts["seg"], artifacts["emb"]
    seg_tree = tconvert.pyannet_from_pyannote(seg)
    emb_tree = tconvert.ecapa_from_speechbrain(emb)
    assert_trees_equal(seg_tree, jconvert.pyannet_from_pyannote(seg))
    assert_trees_equal(emb_tree, jconvert.ecapa_from_speechbrain(emb))
    for got, want in (
        (tconvert.pyannet_to_pyannote(seg_tree), seg),
        (tconvert.ecapa_to_speechbrain(emb_tree), emb),
    ):
        want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tconvert.pyannet_to_pyannote(seg_tree).keys() == jconvert.pyannet_to_pyannote(
        jconvert.pyannet_from_pyannote(seg)
    ).keys()
    baked = dict(seg_tree, sincnet=dict(seg_tree["sincnet"], sinc={"filters": np.zeros((80, 1, 251))}))
    with pytest.raises(ValueError, match="baked"):
        tconvert.pyannet_to_pyannote(baked)


# ---------------------------------------------------------------------------
# a baked filterbank through both packages (small5s, float32)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def baked_small5s():
    from test_torch_pipeline_small5s import SMALL5S_CFG

    params = jax.tree.map(np.asarray, jconvert.load_checkpoint(GATE_CKPT))
    sinc = params["segmentation"]["sincnet"]["sinc"]
    filters = np.asarray(jpyannet.sinc_filters(sinc, SMALL_PYANNET))
    params["segmentation"]["sincnet"]["sinc"] = {"filters": filters}
    jp, tp = build_pair(SMALL5S_CFG, batch=4, params=params)
    audio = synth_audio(12.3)
    return jp, tp, audio, params, SMALL5S_CFG.segmentation.onset


def test_baked_filterbank_matches_the_jax_package(baked_small5s):
    jp, tp, audio, params, onset = baked_small5s
    sinc = tp.segmentation_model.sincnet.sinc
    assert sinc.baked and not list(sinc.parameters())
    np.testing.assert_array_equal(
        sinc().numpy(), params["segmentation"]["sincnet"]["sinc"]["filters"]
    )
    check_stage1(run_stages(jp, tp, audio), onset)
    check_end_to_end(jp, tp, audio, onset)


def test_baked_filterbank_round_trips_through_a_checkpoint(baked_small5s, tmp_path):
    _, tp, _, params, _ = baked_small5s
    saved = tconvert.params_to_jax(tp.segmentation_model, tp.embedding_model)
    assert set(saved["segmentation"]["sincnet"]["sinc"]) == {"filters"}
    tconvert.save_checkpoint(str(tmp_path), saved)
    loaded = tconvert.load_checkpoint(str(tmp_path))
    assert_trees_equal(loaded["segmentation"], params["segmentation"])
    # the JAX package reads the same file with the same key
    assert_trees_equal(loaded["segmentation"], jconvert.load_checkpoint(str(tmp_path))["segmentation"])
    model = tconvert.build_pyannet(loaded["segmentation"], tp.pyannet_cfg)
    assert model.sincnet.sinc.baked
    for name, value in tp.segmentation_model.state_dict().items():
        assert torch.equal(model.state_dict()[name], value), name
