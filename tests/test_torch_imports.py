"""The port must run where JAX is not installed: no module of the port, and
not chip_smoke.py or the test modules it imports (the accuracy loop),
imports jax or the JAX package — checked by an AST scan and by importing
(and running) the port in a process where those imports fail."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "pyannote_audio_speaker_diarization_cpp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pyannote_audio_speaker_diarization_cpp_tpu")


def _sources():
    for root, _, files in os.walk(os.path.join(REPO, PORT)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")
    # the accuracy loop chip_smoke.py runs on the card, and its configs
    for name in ("_torch_accuracy.py", "_torch_cfg.py"):
        yield os.path.join(REPO, "tests", name)


def test_no_jax_imports_in_port_sources():
    offenders = []
    for path in _sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not offenders, offenders


_BLOCKED_RUN = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import importlib, pkgutil
import {PORT} as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
sys.path.insert(0, "tests")
import _torch_accuracy
import numpy as np
from {PORT}.config import DiarizationConfig, SegmentationConfig
from {PORT}.models.ecapa import EcapaConfig
from {PORT}.models.pyannet import PyanNetConfig, pyannet_num_frames
from {PORT}.pipelines.diarization import SpeakerDiarizationPipeline
cfg = DiarizationConfig(
    segmentation=SegmentationConfig(
        duration=1.0, step=0.5, batch_size=4, num_frames=pyannet_num_frames(16000)
    ),
    chunk_bucket=4,
)
pipe = SpeakerDiarizationPipeline(
    cfg,
    pyannet_cfg=PyanNetConfig(num_filters=16, conv_channels=8, lstm_hidden=8, lstm_layers=1, linear_hidden=8),
    ecapa_cfg=EcapaConfig(channels=(32, 32, 32, 32, 64), attention_channels=8, se_channels=8, emb_dim=16),
    device="cpu",
)
from {PORT}.clustering.device import device_cluster
from {PORT}.ops.linkage_cuda import linkage_labels
t = np.arange(40000) / 16000
wave = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
assert pipe._dispatch(wave)["device_clu"] is not None  # stage 3 on the device route
ann = pipe(wave)
assert not any(m in sys.modules and sys.modules[m] is not None for m in {FORBIDDEN!r})
print("ok", len(ann.turns()))
"""


def test_port_imports_and_runs_without_jax():
    # two torch threads in the child (tests/_torch_threads.py): the suite
    # runs several xdist workers on a few cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.startswith("ok")


# the modules of the entry points beyond __call__: each must be among those
# the scan above reads and import where JAX cannot
ENTRY_POINT_MODULES = (
    "cli",
    "clustering.spectral",
    "metrics.der",
    "models.ingest",
    "models.trainer",
    "models.training",
    "parallel.dryrun",
    "parallel.longform",
    "parallel.mesh",
    "parallel.sharding",
    "pipelines.embedding",
    "pipelines.segmentation",
    "pipelines.streaming",
    "runtime.native_bindings",
    "runtime.server",
    "utils.checkpoint",
    "utils.debug_dump",
    "utils.flops",
    "utils.instrumented",
    "utils.timing",
)

_BLOCKED_ENTRY_POINTS = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import contextlib, importlib, io, os, tempfile
import numpy as np
for name in {ENTRY_POINT_MODULES!r}:
    importlib.import_module("{PORT}." + name)
from {PORT} import cli
from {PORT}.config import DiarizationConfig, SegmentationConfig
from {PORT}.io.wav import write_wav
from {PORT}.metrics.der import der
from {PORT}.models.convert import params_to_jax, save_checkpoint
from {PORT}.models.ingest import load_params_auto
from {PORT}.utils.flops import ecapa_flops, pyannet_flops
from {PORT}.models.ecapa import EcapaConfig
from {PORT}.models.pyannet import PyanNetConfig, pyannet_num_frames
from {PORT}.pipelines.diarization import SpeakerDiarizationPipeline
from {PORT}.pipelines.embedding import EmbeddingPipeline
from {PORT}.pipelines.segmentation import SegmentationPipeline
from {PORT}.pipelines.streaming import StreamingDiarizer
from {PORT}.runtime import native_bindings
from {PORT}.clustering import ahc
from {PORT}.utils.debug_dump import DumpSession
from {PORT}.utils.instrumented import run_with_dumps
from {PORT}.utils.timing import StageTimer
cfg = DiarizationConfig(
    segmentation=SegmentationConfig(
        duration=1.0, step=0.5, batch_size=4, num_frames=pyannet_num_frames(16000)
    ),
    chunk_bucket=4,
)
small = dict(
    pyannet_cfg=PyanNetConfig(num_filters=16, conv_channels=8, lstm_hidden=8, lstm_layers=1, linear_hidden=8),
    ecapa_cfg=EcapaConfig(channels=(32, 32, 32, 32, 64), attention_channels=8, se_channels=8, emb_dim=16),
    device="cpu",
)
pipe = SpeakerDiarizationPipeline(cfg, **small)
t = np.arange(40000) / 16000
wave = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
assert pipe.warmup(2.0) == [32]
a, b = pipe.map([wave, wave[:30000]])
assert str(a) == str(pipe(wave))
assert str(run_with_dumps(pipe, wave, DumpSession(write_text=False))) == str(a)
from {PORT}.parallel.longform import LongFormDiarizer
assert str(LongFormDiarizer(pipe, num_shards=2)(wave)) == str(a)
assert der(a, a) == 0.0
stream = StreamingDiarizer(pipe, emit_every=2)
for block in np.array_split(wave, 4):
    stream.feed(block)
assert str(stream.flush()) == str(SpeakerDiarizationPipeline(cfg, device_clustering=False, **small)(wave))
spectral = SpeakerDiarizationPipeline(cfg, clusterer="spectral", **small)
assert spectral._device_clu_key() is None and spectral(wave) is not None
calls = native_bindings.linkage_calls
ahc.linkage(np.random.default_rng(0).normal(size=(300, 8)))
assert native_bindings.linkage_calls == calls + 1
seg = SegmentationPipeline(cfg, pyannet_cfg=small["pyannet_cfg"], device="cpu")(wave)
emb = EmbeddingPipeline(cfg, ecapa_cfg=small["ecapa_cfg"], device="cpu")(wave[None, :16000])
ckpt = tempfile.mkdtemp()
save_checkpoint(ckpt, params_to_jax(pipe.segmentation_model, pipe.embedding_model))
assert set(load_params_auto(ckpt)) == {{"segmentation", "embedding"}}
assert pyannet_flops(16000, small["pyannet_cfg"]) > 0 and ecapa_flops(101, small["ecapa_cfg"]) > 0
timer = StageTimer()
with timer.time("x"):
    pass
path = os.path.join(tempfile.mkdtemp(), "a.wav")
write_wav(path, wave * 20000.0, 16000)
cli.SpeakerDiarizationPipeline = lambda **kw: SpeakerDiarizationPipeline(cfg, **dict(small, device=kw["device"]))
out = io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    assert cli.main([path, "--device", "cpu"]) == 0
from {PORT}.models.convert import pyannet_tree
from {PORT}.models.pyannet import PyanNet
from {PORT}.models.trainer import segmentation_trainer
from {PORT}.runtime import server as srv
import json, threading, urllib.request
tr = segmentation_trainer(pyannet_tree(PyanNet(small["pyannet_cfg"])), small["pyannet_cfg"], device="cpu")
frames = pyannet_num_frames(4000, small["pyannet_cfg"])
assert np.isfinite(tr.step(np.stack([wave[:4000]] * 2), np.ones((2, frames, 3), np.float32)))
ckpt_dir = tempfile.mkdtemp()
tr.save_checkpoint(ckpt_dir)
assert tr.restore_checkpoint(ckpt_dir) == 1
server = srv.serve(srv.DiarizationService(pipe), port=0)
threading.Thread(target=server.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{{server.server_address[1]}}"
body = json.load(urllib.request.urlopen(urllib.request.Request(url + "/diarize", data=open(path, "rb").read())))
server.shutdown()
assert body["audio_seconds"] == 2.5
assert not any(m in sys.modules and sys.modules[m] is not None for m in {FORBIDDEN!r})
print("ok", len(seg.turns()), emb.shape, out.getvalue().count("Speaker_"))
"""


def test_entry_points_import_and_run_without_jax():
    scanned = {os.path.relpath(path, os.path.join(REPO, PORT)) for path in _sources()}
    for name in ENTRY_POINT_MODULES:
        assert name.replace(".", os.sep) + ".py" in scanned, name
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_ENTRY_POINTS],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.startswith("ok")


def test_runtime_is_scanned_and_holds_no_built_library():
    runtime = os.path.join(REPO, PORT, "runtime")
    scanned = {os.path.relpath(path, runtime) for path in _sources()}
    assert {"__init__.py", "native_bindings.py"} <= scanned
    # the library builds into the package's _build/, never beside its source
    assert sorted(os.listdir(os.path.join(runtime, "native"))) == ["sdtpu_native.cc"]
    tracked = subprocess.run(
        ["git", "ls-files", os.path.join(PORT, "runtime")],
        cwd=REPO,
        capture_output=True,
        text=True,
    ).stdout.split()
    assert not [path for path in tracked if path.endswith((".so", ".o", ".a"))], tracked
