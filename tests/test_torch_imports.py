"""The port must run where JAX is not installed: no module of the port, and
not chip_smoke.py, imports jax or the JAX package — checked by an AST scan
and by importing (and running) the port in a process where those imports
fail."""

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
    env = dict(os.environ, PYTHONPATH=REPO)
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
    "metrics.der",
    "pipelines.embedding",
    "pipelines.segmentation",
    "utils.debug_dump",
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
from {PORT}.models.ecapa import EcapaConfig
from {PORT}.models.pyannet import PyanNetConfig, pyannet_num_frames
from {PORT}.pipelines.diarization import SpeakerDiarizationPipeline
from {PORT}.pipelines.embedding import EmbeddingPipeline
from {PORT}.pipelines.segmentation import SegmentationPipeline
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
assert der(a, a) == 0.0
seg = SegmentationPipeline(cfg, pyannet_cfg=small["pyannet_cfg"], device="cpu")(wave)
emb = EmbeddingPipeline(cfg, ecapa_cfg=small["ecapa_cfg"], device="cpu")(wave[None, :16000])
timer = StageTimer()
with timer.time("x"):
    pass
path = os.path.join(tempfile.mkdtemp(), "a.wav")
write_wav(path, wave * 20000.0, 16000)
cli.SpeakerDiarizationPipeline = lambda **kw: SpeakerDiarizationPipeline(cfg, **dict(small, device=kw["device"]))
out = io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    assert cli.main([path, "--device", "cpu"]) == 0
assert not any(m in sys.modules and sys.modules[m] is not None for m in {FORBIDDEN!r})
print("ok", len(seg.turns()), emb.shape, out.getvalue().count("Speaker_"))
"""


def test_entry_points_import_and_run_without_jax():
    scanned = {os.path.relpath(path, os.path.join(REPO, PORT)) for path in _sources()}
    for name in ENTRY_POINT_MODULES:
        assert name.replace(".", os.sep) + ".py" in scanned, name
    env = dict(os.environ, PYTHONPATH=REPO)
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
