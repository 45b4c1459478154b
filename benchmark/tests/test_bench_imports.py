"""What the harness loads: never JAX nor the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the plain reference nothing of the program at all."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROGRAM = "pyannote_audio_speaker_diarization_cpp_tpu_torch"
FORBIDDEN = ["jax", "jaxlib", "flax", "pyannote_audio_speaker_diarization_cpp_tpu"]


def loaded_after(code: str):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_bench_reference_loads_nothing_of_the_program():
    got = loaded_after(
        "import benchmark.reference.models, benchmark.reference.stages, "
        "benchmark.reference.clustering, benchmark.reference.decode, benchmark.check, "
        "benchmark.weights, benchmark.traffic, benchmark.roofline, benchmark.readings")
    assert not got & set(FORBIDDEN + [PROGRAM]), got & set(FORBIDDEN + [PROGRAM])


def test_bench_a_run_loads_no_jax():
    """A whole run on the CPU at the test widths, in a fresh interpreter."""
    code = f"""
import json, sys
sys.argv = ["x"]
from benchmark import run
from benchmark.tests import tiny
rc = run.main(tiny.argv(5), device="cpu", cell_override=tiny.cell())
assert rc == 0, rc
"""
    got = loaded_after(code)
    assert PROGRAM in got
    assert not got & set(FORBIDDEN), got & set(FORBIDDEN)


def test_bench_run_refuses_without_a_card():
    """Here there is no CUDA device: the run exits with another code than 0
    and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "v2.1-meetings", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and out.stdout.strip() == ""
