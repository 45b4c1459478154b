"""The control of each cell on the card: the plain reference one precision
below the configuration's (check.control_answer), put in the program's
place on a 60 s recording at the published widths, must fail the cell's
limits. The same control read at the cells' own sizes, on three seeds,
is ``python3 -m benchmark.calibrate --control-seeds``. Needs an NVIDIA
card: python3 -m pytest benchmark/tests -m cuda"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import check, traffic as T, weights as W

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_bench_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is read at the published widths")
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    conf = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    device = torch.device("cuda", 0)
    weights = W.make(cfg, device)
    audio = T.recording(traffic, 60.27, 11, 0, device)
    ans = check.control_answer(audio, weights, cfg, traffic, device)
    got = check.judge(check.numbers_for(ans, audio, weights, cfg, traffic, device), limits)
    assert not all(c["ok"] for c in got.values()), got
