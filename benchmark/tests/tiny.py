"""A cell small enough for the CPU tests: the recipe at test widths (the
configuration under ``tests/data``), two short recordings, the limits of
``v2.1-meetings``."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"


def cell(bounds=None, limits="v2.1-meetings"):
    cfg = json.loads((DATA / "tiny-config.json").read_text())
    traffic = json.loads((DATA / "tiny-traffic.json").read_text())
    if bounds is not None:
        traffic["bounds"] = bounds
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = [dict(m, workloads=["tiny"]) for m in manifest["per_layer"]]
    lim = json.loads((ROOT / "benchmark" / "limits" / f"{limits}.json").read_text())
    return ({"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1}, cfg, traffic,
            lim, per_layer)


def argv(seed, trace=0):
    return ["--workload", "tiny", "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)]
