"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and limits, and that every file it points to is there."""

from __future__ import annotations

import importlib.util
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_bench_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_bench_paths_and_command():
    paths = MANIFEST["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_text_ok(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_bench_names_are_plain_and_unique(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)


def test_bench_configs():
    keys = {"name", "source", "file", "reduced", "why"}
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == keys
        assert c["name"] in used
        assert c["source"].startswith("https://") and _text_ok(c["source"]) and _text_ok(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_bench_workloads():
    keys = {"name", "config", "traffic", "chips", "why"}
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == keys
        assert w["config"] in configs and w["chips"] in (1, 4) and _text_ok(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((ROOT / "benchmark" / "limits" / f"{w['name']}.json").read_text())
        for name, spec in limits["numbers"].items():
            assert spec["limit"] >= spec["lower"], name
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(
        1, len(MANIFEST["workloads"]) // 4)


def test_bench_end_to_end():
    keys = {"name", "unit", "better", "bound", "source"}
    assert "setup_s" in E2E and 1 <= len(E2E) <= 16
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25


def test_bench_per_layer():
    keys = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text_ok(m["layer"]) and m["moves"] in E2E
        assert set(m["workloads"]) <= cells and m["workloads"]
        # every listed cell reports the end-to-end metric this one moves
        for w in m["workloads"]:
            assert w in E2E[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_bench_every_metric_has_a_reader(metric):
    path = ROOT / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_bench_layers_share_their_names():
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


def test_bench_run_budget_fits():
    """2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to
    compile and 1200 s spare, with the full 24 cells."""
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert math.isfinite(rs)
