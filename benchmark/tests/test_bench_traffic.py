"""The traffic generator: every seed gives the same lengths and work, and
the same seed the same recordings."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from benchmark import traffic as T

ROOT = Path(__file__).resolve().parents[2]
MIXES = sorted(p.stem for p in (ROOT / "benchmark" / "traffic").glob("*.json"))
SEEDS = [0, 1, 2**31 + 5, 2**40 + 3, -7, 8100000001]


def load(name):
    return json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_bench_each_cycle_sends_the_whole_list(mix):
    t = load(mix)
    n, g = len(t["lengths_s"]), t["group"]
    per_cycle = -(-n // g)
    for seed in SEEDS:
        groups = T.schedule(t, seed, 3)
        assert len(groups) == 3 * per_cycle
        for c in range(3):
            cycle = [i for grp in groups[c * per_cycle : (c + 1) * per_cycle] for i in grp]
            assert sorted(cycle) == list(range(n))
            assert all(len(grp) <= g for grp in groups[c * per_cycle : (c + 1) * per_cycle])


@pytest.mark.parametrize("mix", MIXES)
def test_bench_work_does_not_depend_on_the_seed(mix):
    t = load(mix)
    lengths = [Counter(t["lengths_s"][i] for grp in T.schedule(t, s, 4) for i in grp)
               for s in SEEDS]
    assert all(c == lengths[0] for c in lengths)
    assert max(t["lengths_s"]) + t.get("tail_s", 0.0) <= 1020.0


@pytest.mark.parametrize("mix", MIXES)
def test_bench_checked_sample_holds_the_longest(mix):
    t = load(mix)
    longest = int(np.argmax(t["lengths_s"]))
    for seed in SEEDS:
        got = T.checked(t, seed)
        assert longest in got and len(got) == min(t["checked_per_run"], len(t["lengths_s"]))


def test_bench_same_seed_same_recording():
    t = dict(load("meetings"), lengths_s=[6, 9])
    a = T.recordings(t, 2**31 + 5, "cpu")
    b = T.recordings(t, 2**31 + 5, "cpu")
    c = T.recordings(t, 2**31 + 6, "cpu")
    assert [len(x) for x in a] == [int(round((s + t["tail_s"]) * 16000)) for s in t["lengths_s"]]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and len(a[0]) == len(c[0])
    # 16-bit steps, as a WAV file holds them
    q = a[1] * 32768
    assert np.array_equal(q, np.round(q)) and np.abs(a[1]).max() < 1.0
