"""A whole run at the test widths on the CPU (the look for a card skipped),
sound and with its timed path broken underneath: ``correct`` must hold for
the sound run and fail for each fault this kind of cell can have (an answer
altered where it is produced; half of each batch left out, the mean of the
rest given to it). The other faults of the contract do not apply: the
pipeline keeps no state from step to step, and a cell runs on one chip."""

from __future__ import annotations

import json

import pytest

from benchmark import calibrate, run
from benchmark.tests import tiny


def result(capsys, patch=None, bounds=None, seed=5):
    rc = run.main(tiny.argv(seed), device="cpu", patch=patch, cell_override=tiny.cell(bounds))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("bounds", [None, {"num_speakers": 2}], ids=["device_route", "host_route"])
def test_bench_sound_run_is_correct(capsys, bounds):
    got = result(capsys, bounds=bounds)
    assert got["correct"] is True and got["failed"] == 0, got["checks"]
    assert list(got)[-1] == "checks"
    assert got["metrics"]["audio_s_per_s"]["value"] > 0


@pytest.mark.parametrize("fault,caught_by", [
    ("turns_moved", "turns_diff_s"),
    ("stage1_altered", "bin_flip_share"),
    ("half_batch", "emb_max_rel"),
    ("labels_moved", "partition_rows_off"),
])
def test_bench_fault_makes_the_run_incorrect(capsys, fault, caught_by):
    undo = []

    def patch(pipe):
        undo.extend(calibrate.plant_faults(pipe, (fault,)))

    try:
        got = result(capsys, patch=patch)
    finally:
        for u in undo:
            u()
    assert got["correct"] is False
    c = got["checks"][caught_by]
    assert c["value"] > c["limit"], got["checks"]
