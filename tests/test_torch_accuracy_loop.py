"""The closed accuracy loop in the port (tests/_torch_accuracy.py), on the
CPU: train PyanNet and ECAPA-TDNN with the port's train steps, diarize a
composed two-speaker conversation with the port's pipeline, and meet every
threshold of the JAX package's tests/test_accuracy_loop.py (PyanNet loss
< 0.12, embeddings separated by more than 0.05, DER < 0.25, exactly 2
speakers). Slow, as the JAX test is: about a minute. chip_smoke.py runs
the same loop on the card.

Torch runs on two threads here, as in every port test module: the CPU's
float32 sums, and with them the training trajectory, depend on the thread
count."""

import dataclasses

import pytest

import _cfg
import _torch_cfg
from _torch_accuracy import failures, run_accuracy_loop
from _torch_threads import two_torch_threads  # noqa: F401


def test_port_configs_equal_the_shared_ones():
    for name in ("SMALL_PYANNET", "SMALL_ECAPA", "TINY1S_CFG"):
        assert dataclasses.asdict(getattr(_torch_cfg, name)) == dataclasses.asdict(
            getattr(_cfg, name)
        ), name


@pytest.mark.slow
def test_train_then_diarize_recovers_ground_truth():
    report = run_accuracy_loop("cpu")
    assert not failures(report), report
