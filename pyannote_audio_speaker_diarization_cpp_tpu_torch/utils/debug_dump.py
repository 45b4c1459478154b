"""Differential tensor-dump verification system.

Re-design of the reference's main test strategy (SURVEY.md section 4.3): the
C++ dumps ~40 intermediates to /tmp/cpp_<name>.txt under #ifdef WRITE_DATA
(reference pipeline/src/speakerDiarizer.cpp:41, 87-234) and
pipeline/script/verifyEveryStepResult.py compares them against Python dumps
with exact equality for discrete tensors and allclose for floats.

Here: ``DumpSession`` records named pipeline intermediates (text format
compatible with the reference's dumps — comma-separated rows, ``nan`` for
NaN, True/False for booleans) and ``compare_dumps`` applies the reference's
tolerance policy (rtol 1e-3 / atol 1e-4 for floats, exact for discrete;
verifyEveryStepResult.py:119-124, 162-171).

A copy of the JAX package's utils/debug_dump.py, owned by the port; the
text format is the same byte for byte, so dumps of the two packages diff
directly. Text dumps default to the system temporary directory.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

# tensors compared exactly in the reference harness
# (pipeline/script/verifyEveryStepResult.py:162-163)
EXACT_NAMES = {
    "same_as",
    "well_defined_idx",
    "samples",
    "on",
    "initial_state",
    "masks",
    "imasks",
    "wav_lens",
    "signals",
    "count",
    "clusters",
    "hard_clusters",
    "binarized_segmentations",
    "binary_ndarray",
}

RTOL = 1e-3
ATOL = 1e-4


def format_tensor(arr: np.ndarray) -> str:
    """Reference-compatible text: one row per line, comma-separated, ``nan``
    for NaN, True/False for booleans, trailing comma per row (matching
    debugWrite2d, speakerDiarizer.cpp:87-234)."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim == 3:
        arr = arr.reshape(-1, arr.shape[-1])
    lines = []
    for row in arr:
        parts = []
        for v in row:
            if isinstance(v, (bool, np.bool_)):
                parts.append("True" if v else "False")
            elif isinstance(v, (float, np.floating)) and np.isnan(v):
                parts.append("nan")
            else:
                parts.append(repr(float(v)) if isinstance(v, (float, np.floating)) else str(v))
        lines.append(",".join(parts) + ",")
    return "\n".join(lines) + "\n"


def parse_tensor(text: str) -> np.ndarray:
    rows = []
    for line in text.splitlines():
        vals = []
        for tok in line.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok == "True":
                vals.append(1.0)
            elif tok == "False":
                vals.append(0.0)
            elif tok == "nan":
                vals.append(np.nan)
            else:
                vals.append(float(tok))
        if vals:
            rows.append(vals)
    return np.asarray(rows)


class DumpSession:
    """Collects named intermediates and writes <prefix>_<name>.txt files.

    ``write_text=False`` keeps tensors in memory only (for golden-fixture
    comparison via save_npz/compare_tensors without writing files)."""

    def __init__(
        self,
        directory: Optional[str] = None,
        prefix: str = "torch",
        enabled: bool = True,
        write_text: bool = True,
    ):
        self.directory = directory if directory is not None else tempfile.gettempdir()
        self.prefix = prefix
        self.enabled = enabled
        self.write_text = write_text
        self.tensors: Dict[str, np.ndarray] = {}

    def dump(self, name: str, value) -> None:
        if not self.enabled:
            return
        arr = np.asarray(value)
        self.tensors[name] = arr
        if not self.write_text:
            return
        path = os.path.join(self.directory, f"{self.prefix}_{name}.txt")
        with open(path, "w") as f:
            f.write(format_tensor(arr))

    def save_npz(self, path: str) -> None:
        """Persist the session as a compressed golden fixture."""
        np.savez_compressed(path, **self.tensors)


@dataclasses.dataclass
class CompareResult:
    name: str
    status: str  # "match", "mismatch", "missing"
    detail: str = ""


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Load a golden fixture written by DumpSession.save_npz."""
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def compare_tensors(
    ours: Dict[str, np.ndarray],
    golden: Dict[str, np.ndarray],
) -> List[CompareResult]:
    """Compare two tensor dicts with the reference tolerance policy
    (verifyEveryStepResult.py:119-124, 162-171): exact equality for the
    discrete EXACT_NAMES, allclose(rtol 1e-3, atol 1e-4) for floats.
    Every golden name must be present in ``ours``."""
    results = []
    for name in sorted(golden):
        if name not in ours:
            results.append(CompareResult(name, "missing"))
            continue
        a = np.asarray(ours[name], dtype=np.float64)
        b = np.asarray(golden[name], dtype=np.float64)
        if a.shape != b.shape:
            results.append(
                CompareResult(name, "mismatch", f"shape {a.shape} vs {b.shape}")
            )
            continue
        try:
            if name in EXACT_NAMES:
                mask = ~(np.isnan(a) & np.isnan(b))
                if not np.array_equal(a[mask], b[mask]):
                    bad = int(np.sum(a[mask] != b[mask]))
                    raise AssertionError(f"{bad} elements differ (exact)")
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
            results.append(CompareResult(name, "match"))
        except AssertionError as e:
            results.append(CompareResult(name, "mismatch", str(e).splitlines()[0]))
    return results


def compare_dumps(
    directory: Optional[str] = None,
    ours: str = "torch",
    theirs: str = "py",
    names: Optional[List[str]] = None,
) -> List[CompareResult]:
    """Compare <ours>_<name>.txt against <theirs>_<name>.txt with the
    reference tolerance policy. With names=None, compares every name that
    exists for ``ours``."""
    directory = directory if directory is not None else tempfile.gettempdir()
    results = []
    if names is None:
        names = sorted(
            f[len(ours) + 1 : -4]
            for f in os.listdir(directory)
            if f.startswith(f"{ours}_") and f.endswith(".txt")
        )
    for name in names:
        a_path = os.path.join(directory, f"{ours}_{name}.txt")
        b_path = os.path.join(directory, f"{theirs}_{name}.txt")
        if not (os.path.exists(a_path) and os.path.exists(b_path)):
            results.append(CompareResult(name, "missing"))
            continue
        a = parse_tensor(open(a_path).read())
        b = parse_tensor(open(b_path).read())
        if a.shape != b.shape:
            results.append(
                CompareResult(name, "mismatch", f"shape {a.shape} vs {b.shape}")
            )
            continue
        try:
            if name in EXACT_NAMES:
                mask = ~(np.isnan(a) & np.isnan(b))
                if not np.array_equal(a[mask], b[mask]):
                    bad = int(np.sum(a[mask] != b[mask]))
                    raise AssertionError(f"{bad} elements differ (exact)")
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
            results.append(CompareResult(name, "match"))
        except AssertionError as e:
            results.append(CompareResult(name, "mismatch", str(e).splitlines()[0]))
    return results
