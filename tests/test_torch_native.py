"""The port's native host library (runtime/native_bindings.py, its own copy
of sdtpu_native.cc built with g++) against the numpy and scipy linkages,
the JAX package's native library and the port's WAV reader; and the
backend choice of clustering/ahc.py ``linkage``."""

import os

import numpy as np
import pytest

from pyannote_audio_speaker_diarization_cpp_tpu.runtime import native_bindings as jnb
from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import ahc
from pyannote_audio_speaker_diarization_cpp_tpu_torch.io import wav as wavio
from pyannote_audio_speaker_diarization_cpp_tpu_torch.runtime import native_bindings as nb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unit_rows(seed, n, d):
    X = np.random.default_rng(seed).normal(size=(n, d))
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def _same_merges(Za, Zb):
    np.testing.assert_array_equal(Za[:, :2], Zb[:, :2])
    np.testing.assert_array_equal(Za[:, 3], Zb[:, 3])


def test_library_builds_here():
    assert nb.available()
    assert nb.library_path().parent.name == "_build"


@pytest.mark.parametrize(
    "oracle, X",
    [
        ("numpy", _unit_rows(0, 200, 32)),
        ("scipy", np.random.default_rng(1).normal(size=(150, 16))),
    ],
)
def test_native_linkage_matches_oracle(oracle, X):
    Zn = nb.linkage_centroid(X)
    if oracle == "numpy":
        Zo = ahc.linkage(X, use_native=False)
    else:
        from scipy.cluster.hierarchy import linkage

        Zo = linkage(X, method="centroid", metric="euclidean")
    _same_merges(Zn, Zo)
    np.testing.assert_allclose(Zn[:, 2], Zo[:, 2], rtol=1e-10 if oracle == "numpy" else 1e-8)


@pytest.fixture(scope="module")
def jax_package_library(tmp_path_factory):
    """The JAX package's native library, its unchanged source and Makefile
    built by its own loader into a private directory: the in-place
    ``libsdtpu_native.so`` may be half-linked by another test process that
    is building it there."""
    import shutil

    native = tmp_path_factory.mktemp("jax_native")
    for name in ("sdtpu_native.cc", "Makefile"):
        shutil.copy(os.path.join(jnb._NATIVE_DIR, name), native / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnb, "_NATIVE_DIR", str(native))
        mp.setattr(jnb, "_LIB_PATH", str(native / "libsdtpu_native.so"))
        mp.setattr(jnb, "_lib", None)
        mp.setattr(jnb, "_build_failed", False)
        assert jnb.available()
        yield jnb


@pytest.mark.parametrize("n", [200, 300])
def test_native_linkage_equals_jax_package_library(jax_package_library, n):
    X = _unit_rows(n, n, 192)
    Zt, Zj = nb.linkage_centroid(X), jax_package_library.linkage_centroid(X)
    _same_merges(Zt, Zj)
    np.testing.assert_array_equal(Zt[:, 2], Zj[:, 2])


@pytest.mark.parametrize("n, native", [(300, True), (100, False)])
def test_auto_backend_takes_native_at_256_rows(n, native):
    X = _unit_rows(7, n, 32)
    before = nb.linkage_calls
    Z = ahc.linkage(X)
    assert (nb.linkage_calls > before) == native
    from scipy.cluster.hierarchy import linkage

    _same_merges(Z, linkage(X, method="centroid", metric="euclidean"))


def test_legacy_switch_and_explicit_native():
    X = np.random.default_rng(3).normal(size=(100, 8))
    before = nb.linkage_calls
    np.testing.assert_allclose(
        ahc.linkage(X, use_native=True), ahc.linkage(X, use_native=False), rtol=1e-10
    )
    np.testing.assert_array_equal(ahc.linkage(X, backend="native"), nb.linkage_centroid(X))
    assert nb.linkage_calls == before + 3


def test_native_backend_rejects_other_methods():
    X = np.random.default_rng(4).normal(size=(20, 4))
    with pytest.raises(ValueError, match="centroid"):
        ahc.linkage(X, method="average", backend="native")
    with pytest.raises(ValueError, match="backend"):
        ahc.linkage(X, backend="cuda")


def test_explicit_native_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(nb, "linkage_centroid", lambda X: None)
    X = np.random.default_rng(5).normal(size=(300, 4))
    with pytest.raises(RuntimeError, match="unavailable"):
        ahc.linkage(X, backend="native")
    # "auto" falls back to scipy, as in the JAX package
    from scipy.cluster.hierarchy import linkage

    np.testing.assert_array_equal(ahc.linkage(X), linkage(X, method="centroid"))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_native_wav_reader_matches_port_reader(tmp_path, bits):
    rng = np.random.default_rng(bits)
    hi = {8: 120, 16: 20000, 32: 2**30}[bits]
    samples = rng.integers(-hi, hi, size=(2, 5000)).astype(np.float64)
    if bits == 8:
        samples += 128  # unsigned 8-bit PCM
    path = str(tmp_path / "t.wav")
    wavio.write_wav(path, samples, 16000, bits)
    want = wavio.read_wav(path)
    native_samples, rate, got_bits = nb.read_wav(path)
    assert (rate, got_bits) == (want.sample_rate, want.bits_per_sample) == (16000, bits)
    np.testing.assert_array_equal(native_samples, want.samples)


def _code_lines(path):
    """The source with every ``//`` comment and blank line dropped."""
    out = []
    for line in open(path):
        line = line.split("//", 1)[0].rstrip()
        if line:
            out.append(line)
    return out


def test_port_source_is_the_jax_source_up_to_comments():
    native = os.path.join("runtime", "native", "sdtpu_native.cc")
    port = os.path.join(REPO, "pyannote_audio_speaker_diarization_cpp_tpu_torch", native)
    jax_src = os.path.join(REPO, "pyannote_audio_speaker_diarization_cpp_tpu", native)
    assert _code_lines(port) == _code_lines(jax_src)
    assert "MEASURED" not in open(port).read()
