"""The port's three kernel modules against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode (and the jnp formulations).
test_torch_cuda.py holds each hand-written CUDA kernel against its plain
version on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_speaker_diarization_cpp_tpu.config import FrontendConfig as JFrontendConfig
from pyannote_audio_speaker_diarization_cpp_tpu.ops import frontend as jfe
from pyannote_audio_speaker_diarization_cpp_tpu.ops import masks as jmk
from pyannote_audio_speaker_diarization_cpp_tpu.ops.asp_pallas import asp_pool_pallas
from pyannote_audio_speaker_diarization_cpp_tpu.ops.frontend_pallas import (
    log_mel_spectrogram as jlog_mel_pallas,
)
from pyannote_audio_speaker_diarization_cpp_tpu.ops.pack_pallas import pack_frames_pallas
from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import FrontendConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend as tfe
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import masks as tmk
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import pack_cuda


# ---------------------------------------------------------------------------
# pack (kernel 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_keep", [0.0, 0.3, 0.7, 1.0])
def test_pack_plain_matches_pallas_bit_exact(p_keep):
    rng = np.random.default_rng(2)
    n, F = 2000, 29
    wav = rng.normal(size=(4, n)).astype(np.float32)
    m = (rng.uniform(size=(4, F)) < p_keep).astype(np.float32)
    want, want_lens = pack_frames_pallas(jnp.asarray(wav), jnp.asarray(m), n, interpret=True)
    got, lens = pack_cuda.pack_frames(torch.from_numpy(wav), torch.from_numpy(m) > 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    # and the sample-level definition: upsample the mask, then left-pack
    imasks = (jmk.interpolate_nearest(jnp.asarray(m), n) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmk.left_pack(jnp.asarray(wav), imasks))
    )


def test_pack_and_lengths_matches_jax():
    rng = np.random.default_rng(3)
    n, F = 80000, 293
    wav = rng.normal(size=(3, n)).astype(np.float32)
    masks = rng.uniform(size=(3, F)).astype(np.float32)
    masks[1] = 0.0  # too short
    masks[2, :2] = 1.0
    masks[2, 2:] = 0.0  # 2 frames: 546 samples < 640 -> too short
    j = jmk.pack_and_lengths(jnp.asarray(wav), jnp.asarray(masks), 0.5, 640, backend="jnp")
    t = tmk.pack_and_lengths(torch.from_numpy(wav), torch.from_numpy(masks), 0.5, 640)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_frame_tables_match_pallas_tables():
    from pyannote_audio_speaker_diarization_cpp_tpu.ops.pack_pallas import _frame_tables

    for F, n in [(293, 80000), (29, 2000), (56, 16000), (17, 1600)]:
        run_len, orig_start = pack_cuda.frame_tables(F, n)
        want_len, want_start = _frame_tables(F, n)
        np.testing.assert_array_equal(run_len.numpy(), want_len)
        np.testing.assert_array_equal(orig_start.numpy(), want_start)


# The CUDA pack kernel's segment table and its quad copy, emulated in numpy
# step for step (the kernel itself runs only on the card: test_torch_cuda.py).
# Its geometry (csrc/pack.cu): 256 threads, 4 quads a thread, 4096-sample
# tiles; one sample a step where n % 4 != 0.
_PACK_THREADS, _PACK_QUADS = 256, 4
_PACK_TILE = _PACK_THREADS * _PACK_QUADS * 4


def _frame_starts32(F, n):
    """The kernel's frame starts ceil(f * n / F), f = 0..F, in unsigned
    32-bit arithmetic (numpy wraps uint32 products as the card does)."""
    f = np.arange(F + 1, dtype=np.uint32)
    return ((f * np.uint32(n) + np.uint32(F - 1)) // np.uint32(F)).astype(np.int64)


def _kernel_segment_table(keep_row, n):
    """(dst (nseg + 1,), delta (nseg,)) as one block builds it: each thread
    counts the segments that start in its frames and their kept samples, an
    exclusive scan over the threads places them, and each thread writes its
    segments; dst[nseg] = lens."""
    F = keep_row.shape[0]
    per = -(-F // _PACK_THREADS)
    start = _frame_starts32(F, n)

    def frames(t):
        f0 = min(t * per, F)
        return f0, min(f0 + per, F), f0 > 0 and f0 < F and bool(keep_row[f0 - 1])

    counts = np.zeros((_PACK_THREADS, 2), np.int64)  # (segments, kept) a thread
    for t in range(_PACK_THREADS):
        f0, f1, prev = frames(t)
        for f in range(f0, f1):
            if keep_row[f]:
                counts[t] += (not prev, start[f + 1] - start[f])
            prev = bool(keep_row[f])
    before = np.cumsum(counts, axis=0) - counts  # the block-wide scan
    nseg, length = counts.sum(axis=0)
    dst = np.zeros(nseg + 1, np.int64)
    delta = np.zeros(nseg, np.int64)
    for t in range(_PACK_THREADS):
        (f0, f1, prev), (s, pos) = frames(t), before[t]
        for f in range(f0, f1):
            if keep_row[f]:
                if not prev:
                    dst[s], delta[s] = pos, start[f] - pos
                    s += 1
                pos += start[f + 1] - start[f]
            prev = bool(keep_row[f])
    dst[nseg] = length
    return dst, delta


def _find_segment(dst, s, nseg, j):
    hi = nseg - 1
    while s < hi:
        mid = (s + hi + 1) >> 1
        if dst[mid] <= j:
            s = mid
        else:
            hi = mid - 1
    return s


def _kernel_pack_row(wrow, keep_row):
    """One row as the kernel's blocks write it: per thread, its quads in
    order, each from four 4-byte loads at its segment's offset, element by
    element where a quad crosses a segment's end, zeros past lens; one
    sample a step where n % 4 != 0."""
    n = wrow.shape[0]
    dst, delta = _kernel_segment_table(keep_row, n)
    nseg, length = dst.shape[0] - 1, int(dst[-1])
    vec = n % 4 == 0
    unit = 4 if vec else 1
    steps = _PACK_TILE // (_PACK_THREADS * unit)
    out = np.full(n, np.nan, np.float32)
    for j0 in range(0, n, _PACK_TILE):
        j1 = min(j0 + _PACK_TILE, n)
        for tid in range(_PACK_THREADS):
            s = 0
            for k in range(steps):
                j = j0 + unit * (k * _PACK_THREADS + tid)
                if j >= j1:
                    continue
                v = np.zeros(unit, np.float32)
                if j < length:
                    s = _find_segment(dst, s, nseg, j)
                    if not vec:
                        v[0] = wrow[j + delta[s]]
                    elif j + 4 <= dst[s + 1]:  # four 4-byte loads
                        v = np.array([wrow[j + delta[s] + i] for i in range(4)], np.float32)
                    else:
                        for i in range(4):
                            if j + i < length:
                                while dst[s + 1] <= j + i:
                                    s += 1
                                v[i] = wrow[j + i + delta[s]]
                out[j : j + unit] = v
    return out, length


def _pack_case_mask(kind, F, rng):
    if kind == "random":
        return rng.uniform(size=F) < 0.5
    if kind == "runs":  # speech-like runs of 8 frames
        return np.repeat(rng.uniform(size=F // 8 + 1) < 0.6, 8)[:F]
    if kind == "alternate":  # the most segments: every other frame
        return np.arange(F) % 2 == 0
    if kind == "last_only":
        return np.arange(F) == F - 1
    return np.full(F, kind == "all")


@pytest.mark.parametrize("F,n", [(293, 80000), (29, 2000), (56, 16000), (43, 12345), (1024, 1024)])
def test_pack_segment_table_matches_jax_frame_tables(F, n):
    """The kernel's 32-bit frame starts and its per-row segment table, from
    JAX's _frame_tables: each segment's source start, packed start and
    packed end, over random, run, alternate and edge masks."""
    from pyannote_audio_speaker_diarization_cpp_tpu.ops.pack_pallas import _frame_tables

    run_len, orig_start = _frame_tables(F, n)
    np.testing.assert_array_equal(_frame_starts32(F, n), np.append(orig_start, n))
    np.testing.assert_array_equal(np.diff(_frame_starts32(F, n)), run_len)
    rng = np.random.default_rng(F)
    for kind in ("random", "runs", "alternate", "last_only", "all", "none"):
        keep = _pack_case_mask(kind, F, rng)
        dst, delta = _kernel_segment_table(keep, n)
        # JAX's segment tables (pack_frames_pallas): maximal kept runs
        plen = np.where(keep, run_len, 0)
        pcum = np.cumsum(plen)
        is_start = keep & np.concatenate([[True], ~keep[:-1]])
        is_end = keep & np.concatenate([~keep[1:], [True]])
        np.testing.assert_array_equal(dst[:-1], (pcum - plen)[is_start])
        np.testing.assert_array_equal(dst[:-1] + delta, orig_start[is_start])
        np.testing.assert_array_equal(dst[1:], pcum[is_end])
        assert dst[-1] == plen.sum()
        if kind == "alternate":
            assert dst.shape[0] - 1 == (F + 1) // 2


def test_pack_rejects_frame_sample_products_past_int32():
    """F * n >= 2**31 does not fit the kernel's 32-bit frame starts: the
    wrapper raises before it dispatches (shapes only: batch 0)."""
    n = 2**31 // 293 + 1
    with pytest.raises(ValueError, match="2\\*\\*31"):
        pack_cuda.pack_frames(torch.zeros(0, n), torch.zeros(0, 293, dtype=torch.bool))
    n = 2**31 // 293
    packed, lens = pack_cuda.pack_frames(torch.zeros(0, n), torch.zeros(0, 293, dtype=torch.bool))
    assert packed.shape == (0, n) and lens.shape == (0,)
    for F, n in [(0, 100), (101, 100)]:
        with pytest.raises(ValueError):
            pack_cuda.pack_frames(torch.zeros(1, n), torch.zeros(1, F, dtype=torch.bool))


@pytest.mark.parametrize(
    "F,n,kinds",
    [
        (293, 80000, ("runs", "alternate")),
        (56, 16000, ("random", "runs", "alternate", "last_only", "all", "none")),
        (43, 12345, ("random", "alternate", "last_only", "all")),
        (29, 2003, ("runs", "alternate")),
    ],
)
def test_pack_kernel_quad_copy_emulation_bit_exact(F, n, kinds):
    """The kernel's copy, emulated quad by quad (n % 4 == 0) or sample by
    sample (n % 4 != 0), equals pack_frames_plain bit for bit; every output
    sample is written (the emulation starts from NaN) and no read leaves the
    row (numpy raises past its end; no index is negative)."""
    rng = np.random.default_rng(n)
    wav = rng.normal(size=(len(kinds), n)).astype(np.float32)
    keep = np.stack([_pack_case_mask(kind, F, rng) for kind in kinds])
    want, want_lens = pack_cuda.pack_frames_plain(torch.from_numpy(wav), torch.from_numpy(keep))
    for r in range(len(kinds)):
        got, length = _kernel_pack_row(wav[r], keep[r])
        assert length == int(want_lens[r])
        np.testing.assert_array_equal(got, want[r].numpy())


# ---------------------------------------------------------------------------
# log-mel front-end (kernel 2)
# ---------------------------------------------------------------------------


def test_frontend_constants_equal():
    jc, tc = JFrontendConfig(), FrontendConfig()
    np.testing.assert_array_equal(
        jfe.dft_basis(jc.n_fft, jc.win_length), tfe.dft_basis(tc.n_fft, tc.win_length)
    )
    np.testing.assert_array_equal(jfe.mel_filterbank(jc), tfe.mel_filterbank(tc))


def test_log_mel_plain_matches_pallas():
    cfg = FrontendConfig()
    x = np.random.default_rng(0).normal(size=(2, 16000)).astype(np.float32)
    want = np.asarray(jlog_mel_pallas(jnp.asarray(x), JFrontendConfig(), interpret=True))
    basis, mel = tfe.constants(cfg, torch.device("cpu"))
    mult, db_off = tfe._db_terms(cfg)
    got = frontend_cuda.log_mel_spectrogram(
        torch.from_numpy(x), basis, mel, cfg.hop_length, cfg.amin, mult, db_off
    ).numpy()
    assert got.shape == want.shape == (2, 101, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_compute_features_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 32000)).astype(np.float32)
    x[2, 9000:] = 0.0  # a packed row's zero tail
    lens = np.asarray([1.0, 0.6, 0.25], np.float32)
    want = np.asarray(jfe.compute_features(jnp.asarray(x), jnp.asarray(lens), JFrontendConfig()))
    got = tfe.compute_features(torch.from_numpy(x), torch.from_numpy(lens), FrontendConfig())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    # the unfused chain (stft_power -> log_mel) too
    power_j = np.asarray(jfe.stft_power(jnp.asarray(x), JFrontendConfig()))
    power_t = tfe.stft_power(torch.from_numpy(x), FrontendConfig()).numpy()
    np.testing.assert_allclose(power_t, power_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        tfe.log_mel(torch.from_numpy(power_j.copy()), FrontendConfig()).numpy(),
        np.asarray(jfe.log_mel(jnp.asarray(power_j), JFrontendConfig())),
        rtol=1e-4,
        atol=1e-3,
    )


# The CUDA kernel's host-side tables and its 3xTF32 arithmetic, emulated in
# numpy (the kernel itself runs only on the card: test_torch_cuda.py).


def _rna_tf32(v):
    """numpy cvt.rna.tf32.f32: round to 10 mantissa bits, ties away."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_split_of_basis():
    cfg = FrontendConfig()
    v = tfe.dft_basis(cfg.n_fft, cfg.win_length).astype(np.float32)
    big, small = (t.numpy() for t in frontend_cuda.split_tf32(torch.from_numpy(v)))
    for half in (big, small):
        assert not (half.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(big, _rna_tf32(v))
    np.testing.assert_array_equal(small, _rna_tf32(v - big))
    err = np.abs(big.astype(np.float64) + small - v)
    assert (err <= 2.0**-21 * np.abs(v)).all()


@pytest.mark.parametrize("win", [400, 396])
def test_basis_tiles_map_back_to_dft_basis(win):
    """Every entry of the kernel's basis layout from its definition: pass,
    k step, big or small half, column group, k-group, column, k."""
    cfg = FrontendConfig()
    basis = tfe.dft_basis(cfg.n_fft, cfg.win_length).astype(np.float32)[:win]
    nf = basis.shape[1] // 2
    tiles = frontend_cuda.basis_tiles(torch.from_numpy(basis)).numpy()
    steps = frontend_cuda.kernel_ksteps(win)
    assert steps == 50 and tiles.shape == (steps * 8 * 2 * 2 * frontend_cuda.KERNEL_BINS,)
    padded = np.zeros((8 * steps, basis.shape[1]), np.float32)
    padded[:win] = basis  # zero rows pad K
    at, pair0 = 0, 0
    for pairs in frontend_cuda.PASS_PAIRS:
        n = 16 * pairs
        s, half, cg, kg, row, kk = np.meshgrid(
            np.arange(steps), np.arange(2), np.arange(n // 8), np.arange(2), np.arange(8),
            np.arange(4), indexing="ij",
        )
        c = 8 * cg + row  # the pass's column: pair, then real (8) and imaginary (8)
        q = 8 * (pair0 + c // 16) + c % 8
        v = np.where(q < nf, padded[8 * s + 4 * kg + kk, np.minimum(q, nf - 1) + nf * (c // 8 % 2)], 0)
        big = _rna_tf32(v)
        want = np.where(half == 0, big, _rna_tf32(v - big))
        np.testing.assert_array_equal(tiles[at : at + want.size], want.reshape(-1))
        at, pair0 = at + want.size, pair0 + pairs
    assert at == tiles.size and pair0 == frontend_cuda.KERNEL_BINS // 8


def test_band_table_covers_filterbank():
    cfg = FrontendConfig()
    mel = tfe.mel_filterbank(cfg).astype(np.float32)
    bins, weights = (t.numpy() for t in frontend_cuda.band_table(torch.from_numpy(mel)))
    nf, n_mels = mel.shape
    dense = np.zeros_like(mel)
    for m in range(n_mels):
        first, count = bins[m]
        assert 1 <= count <= frontend_cuda.BAND_WIDTH and first + count <= nf
        dense[first : first + count, m] = weights[m, :count]
        assert not weights[m, count:].any()
    np.testing.assert_array_equal(dense, mel)  # every nonzero, in its place
    assert int((mel != 0).sum()) == 387
    # the banded sum (ascending, float32) is the dense product to rounding
    power = np.random.default_rng(4).exponential(size=(50, nf)).astype(np.float32)
    banded = np.zeros((50, n_mels), np.float32)
    for m in range(n_mels):
        first, count = bins[m]
        for j in range(count):
            banded[:, m] += power[:, first + j] * weights[m, j]
    dense_fb = (torch.from_numpy(power) @ torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(banded, dense_fb, rtol=2e-6, atol=0)


def test_band_table_rejects_wide_bands():
    mel = tfe.mel_filterbank(FrontendConfig(n_mels=8)).astype(np.float32)
    with pytest.raises(ValueError):
        frontend_cuda.band_table(torch.from_numpy(mel))


def _log_mel_signal(kind, rows, n, seed):
    """The three signals the kernel is held to: normal(0, 1) with a zero
    tail, the bench's 0.1-sine-plus-noise clip, an int16-quantized clip."""
    rng = np.random.default_rng(seed)
    if kind == "normal_zero_tail":
        x = rng.normal(size=(rows, n))
        x[rows // 2, 3 * n // 8 :] = 0.0
        return x.astype(np.float32)
    t = np.arange(rows * n) / 16000.0
    if kind == "bench_clip":
        x = 0.1 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.normal(size=t.shape)
        return x.astype(np.float32).reshape(rows, n)
    x = (
        0.30 * np.sin(2 * np.pi * 220.0 * t)
        + 0.20 * np.sin(2 * np.pi * 1100.0 * t * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t)))
        + 0.05 * rng.standard_normal(t.shape)
    )
    q = np.clip(np.round(x * 20000.0), -32768, 32767).astype(np.int16)
    return (q.astype(np.float32) / 32768.0).reshape(rows, n)


def _frames(x, cfg):
    hop, win = cfg.hop_length, cfg.win_length
    frames = 1 + x.shape[1] // hop
    xp = np.pad(x, ((0, 0), (win // 2, (frames - 1) * hop + win // 2 - x.shape[1])))
    return np.lib.stride_tricks.sliding_window_view(xp, win, axis=1)[:, ::hop]


@pytest.mark.parametrize("kind", ["normal_zero_tail", "bench_clip", "int16_clip"])
def test_log_mel_3xtf32_is_float32_accurate(kind):
    """3xTF32 as the kernel sums it (per k16, two k steps of 8 with the two
    small terms and then the big one each, into a fresh float32 accumulator
    that is then added to the running sum) against the plain float32 version
    and a float64 log-mel; one TF32 product is not accurate enough."""
    cfg = FrontendConfig()
    x = _log_mel_signal(kind, 4, 80000, seed=10)
    mult, db_off = tfe._db_terms(cfg)
    basis64 = tfe.dft_basis(cfg.n_fft, cfg.win_length)
    mel64 = tfe.mel_filterbank(cfg)
    fr = _frames(x, cfg)

    def log_mel(spec, mel):
        nf = spec.shape[-1] // 2
        fb = (spec[..., :nf] ** 2 + spec[..., nf:] ** 2) @ mel
        return mult * np.log10(np.maximum(fb, cfg.amin)) - db_off

    ref64 = log_mel(fr.astype(np.float64) @ basis64, mel64)
    basis, mel = (v.astype(np.float32) for v in (basis64, mel64))
    ab, bb = _rna_tf32(fr), _rna_tf32(basis)
    a_s, b_s = _rna_tf32(fr - ab), _rna_tf32(basis - bb)
    acc = np.zeros(fr.shape[:2] + basis.shape[1:], np.float32)
    for k16 in range(0, basis.shape[0], 16):
        step = np.zeros_like(acc)
        for k in (k16, k16 + 8):
            ks = slice(k, k + 8)
            step += a_s[..., ks] @ bb[ks]
            step += ab[..., ks] @ b_s[ks]
            step += ab[..., ks] @ bb[ks]
        acc += step
    three = log_mel(acc, mel)
    one = log_mel(ab @ bb, mel)
    plain = frontend_cuda.log_mel_spectrogram_plain(
        torch.from_numpy(x), torch.from_numpy(basis), torch.from_numpy(mel),
        cfg.hop_length, cfg.amin, mult, db_off,
    ).numpy()
    np.testing.assert_allclose(three, plain, rtol=1e-4, atol=1e-3)
    err_plain = np.abs(plain - ref64).max()
    assert np.abs(three - ref64).max() <= err_plain + 2e-3
    assert np.abs(one - ref64).max() > err_plain + 2e-3


# ---------------------------------------------------------------------------
# ASP tail (kernel 3)
# ---------------------------------------------------------------------------


def _asp_inputs(B, A, C, T, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    a = np.tanh(rng.normal(size=(B, A, T))).astype(np.float32)
    w = (rng.normal(size=(C, A)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    lens = rng.uniform(0.3, 1.0, B).astype(np.float32)
    mask = (np.arange(T)[None, :] < (lens * T)[:, None]).astype(np.float32)
    return x, a, w, b, mask


def _asp_jnp(x, a, w, b, mask, eps=1e-12):
    s = jnp.einsum("ca,bat->bct", w, a, precision=jax.lax.Precision.HIGHEST) + b[None, :, None]
    s = jnp.where(jnp.asarray(mask)[:, None, :] == 0, -jnp.inf, s)
    p = jax.nn.softmax(s, axis=2)
    mean = jnp.sum(p * x, axis=2)
    std = jnp.sqrt(jnp.maximum(jnp.sum(p * x * x, axis=2) - mean**2, eps))
    return np.asarray(mean), np.asarray(std)


def test_asp_plain_matches_pallas():
    x, a, w, b, mask = _asp_inputs(4, 32, 256, 97, seed=5)
    want_mean, want_std = asp_pool_pallas(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(w), jnp.asarray(b), jnp.asarray(mask),
        interpret=True,
    )
    mean, std = asp_cuda.asp_pool(*(torch.from_numpy(v) for v in (x, a, w, b, mask)))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(want_std), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C", [100, 200])
def test_asp_plain_any_channel_count_matches_jnp(C):
    """The Pallas kernel needs C % 128 == 0; the port takes any C."""
    x, a, w, b, mask = _asp_inputs(3, 16, C, 61, seed=C)
    want_mean, want_std = _asp_jnp(*(jnp.asarray(v) for v in (x, a, w, b)), mask)
    mean, std = asp_cuda.asp_pool(*(torch.from_numpy(v) for v in (x, a, w, b, mask)))
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), want_std, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_tanh_layout(dtype):
    """bf16 and float32: rows padded to 8 frames, so each starts 16-byte
    aligned for the kernels' reads; a call autograd records, or another
    dtype: contiguous. The values are torch.tanh's either way."""
    attn = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 5, 37)).astype(np.float32))
    attn = attn.to(dtype)
    got = asp_cuda.attention_tanh(attn)
    assert torch.equal(got, torch.tanh(attn))
    assert got.stride() == (5 * 40, 40, 1)
    assert asp_cuda.attention_tanh(attn.clone().requires_grad_()).is_contiguous()
    assert asp_cuda.attention_tanh(attn.double()).is_contiguous()


def test_asp_plain_takes_padded_attention_rows():
    """a_tanh in the padded rows attention_tanh gives, against the jnp oracle."""
    x, a, w, b, mask = _asp_inputs(3, 16, 200, 61, seed=11)
    rows = torch.empty((3, 16, 64))[..., :61].copy_(torch.from_numpy(a))
    want_mean, want_std = _asp_jnp(*(jnp.asarray(v) for v in (x, a, w, b)), mask)
    mean, std = asp_cuda.asp_pool(
        torch.from_numpy(x), rows, *(torch.from_numpy(v) for v in (w, b, mask))
    )
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), want_std, rtol=1e-4, atol=1e-5)


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        pack_cuda.pack_frames(torch.zeros(3, 10), torch.zeros(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError):
        asp_cuda.asp_pool(
            torch.zeros(2, 8, 5), torch.zeros(2, 4, 5), torch.zeros(8, 3),
            torch.zeros(8), torch.ones(2, 5),
        )
