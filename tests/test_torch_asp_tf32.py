"""The float32 ASP kernel's arithmetic (csrc/asp.cu asp_f32_kernel), emulated
in numpy at the main path's widths: its 3xTF32 score product (the kernel's
split into TF32 halves, its order of products and a fresh accumulator each
k16) and its online softmax over 64-frame tiles in base 2, held against a
float64 ASP and against ``asp_pool_plain`` at the kernel's tolerance. One
TF32 product alone misses that tolerance. The kernel itself runs only on the
card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda

B, A, C, T = 2, 128, 256, 501
TILE = 64  # frames a tile
LOG2E = np.float32(1.4426950408889634)
EPS = 1e-12
# the kernel's tolerance against asp_pool_plain (tests/test_torch_cuda.py)
TOL = dict(mean=(1e-5, 1e-5), std=(1e-4, 1e-5))


def _tf32(v):
    """A float32 as the tensor cores read a TF32 operand: its low 13
    mantissa bits dropped."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    """The kernel's halves as the tensor cores read them: big = v truncated
    to TF32, small = v - big (exact in float32), itself read truncated."""
    big = _tf32(v)
    return big, _tf32(v - big)


def _inputs(mask_kind, weights, seed=0):
    """x, a_tanh, W, bias, mask: x normal, a_tanh = tanh(normal); W and bias
    normal x 0.1 (the card tests' draw) or uniform within 1 / sqrt(A) (a conv's
    initialisation, chip_smoke.py's kernel phase); row 0 fully valid, row 1 a
    length mask, and with "holes" invalid runs inside the length (a whole
    64-frame tile among them)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    a = np.tanh(rng.normal(size=(B, A, T))).astype(np.float32)
    if weights == "normal":
        w = (rng.normal(size=(C, A)) * 0.1).astype(np.float32)
        bias = (rng.normal(size=C) * 0.1).astype(np.float32)
    else:
        lim = 1.0 / np.sqrt(A)
        w = rng.uniform(-lim, lim, (C, A)).astype(np.float32)
        bias = rng.uniform(-lim, lim, C).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 307:] = 0.0
    if mask_kind == "holes":
        mask[:, 20:150] = 0.0
        mask[0, 400:410] = 0.0
    return x, a, w, bias, mask


def _scores_3xtf32(w, a):
    """W . a_tanh as the kernel sums it: per k step of 8 the two small terms
    (w_small . a_big, w_big . a_small), then the big one, each k16 (two k
    steps) into a fresh float32 accumulator that is then added to the
    running sum."""
    wb, ws = _split(w)
    ab, as_ = _split(a)
    acc = np.zeros((B, C, T), np.float32)
    for k16 in range(0, A, 16):
        step = np.zeros_like(acc)
        for k in (k16, k16 + 8):
            ks = slice(k, k + 8)
            step += np.matmul(ws[:, ks], ab[:, ks])
            step += np.matmul(wb[:, ks], as_[:, ks])
            step += np.matmul(wb[:, ks], ab[:, ks])
        acc += step
    return acc


def _pool_online(s, bias, x, mask):
    """The kernel's softmax and statistics from its scores s (B, C, T),
    float32: base-2 scores fma(s, log2 e, bias log2 e), -inf off the mask; per
    64-frame tile the running max, the sums rescaled by exp2 of its change,
    then exp2(score - max) added into den, sum p x and sum p x^2."""
    s2 = (s.astype(np.float64) * LOG2E + (bias * LOG2E)[None, :, None]).astype(np.float32)
    s2 = np.where(mask[:, None, :] > 0, s2, np.float32(-np.inf))
    run = np.full((B, C, 1), -np.inf, np.float32)
    den = np.zeros((B, C, 1), np.float32)
    s1 = np.zeros_like(den)
    sq = np.zeros_like(den)
    with np.errstate(invalid="ignore"):
        for t0 in range(0, T, TILE):
            tile = s2[..., t0 : t0 + TILE]
            if not (mask[:, t0 : t0 + TILE] > 0).any():
                continue
            new = np.maximum(run, tile.max(axis=2, keepdims=True))
            scale = np.exp2(run - new).astype(np.float32)
            den, s1, sq, run = den * scale, s1 * scale, sq * scale, new
            p = np.exp2(tile - new).astype(np.float32)
            xt = x[..., t0 : t0 + TILE]
            den = den + p.sum(axis=2, keepdims=True, dtype=np.float32)
            s1 = s1 + (p * xt).sum(axis=2, keepdims=True, dtype=np.float32)
            sq = sq + (p * xt * xt).sum(axis=2, keepdims=True, dtype=np.float32)
    mean = (s1 / den)[..., 0]
    var = np.maximum((sq / den)[..., 0] - mean * mean, 0.0)
    return mean, np.sqrt(np.maximum(var, EPS)).astype(np.float32)


def _asp64(x, a, w, bias, mask):
    s = np.einsum("ca,bat->bct", w.astype(np.float64), a.astype(np.float64)) + bias[None, :, None]
    s = np.where(mask[:, None, :] > 0, s, -np.inf)
    p = np.exp(s - s.max(axis=2, keepdims=True))
    p /= p.sum(axis=2, keepdims=True)
    mean = (p * x).sum(axis=2)
    var = np.maximum((p * x * x).sum(axis=2) - mean**2, 0.0)
    return mean, np.sqrt(np.maximum(var, EPS))


def _within(got, want):
    (mean, std), (want_mean, want_std) = got, want
    return np.allclose(mean, want_mean, rtol=TOL["mean"][0], atol=TOL["mean"][1]) and np.allclose(
        std, want_std, rtol=TOL["std"][0], atol=TOL["std"][1]
    )


@pytest.mark.parametrize("weights", ["normal", "uniform"])
@pytest.mark.parametrize("mask_kind", ["lengths", "holes"])
def test_asp_3xtf32_is_float32_accurate(mask_kind, weights):
    x, a, w, bias, mask = _inputs(mask_kind, weights)
    ref = _asp64(x, a, w, bias, mask)
    plain = tuple(
        t.numpy()
        for t in asp_cuda.asp_pool_plain(*(torch.from_numpy(v) for v in (x, a, w, bias, mask)))
    )
    three = _pool_online(_scores_3xtf32(w, a), bias, x, mask)
    assert _within(three, ref) and _within(three, plain) and _within(plain, ref)
    # one TF32 product (the big terms alone) moves the scores by ~3e-4
    wb, ab = _tf32(w), _tf32(a)
    one = _pool_online(np.matmul(wb, ab), bias, x, mask)
    assert not _within(one, ref)
    assert not _within(one, plain)
    # the same online softmax on float64-exact scores: the product, not the
    # softmax, is what one TF32 product gets wrong
    s_exact = np.einsum("ca,bat->bct", w.astype(np.float64), a.astype(np.float64))
    assert _within(_pool_online(s_exact.astype(np.float32), bias, x, mask), ref)
