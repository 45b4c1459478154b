"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card, at the shapes the main path gives it. Marked ``cuda``: skipped without
a CUDA device. This file imports nothing of JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import FrontendConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend as tfe
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import pack_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _asp_inputs(B, A, C, T, seed, holes=False, last_only=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    a = np.tanh(rng.normal(size=(B, A, T))).astype(np.float32)
    w = (rng.normal(size=(C, A)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    lens = rng.uniform(0.3, 1.0, B).astype(np.float32)
    mask = (np.arange(T)[None, :] < (lens * T)[:, None]).astype(np.float32)
    if holes:  # invalid frames inside the length too, whole 64-frame tiles among them
        mask[:, 20:150] = 0.0
    if last_only:  # the first row's only valid frame is its last one
        mask[0] = 0.0
        mask[0, -1] = 1.0
    return x, a, w, b, mask


def _pack_keep(kind, B, F, rng):
    """(B, F) keep flags: random at a kept share, or one of the edges."""
    if kind.startswith("p"):
        return rng.uniform(size=(B, F)) < float(kind[1:])
    f = np.arange(F)[None, :].repeat(B, 0)
    if kind == "alternate":  # the most segments: (F + 1) // 2
        return f % 2 == 0
    if kind == "last_only":
        return f == F - 1
    return np.full((B, F), kind == "all")


# (keep kind, flag dtype, B, n, F): random shares at the main shape, then all
# and none kept, alternate frames, only the last frame, bool / float / int
# flags, a short window, n % 4 != 0 (one sample a step), one row, no rows
_PACK_CASES = [(f"p{p}", "bool", 32, 80000, 293) for p in (0.0, 0.3, 0.7, 1.0)] + [
    ("all", "bool", 32, 80000, 293),
    ("none", "bool", 32, 80000, 293),
    ("alternate", "bool", 32, 80000, 293),
    ("last_only", "bool", 32, 80000, 293),
    ("p0.5", "float32", 32, 80000, 293),
    ("p0.5", "int32", 8, 80000, 293),
    ("p0.5", "bool", 32, 16000, 56),
    ("alternate", "bool", 8, 12345, 43),
    ("p0.5", "bool", 8, 12345, 43),
    ("p0.5", "bool", 1, 80000, 293),
    ("p0.5", "bool", 0, 80000, 293),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,flag_dtype,B,n,F", _PACK_CASES)
def test_pack_kernel_matches_plain(cuda, kind, flag_dtype, B, n, F):
    rng = np.random.default_rng(7)
    wav = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32)).to(cuda)
    keep = torch.from_numpy(_pack_keep(kind, B, F, rng)).to(cuda, getattr(torch, flag_dtype))
    before = pack_cuda.pack_frames.launches
    got, lens = pack_cuda.pack_frames(wav, keep)
    assert pack_cuda.pack_frames.launches == before + (B > 0)
    want, want_lens = pack_cuda.pack_frames_plain(wav, keep)
    assert torch.equal(got, want) and torch.equal(lens, want_lens)


@pytest.mark.cuda
def test_pack_kernel_unaligned_rows(cuda):
    """Waveforms that start 4 bytes past 16: the 16-byte route stores whole
    quads but reads its sources by 4-byte loads, so it stays bit-exact."""
    rng = np.random.default_rng(12)
    wav = torch.from_numpy(rng.normal(size=(4, 16000)).astype(np.float32)).to(cuda)
    flat = torch.empty(wav.numel() + 1, device=cuda)
    flat[1:] = wav.reshape(-1)
    shifted = flat[1:].view(wav.shape)
    assert shifted.data_ptr() % 16 == 4
    keep = torch.from_numpy(_pack_keep("p0.5", 4, 56, rng)).to(cuda)
    got, lens = pack_cuda.pack_frames(shifted, keep)
    want, want_lens = pack_cuda.pack_frames_plain(wav, keep)
    assert torch.equal(got, want) and torch.equal(lens, want_lens)


def _log_mel_signal(kind, rows, n, seed):
    """normal(0, 1) (row 5 with a zero tail), the bench's 0.1-sine-plus-noise
    clip, or an int16-quantized clip; (rows, n) float32."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.normal(size=(rows, n))
        if rows > 5:
            x[5, 30000:] = 0.0
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


# (signal, B, n): the main shape with a zero tail, the bench and int16 clips,
# a partial last tile (n = 16000: 101 frames), n not a multiple of 4, one
# row, and an all-zero row
_LOG_MEL_CASES = [
    ("normal", 32, 80000),
    ("bench_clip", 32, 80000),
    ("int16_clip", 32, 80000),
    ("normal", 32, 16000),
    ("normal", 32, 16001),
    ("normal", 1, 80000),
    ("zero_row", 4, 80000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,n", _LOG_MEL_CASES)
def test_log_mel_kernel_matches_plain(cuda, kind, B, n):
    cfg = FrontendConfig()
    x = torch.from_numpy(_log_mel_signal("normal" if kind == "zero_row" else kind, B, n, seed=8))
    if kind == "zero_row":
        x[2] = 0.0
    basis, mel = tfe.constants(cfg, cuda)
    mult, db_off = tfe._db_terms(cfg)
    args = (x.to(cuda), basis, mel, cfg.hop_length, cfg.amin, mult, db_off)
    before = frontend_cuda.log_mel_spectrogram.launches
    got = frontend_cuda.log_mel_spectrogram(*args)
    assert frontend_cuda.log_mel_spectrogram.launches == before + 1
    # the plain version runs on the CPU: on an H100 the card's float32 GEMM
    # loses more to cancellation in the quiet bins (0.0185 dB from float64 on
    # the bench clip, against the CPU's 0.0053 and the kernel's 0.0023)
    want = frontend_cuda.log_mel_spectrogram_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in args)
    )
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3)
    # float32-accurate: no further from a float64 log-mel than the plain
    # version, give or take 2e-3 dB
    basis64 = torch.from_numpy(tfe.dft_basis(cfg.n_fft, cfg.win_length)).to(cuda)
    mel64 = torch.from_numpy(tfe.mel_filterbank(cfg)).to(cuda)
    ref = frontend_cuda.log_mel_spectrogram_plain(
        x.to(cuda).double(), basis64, mel64, cfg.hop_length, cfg.amin, mult, db_off
    ).cpu()
    err = float((got.cpu().double() - ref).abs().max())
    assert err <= float((want.double() - ref).abs().max()) + 2e-3
    if kind == "zero_row":  # silence reads the floor exactly
        floor = np.float32(mult * np.log10(cfg.amin) - db_off)
        assert bool((got[2] == float(floor)).all())


@pytest.mark.cuda
def test_log_mel_kernel_rejects_geometry(cuda):
    """Geometries the kernel does not take raise; nothing falls back."""
    cfg = FrontendConfig()
    x = torch.zeros((2, 16000), device=cuda)
    basis, mel = tfe.constants(cfg, cuda)
    mult, db_off = tfe._db_terms(cfg)

    def call(basis, mel, hop):
        return frontend_cuda.log_mel_spectrogram(x, basis, mel, hop, cfg.amin, mult, db_off)

    wide = torch.from_numpy(tfe.dft_basis(416, 416).astype(np.float32)).to(cuda)  # nf 209
    with pytest.raises(ValueError):
        call(wide, torch.zeros((209, 80), device=cuda), 160)
    coarse = torch.from_numpy(tfe.mel_filterbank(FrontendConfig(n_mels=8)).astype(np.float32))
    with pytest.raises(ValueError):  # bands wider than the table
        call(basis, coarse.to(cuda), 160)
    with pytest.raises(ValueError):  # hop not a multiple of 4
        call(basis, mel, 162)
    odd = torch.from_numpy(tfe.dft_basis(402, 402).astype(np.float32)).to(cuda)  # win 402
    with pytest.raises(ValueError):
        call(odd, torch.zeros((202, 80), device=cuda), 160)


_F32, _BF16 = torch.float32, torch.bfloat16
# (dtype, B, A, C, T, mask kind): the main path's shapes in both types, then
# each kernel's edges: T not a multiple of the 64-frame tile, the channel
# edge (C = 200), K padding (A = 40; A = 37, W rows not 16-byte aligned), one row, a row whose only valid frame
# is its last, masks with holes, rows that all start at an odd element (x
# and a_tanh at an odd storage offset), a_tanh in rows padded to 8 frames as
# the model lays it out (contiguous elsewhere), and for bf16 mask and bias
# as the model passes them (bf16)
_ASP_EDGES = [
    (8, 128, 256, 37, "lengths"),
    (8, 40, 3072, 501, "lengths"),
    (4, 40, 200, 37, "holes"),
    (4, 37, 200, 37, "holes"),
    (1, 128, 3072, 501, "lengths"),
    (4, 128, 200, 501, "last_only"),
    (4, 128, 384, 37, "last_only"),
    (4, 40, 200, 128, "odd_offset"),
    (8, 128, 3072, 501, "padded_rows"),
    (4, 40, 200, 37, "padded_rows"),
]
_ASP_CASES = (
    [
        (dtype, 32, 128, C, 501, kind)
        for dtype in (_F32, _BF16)
        for C in (3072, 200)
        for kind in ("lengths", "holes")
    ]
    + [(dtype, *edge) for dtype in (_F32, _BF16) for edge in _ASP_EDGES]
    + [(_BF16, 8, 128, 3072, 501, "bf16_mask_bias")]
)


def _at_odd_offset(t):
    """A contiguous copy of t whose storage starts one element into its buffer."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,A,C,T,kind", _ASP_CASES)
def test_asp_kernel_matches_plain(cuda, dtype, B, A, C, T, kind):
    x, a, w, b, mask = (
        torch.from_numpy(v).to(cuda)
        for v in _asp_inputs(
            B, A, C, T, seed=9, holes=kind == "holes", last_only=kind == "last_only"
        )
    )
    x, a, w = x.to(dtype), a.to(dtype), w.to(dtype)
    if kind == "bf16_mask_bias":  # as the model passes them
        b, mask = b.to(dtype), mask.to(dtype)
    if kind in ("bf16_mask_bias", "padded_rows"):
        rows = torch.empty((B, A, -(-T // 8) * 8), dtype=dtype, device=cuda)[..., :T]
        a = rows.copy_(a)
    if kind == "odd_offset":
        x, a = _at_odd_offset(x), _at_odd_offset(a)
        size = x.element_size()
        assert x.data_ptr() % (2 * size) == size and a.data_ptr() % (2 * size) == size
    counter = "float32_launches" if dtype == _F32 else "bfloat16_launches"
    before = getattr(asp_cuda.asp_pool, counter)
    mean, std = asp_cuda.asp_pool(x, a, w, b, mask)
    assert getattr(asp_cuda.asp_pool, counter) == before + 1
    want_mean, want_std = asp_cuda.asp_pool_plain(x, a, w, b, mask)
    # float32: reassociation only; bf16: one bf16 rounding step of the output
    tol = dict(mean=(1e-5, 1e-5), std=(1e-4, 1e-5)) if dtype == torch.float32 else dict(
        mean=(8e-3, 1e-4), std=(8e-3, 1e-4)
    )
    torch.testing.assert_close(mean.float(), want_mean.float(), rtol=tol["mean"][0], atol=tol["mean"][1])
    torch.testing.assert_close(std.float(), want_std.float(), rtol=tol["std"][0], atol=tol["std"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_asp_kernel_rejects_attention_above_its_limit(cuda, dtype):
    lib = asp_cuda._cuda_lib.library("asp")
    limit = lib.asp_max_attention_f32() if dtype == _F32 else lib.asp_max_attention()
    x, a, w, b, mask = (
        torch.from_numpy(v).to(cuda) for v in _asp_inputs(2, limit + 1, 128, 64, seed=3)
    )
    before = (asp_cuda.asp_pool.float32_launches, asp_cuda.asp_pool.bfloat16_launches)
    with pytest.raises(ValueError):
        asp_cuda.asp_pool(x.to(dtype), a.to(dtype), w.to(dtype), b, mask)
    assert (asp_cuda.asp_pool.float32_launches, asp_cuda.asp_pool.bfloat16_launches) == before


# the ECAPA training step's shape (32 rows of 300 frames, A 128, C 3072),
# and a small one with holes in the mask
_ASP_GRAD_CASES = [(32, 128, 3072, 300, False), (4, 16, 128, 101, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,A,C,T,holes", _ASP_GRAD_CASES)
def test_asp_backward_matches_autograd_through_plain(cuda, B, A, C, T, holes):
    """Where autograd records it, the float32 kernel launch is a node whose
    backward (``asp_pool_backward``, plain torch ops) equals autograd
    through ``asp_pool_plain`` on the same inputs: each gradient within
    1e-4 of its largest element, the bias's (0 in exact arithmetic: the
    softmax cancels it) below 1e-3 of the weight's. Under inference_mode
    the launch records nothing."""
    inputs = [torch.from_numpy(v).to(cuda) for v in _asp_inputs(B, A, C, T, seed=11, holes=holes)]
    mask = inputs.pop()
    leaves = [t.clone().requires_grad_() for t in inputs]
    before = asp_cuda.asp_pool.float32_launches
    mean, std = asp_cuda.asp_pool(*leaves, mask)
    assert asp_cuda.asp_pool.float32_launches == before + 1
    assert mean.grad_fn is not None and std.grad_fn is not None
    gen = torch.Generator(device=cuda).manual_seed(0)
    g_mean = torch.randn(mean.shape, generator=gen, device=cuda)
    g_std = torch.randn(std.shape, generator=gen, device=cuda)
    got = torch.autograd.grad((mean * g_mean + std * g_std).sum(), leaves)
    ref = [t.clone().requires_grad_() for t in inputs]
    want_mean, want_std = asp_cuda.asp_pool_plain(*ref, mask)
    want = torch.autograd.grad((want_mean * g_mean + want_std * g_std).sum(), ref)
    for name, g, h in zip(("x", "a_tanh", "w"), got[:3], want[:3]):
        torch.testing.assert_close(g, h, rtol=0, atol=1e-4 * float(h.abs().max()), msg=name)
    bound = 1e-3 * float(want[2].abs().max())
    assert float(got[3].abs().max()) <= bound and float(want[3].abs().max()) <= bound
    with torch.inference_mode():
        mean, _ = asp_cuda.asp_pool(*leaves, mask)
    assert mean.grad_fn is None and asp_cuda.asp_pool.float32_launches == before + 2


def _linkage_rows(kind, T, seed, d=192):
    """(embt (T, d), L2-normalised but "ties", tvalid (T,)) for the merge-loop kernel:
    blobs around 5 centres with 10 % of the rows invalid (tight: 0.0125 of
    noise to a centre's scale; chain: 0.3, a long run of merges whose order
    matters; cut: 0.8, the threshold cuts the tree into many flat clusters),
    one valid row, all rows identical (every distance ties), chain rows each
    repeated about four times (equal distances in several columns of a row),
    motifs where a merge ties a row's minimum at a lower column, or rows too
    far apart to merge."""
    rng = np.random.default_rng(seed)
    tvalid = np.ones(T, bool)
    noise = {"blobs": 0.05, "chain": 1.2, "cut": 3.2}
    if kind in noise:
        centres = rng.normal(size=(5, d)) * 4
        x = centres[rng.integers(0, 5, T)] + noise[kind] * rng.normal(size=(T, d))
        tvalid = rng.random(T) >= 0.1
    elif kind == "one_valid":
        x = rng.normal(size=(T, d))
        tvalid[:] = False
        tvalid[T // 3] = True
    elif kind == "identical":
        x = np.repeat(rng.normal(size=(1, d)), T, axis=0)
    elif kind == "dups":  # chain rows, each drawn from T // 4 distinct ones
        centres = rng.normal(size=(5, d)) * 4
        base = centres[rng.integers(0, 5, T // 4 + 1)] + 1.2 * rng.normal(size=(T // 4 + 1, d))
        x = base[rng.integers(0, T // 4 + 1, T)]
    elif kind == "ties":  # motifs of 4 points, 1 apart, not normalised (exact sums):
        # the pair (-1, 4), (1, 4) / 16 merges into (0, 4) / 16, as far from
        # (0, 0) as (4, 0) / 16 is, at a lower column: a tie the row's first
        # column must follow
        x = np.zeros((T, d))
        m = np.arange(T) // 4
        x[:, 0] = m + np.array([0, -1, 1, 4])[np.arange(T) % 4] / 16
        x[:, 1] = np.array([0, 4, 4, 0])[np.arange(T) % 4] / 16
        return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(tvalid)
    else:  # "apart": near-orthogonal unit rows, ~1.41 apart
        x = rng.normal(size=(T, d))
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    x[~tvalid] = 0.0
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(tvalid)


# (kind, T): the edges, the main path's size, the capped size and the largest;
# ties in several columns; T that the cluster size does not divide, and T
# below it
_LINKAGE_CASES = [
    ("one_valid", 128),
    ("identical", 128),
    ("apart", 128),
    ("blobs", 384),
    ("chain", 384),
    ("cut", 384),
    ("blobs", 1024),
    ("chain", 1024),
    ("blobs", 1536),
    ("dups", 384),
    ("ties", 384),
    ("chain", 100),
    ("blobs", 1000),
    ("blobs", 12),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T", _LINKAGE_CASES)
def test_linkage_kernel_matches_plain(cuda, kind, T):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.device import (
        initial_distances,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda

    thr = ClusteringConfig().threshold
    embt, tvalid = _linkage_rows(kind, T, seed=T)
    D0 = initial_distances(embt.to(cuda), tvalid.to(cuda))
    before = linkage_cuda.linkage_labels.launches
    got = linkage_cuda.linkage_labels(D0, embt.to(cuda), tvalid.to(cuda), thr)
    assert linkage_cuda.linkage_labels.launches == before + 1
    # the plain version on the CPU, from the same first distance matrix:
    # every later distance and centroid is rounded in the same order, so rep,
    # the steps and the merge log (each step's pair and distance) are equal
    plain = linkage_cuda.linkage_labels_plain(D0.cpu(), embt, tvalid, thr)
    for field, a, b in zip(plain._fields, got, plain):
        assert torch.equal(a.cpu(), b), field
    want, want_steps = plain.rep, int(plain.steps)
    if kind == "one_valid" or kind == "apart":
        assert want_steps == 1 and torch.equal(want, torch.arange(T, dtype=torch.int32))
    if kind == "identical":
        assert want_steps == T - 1 and len(set(want.tolist())) == 1


@pytest.mark.cuda
def test_linkage_kernel_layouts(cuda):
    """Each layout of the kernel's state against the plain loop: centroids
    and rows of D in shared memory (T = 384), centroids alone (T = 1024),
    neither (the widest rows the wrapper takes, d = 1024, at T = 1536)."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.device import (
        initial_distances,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda

    thr = ClusteringConfig().threshold
    for T, d, layout in ((384, 192, (True, True)), (1024, 192, (True, False)),
                         (linkage_cuda.MAX_ROWS, linkage_cuda.MAX_DIM, (False, False))):
        plan = linkage_cuda.linkage_plan(T, d)
        assert (plan.cent_shared, plan.d_shared) == layout
        embt, tvalid = _linkage_rows("chain", T, seed=T + d, d=d)
        D0 = initial_distances(embt.to(cuda), tvalid.to(cuda))
        got = linkage_cuda.linkage_labels(D0, embt.to(cuda), tvalid.to(cuda), thr)
        plain = linkage_cuda.linkage_labels_plain(D0.cpu(), embt, tvalid, thr)
        for field, a, b in zip(plain._fields, got, plain):
            assert torch.equal(a.cpu(), b), (T, d, field)


@pytest.mark.cuda
def test_device_cluster_on_card_matches_cpu(cuda):
    """The whole device_cluster, uncapped at 1536 rows: the card (kernel) and
    the CPU (plain loop) give the same num_large and partition."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.device import device_cluster
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig

    thr = ClusteringConfig().threshold
    rng = np.random.default_rng(3)
    centres = rng.normal(size=(5, 192)) * 4
    emb = (centres[rng.integers(0, 5, 1536)] + 0.05 * rng.normal(size=(1536, 192))).astype(np.float32)
    valid = rng.random(1536) >= 0.1
    args = [torch.from_numpy(emb), torch.from_numpy(valid), torch.from_numpy(~valid)]
    cpu = device_cluster(*args, thr, 15, 8, train_cap=None)
    card = device_cluster(*(a.to(cuda) for a in args), thr, 15, 8, train_cap=None)
    assert int(card.num_large) == int(cpu.num_large) == 5
    a, b = card.hard.cpu().numpy(), cpu.hard.numpy()
    assert np.array_equal(a < 0, b < 0)
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len({x for x, _ in pairs}) == len({y for _, y in pairs})


@pytest.mark.cuda
def test_linkage_kernel_rejects_inputs(cuda):
    """Inputs the kernel does not take raise; nothing falls back."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda

    embt, tvalid = _linkage_rows("blobs", 1600, seed=1)
    embt, tvalid = embt.to(cuda), tvalid.to(cuda)
    D0 = torch.zeros((1600, 1600), device=cuda)
    with pytest.raises(ValueError):  # more rows than the kernel holds
        linkage_cuda.linkage_labels(D0, embt, tvalid, 0.7)
    wide = torch.zeros((64, linkage_cuda.MAX_DIM + 1), device=cuda)
    with pytest.raises(ValueError):  # wider rows than the kernel holds
        linkage_cuda.linkage_labels(D0[:64, :64].contiguous(), wide, tvalid[:64], 0.7)
    with pytest.raises(ValueError):  # float64
        linkage_cuda.linkage_labels(D0[:64, :64].double(), embt[:64].double(), tvalid[:64], 0.7)
    with pytest.raises(ValueError):  # not contiguous
        linkage_cuda.linkage_labels(D0[:64, :128:2], embt[:64], tvalid[:64], 0.7)


# ---------------------------------------------------------------------------
# stage 2 as one captured CUDA graph (pipelines/stage2_graph.py) against the
# eager chain, on one pipeline and the same inputs


def _clip(seconds, seed):
    """Two tones under noise, 16-bit."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (t % 3 < 2) + 0.2 * np.sin(
        2 * np.pi * 1100.0 * t
    ) * (t % 5 > 1) + 0.05 * rng.standard_normal(t.shape)
    return (np.clip(np.round(x * 20000.0), -32768, 32767) / 32768.0).astype(np.float32)


def _graph_pipeline(dtype):
    import dataclasses

    from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import DEFAULT_CONFIG
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    if dtype == "bfloat16":
        return SpeakerDiarizationPipeline(seed=0)
    cfg = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="float32", transfer_dtype="float32")
    return SpeakerDiarizationPipeline(config=cfg, seed=0, precision="highest")


def _turns(annotation):
    return [(t.start, t.end, t.label) for t in annotation.turns()]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stage2_graph_matches_the_eager_chain(cuda, dtype):
    """Every full batch of a 59 s request replays one capture, and gives the
    embeddings and too-short flags of the eager chain on the same windows
    and masks, bit for bit; the launch counters count each replay's
    kernels once."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import windows as win
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        precision_scope,
    )

    pipe = _graph_pipeline(dtype)
    seg = pipe.config.segmentation
    S, eb = seg.num_speakers, pipe.emb_batch
    with precision_scope(pipe.precision), torch.inference_mode():
        _, padded, wav, valid_frames, valid_samples = pipe._prepare(_clip(59.0, 1))
        chunks = win.device_chunks(pipe._to_device(wav), padded, seg.window_size, seg.step_size)
        chosen = pipe._stage1(chunks, valid_frames, valid_samples)[2]
        counts = {}
        emb, too_short = pipe._stage2(chunks, chosen, counts=counts)
        before = [getattr(fn, attr) for fn, attr in _stage2_counters()]
        emb2, _ = pipe._stage2(chunks, chosen)
        launched = [getattr(fn, attr) - b for (fn, attr), b in zip(_stage2_counters(), before)]
        rows = chosen.reshape(padded * S, -1)
        index = torch.arange(rows.shape[0], device=cuda) // S
        eager = [pipe._stage2_batch(chunks[index[i : i + eb]], rows[i : i + eb])
                 for i in range(0, rows.shape[0], eb)]
    batches = len(eager)
    assert counts == {"batches": batches, "replayed": batches}
    assert pipe.stage2_graph_captures == 1
    f32 = dtype == "float32"
    assert launched == [batches, batches, 0 if f32 else batches, batches if f32 else 0]
    want = torch.cat([e[0] for e in eager]).to(emb.dtype)
    assert torch.equal(too_short, torch.cat([e[1] for e in eager]))
    assert torch.equal(emb, want) and torch.equal(emb2, want)


def _stage2_counters():
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import stage2_graph

    return stage2_graph.LAUNCH_COUNTERS


@pytest.mark.cuda
def test_stage2_graph_requests(cuda, monkeypatch):
    """Two request lengths in different chunk buckets share one capture;
    the second request dispatches under sync debug mode "error"; its
    ``dispatch.stage2`` span counts every batch replayed; the turns equal
    the eager path's; "highest" precision captures a graph of its own, and
    so does a float32 pipeline."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import stage2_graph
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        StageTimings,
        precision_scope,
    )

    pipe = _graph_pipeline("bfloat16")
    long, short = _clip(59.0, 2), _clip(28.0, 3)
    graphed = {"long": _turns(pipe(long))}
    assert pipe.stage2_graph_captures == 1
    t = StageTimings()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipe._dispatch(short, timings=t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graphed["short"] = _turns(pipe._collect(pending, timings=t))
    counts = {s.name: s.counters for s in t.spans}["dispatch.stage2"]
    batches = pending["num_padded"] * pipe.config.segmentation.num_speakers // pipe.emb_batch
    assert counts == {"batches": batches, "replayed": batches}
    assert pipe.stage2_graph_captures == 1
    assert pending["num_padded"] != pipe._prepare(long)[1]
    with precision_scope("highest"):
        pipe(short)
    assert pipe.stage2_graph_captures == 2
    monkeypatch.setattr(stage2_graph, "engages", lambda *args: False)
    assert graphed == {"long": _turns(pipe(long)), "short": _turns(pipe(short))}
    assert pipe.stage2_graph_captures == 2
    monkeypatch.undo()
    float32 = _graph_pipeline("float32")
    assert _turns(float32(short)) == _turns(float32(short))
    assert float32.stage2_graph_captures == 1
