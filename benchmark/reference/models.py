"""Plain float32 forward passes of the two models of the pyannote v2.1 recipe.

PyanNet (pyannote/segmentation@2022.07): SincNet (instance norm, 80
band-pass sinc filters of 251 taps at stride 10, |.|, three max-pools, two
5-tap convolutions, affine instance norms, leaky ReLU), four bidirectional
LSTM layers of 128, two linear layers of 128 and a sigmoid head.

ECAPA-TDNN (speechbrain/spkrec-ecapa-voxceleb): C = 1024, res2net scale 8,
SE 128, attentive statistics pooling with global context over the 3072-wide
MFA output, 192-d embedding. Every convolution is stride 1 with "same"
reflect padding, batch norm in inference mode.

Written from the published descriptions with plain ``torch`` operations:
no kernel, batching trick or packing plan of the program under test. A
parameter tree is a flat ``{dotted name: tensor}`` dict; ``TREE`` lists each
leaf's shape and how the benchmark draws it.

``quant``: an optional function applied to the inputs and weights of every
product (the control computes in a lower precision through it).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


# ---------------------------------------------------------------------------
# parameter trees: (name, shape, kind) with kind one of
#   ("uniform", bound) | ("ones",) | ("zeros",) | ("sinc_low",) | ("sinc_band",)
# ---------------------------------------------------------------------------


def pyannet_tree(c: Dict) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    nf, ch, hid = c["num_filters"], c["conv_channels"], c["lstm_hidden"]
    leaves = [
        ("sincnet.wav_norm.weight", (1,), ("ones",)),
        ("sincnet.wav_norm.bias", (1,), ("zeros",)),
        ("sincnet.sinc.low_hz", (nf, 1), ("sinc_low",)),
        ("sincnet.sinc.band_hz", (nf, 1), ("sinc_band",)),
    ]
    for i, (cin, cout) in enumerate(((None, nf), (nf, ch), (ch, ch))):
        if cin is not None:
            b = 1.0 / math.sqrt(cin * 5)
            leaves += [
                (f"sincnet.conv{i}.weight", (cout, cin, 5), ("uniform", b)),
                (f"sincnet.conv{i}.bias", (cout,), ("uniform", b)),
            ]
        leaves += [
            (f"sincnet.norm{i}.weight", (cout,), ("ones",)),
            (f"sincnet.norm{i}.bias", (cout,), ("zeros",)),
        ]
    in_size = ch
    b = 1.0 / math.sqrt(hid)
    for i in range(c["lstm_layers"]):
        for d in ("fwd", "bwd"):
            leaves += [
                (f"lstm.{i}.{d}.weight_ih", (4 * hid, in_size), ("uniform", b)),
                (f"lstm.{i}.{d}.weight_hh", (4 * hid, hid), ("uniform", b)),
                (f"lstm.{i}.{d}.bias_ih", (4 * hid,), ("uniform", b)),
                (f"lstm.{i}.{d}.bias_hh", (4 * hid,), ("uniform", b)),
            ]
        in_size = 2 * hid
    lin_in = 2 * hid
    for i in range(c["linear_layers"]):
        b = 1.0 / math.sqrt(lin_in)
        leaves += [
            (f"linear.{i}.weight", (c["linear_hidden"], lin_in), ("uniform", b)),
            (f"linear.{i}.bias", (c["linear_hidden"],), ("uniform", b)),
        ]
        lin_in = c["linear_hidden"]
    b = 1.0 / math.sqrt(lin_in)
    leaves += [
        ("classifier.weight", (c["num_classes"], lin_in), ("uniform", b)),
        ("classifier.bias", (c["num_classes"],), ("uniform", b)),
    ]
    return leaves


def _conv_leaves(name, cout, cin, k):
    b = 1.0 / math.sqrt(cin * k)
    return [
        (f"{name}.weight", (cout, cin, k), ("uniform", b)),
        (f"{name}.bias", (cout,), ("uniform", b)),
    ]


def _bn_leaves(name, c):
    return [
        (f"{name}.weight", (c,), ("ones",)),
        (f"{name}.bias", (c,), ("zeros",)),
        (f"{name}.running_mean", (c,), ("zeros",)),
        (f"{name}.running_var", (c,), ("ones",)),
    ]


def _tdnn_leaves(name, cin, cout, k):
    return _conv_leaves(f"{name}.conv", cout, cin, k) + _bn_leaves(f"{name}.bn", cout)


def ecapa_tree(c: Dict) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    ch, ks = c["channels"], c["kernel_sizes"]
    leaves = _tdnn_leaves("block0", c["in_channels"], ch[0], ks[0])
    width = ch[1] // c["res2net_scale"]
    for i in (1, 2, 3):
        leaves += _tdnn_leaves(f"block{i}.tdnn1", ch[i - 1], ch[i], 1)
        for j in range(c["res2net_scale"] - 1):
            leaves += _tdnn_leaves(f"block{i}.res2net.blocks.{j}", width, width, ks[i])
        leaves += _tdnn_leaves(f"block{i}.tdnn2", ch[i], ch[i], 1)
        leaves += _conv_leaves(f"block{i}.se.conv1", c["se_channels"], ch[i], 1)
        leaves += _conv_leaves(f"block{i}.se.conv2", ch[i], c["se_channels"], 1)
    leaves += _tdnn_leaves("mfa", sum(ch[1:4]), ch[-1], ks[-1])
    leaves += _tdnn_leaves("asp.tdnn", 3 * ch[-1], c["attention_channels"], 1)
    leaves += _conv_leaves("asp.conv", ch[-1], c["attention_channels"], 1)
    leaves += _bn_leaves("asp_bn", 2 * ch[-1])
    leaves += _conv_leaves("fc", c["emb_dim"], 2 * ch[-1], 1)
    return leaves


def sinc_init(c: Dict, sample_rate: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mel-spaced initial band edges (low_hz, band_hz), each (num_filters, 1):
    the SincNet initialisation (Ravanelli & Bengio, 2018)."""
    low, high = 30.0, sample_rate / 2 - (c["min_low_hz"] + c["min_band_hz"])
    mel = np.linspace(2595 * np.log10(1 + low / 700), 2595 * np.log10(1 + high / 700),
                      c["num_filters"] + 1)
    hz = 700 * (10 ** (mel / 2595) - 1)
    return hz[:-1, None], np.diff(hz)[:, None]


# ---------------------------------------------------------------------------
# PyanNet
# ---------------------------------------------------------------------------


def sinc_filters(p: Dict, c: Dict, sample_rate: int) -> torch.Tensor:
    """(num_filters, 1, kernel_size) band-pass filters from the band edges:
    (sin(2 pi f_hi n) - sin(2 pi f_lo n)) / (n / 2), Hamming-windowed, centre
    tap 2 band, divided by 2 band (SincNet's construction, with its window
    spacing linspace(0, k/2 - 1, k // 2))."""
    k = c["kernel_size"]
    low = c["min_low_hz"] + p["sincnet.sinc.low_hz"].abs()
    high = torch.clamp(low + c["min_band_hz"] + p["sincnet.sinc.band_hz"].abs(),
                       c["min_low_hz"], sample_rate / 2)
    band = (high - low)[:, 0]
    half = (k - 1) // 2
    dev = low.device
    n = 2 * math.pi * torch.arange(-half, 0, device=dev, dtype=torch.float32)[None, :] / sample_rate
    window = 0.54 - 0.46 * torch.cos(
        2 * math.pi * torch.linspace(0.0, k / 2 - 1, half, device=dev) / k)
    left = (torch.sin(high * n) - torch.sin(low * n)) / (n / 2) * window[None, :]
    bp = torch.cat([left, 2 * band[:, None], left.flip(1)], dim=1)
    return (bp / (2 * band[:, None]))[:, None, :]


def _instance_norm(x, w, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[None, :, None] + b[None, :, None]


def _lstm_layer(x: torch.Tensor, p: Dict, prefix: str, quant: Quant) -> torch.Tensor:
    """One bidirectional LSTM layer over (B, T, I) rows of one length."""
    hid = p[f"{prefix}.fwd.weight_hh"].shape[1]
    lstm = torch.nn.LSTM(x.shape[-1], hid, batch_first=True, bidirectional=True)
    lstm = lstm.to(x.device)
    with torch.no_grad():
        for d, tag in (("fwd", ""), ("bwd", "_reverse")):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(lstm, f"{name}_l0{tag}").copy_(_q(quant, p[f"{prefix}.{d}.{name}"]))
    out, _ = lstm(_q(quant, x))
    return out


def pyannet_forward(
    x: torch.Tensor, p: Dict, c: Dict, sample_rate: int, quant: Quant = None
) -> torch.Tensor:
    """(B, N) waveforms, all of one true length N -> (B, frames, classes)."""
    slope = c["leaky_slope"]
    out = _instance_norm(x[:, None, :], p["sincnet.wav_norm.weight"], p["sincnet.wav_norm.bias"])
    filt = sinc_filters(p, c, sample_rate)
    out = F.conv1d(_q(quant, out), _q(quant, filt), stride=c["stride"])
    out = F.max_pool1d(out.abs(), 3, 3)
    out = F.leaky_relu(_instance_norm(out, p["sincnet.norm0.weight"], p["sincnet.norm0.bias"]), slope)
    for i in (1, 2):
        out = F.conv1d(_q(quant, out), _q(quant, p[f"sincnet.conv{i}.weight"]),
                       p[f"sincnet.conv{i}.bias"])
        out = F.max_pool1d(out, 3, 3)
        out = F.leaky_relu(
            _instance_norm(out, p[f"sincnet.norm{i}.weight"], p[f"sincnet.norm{i}.bias"]), slope)
    out = out.transpose(1, 2)
    for i in range(c["lstm_layers"]):
        out = _lstm_layer(out, p, f"lstm.{i}", quant)
    for i in range(c["linear_layers"]):
        out = F.leaky_relu(F.linear(_q(quant, out), _q(quant, p[f"linear.{i}.weight"]),
                                    p[f"linear.{i}.bias"]), slope)
    return torch.sigmoid(F.linear(_q(quant, out), _q(quant, p["classifier.weight"]),
                                  p["classifier.bias"]))


# ---------------------------------------------------------------------------
# ECAPA-TDNN
# ---------------------------------------------------------------------------


def _conv_same(x, p, name, dilation=1, quant: Quant = None):
    w = p[f"{name}.weight"]
    pad = (w.shape[-1] - 1) * dilation // 2
    if pad:
        x = F.pad(x, (pad, pad), mode="reflect")
    return F.conv1d(_q(quant, x), _q(quant, w), p[f"{name}.bias"], dilation=dilation)


def _bn(x, p, name, eps=1e-5):
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, eps)


def _tdnn(x, p, name, dilation=1, quant: Quant = None):
    return _bn(F.relu(_conv_same(x, p, f"{name}.conv", dilation, quant)), p, f"{name}.bn")


def _length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """speechbrain length_to_mask of relative lengths: frame t is valid iff
    t < rel * T."""
    return (torch.arange(T, device=lengths.device)[None, :] < (lengths * T)[:, None]).float()


def _stats(x, m, eps):
    """speechbrain _compute_statistics: weighted mean and std over time."""
    mean = (m * x).sum(dim=2)
    std = torch.sqrt(((m * (x - mean[:, :, None]) ** 2).sum(dim=2)).clamp(min=eps))
    return mean, std


def ecapa_forward(
    feats: torch.Tensor, lengths: torch.Tensor, p: Dict, c: Dict, quant: Quant = None
) -> torch.Tensor:
    """(B, T, n_mels) features, (B,) relative lengths -> (B, emb_dim)."""
    x = feats.transpose(1, 2)
    T = x.shape[-1]
    mask = _length_mask(lengths, T)[:, None, :]
    x = _tdnn(x, p, "block0", c["dilations"][0], quant)
    outs = []
    scale = c["res2net_scale"]
    for i in (1, 2, 3):
        pre = f"block{i}"
        h = _tdnn(x, p, f"{pre}.tdnn1", 1, quant)
        parts = torch.chunk(h, scale, dim=1)
        ys, y = [parts[0]], None
        for j in range(1, scale):
            y = _tdnn(parts[j] if j == 1 else parts[j] + y, p, f"{pre}.res2net.blocks.{j - 1}",
                      c["dilations"][i], quant)
            ys.append(y)
        h = _tdnn(torch.cat(ys, dim=1), p, f"{pre}.tdnn2", 1, quant)
        s = (h * mask).sum(dim=2, keepdim=True) / mask.sum(dim=2, keepdim=True)
        s = F.relu(_conv_same(s, p, f"{pre}.se.conv1", 1, quant))
        s = torch.sigmoid(_conv_same(s, p, f"{pre}.se.conv2", 1, quant))
        x = h * s + x
        outs.append(x)
    x = _tdnn(torch.cat(outs, dim=1), p, "mfa", 1, quant)
    # attentive statistics pooling with global context
    w = mask / mask.sum(dim=2, keepdim=True)
    mean, std = _stats(x, w, c["eps"])
    ctx = torch.cat([x, mean[:, :, None].expand(-1, -1, T), std[:, :, None].expand(-1, -1, T)], 1)
    attn = torch.tanh(_tdnn(ctx, p, "asp.tdnn", 1, quant))
    attn = _conv_same(attn, p, "asp.conv", 1, quant)
    attn = attn.masked_fill(mask == 0, float("-inf"))
    attn = torch.softmax(attn, dim=2)
    mean, std = _stats(x, attn, c["eps"])
    pooled = _bn(torch.cat([mean, std], dim=1), p, "asp_bn")
    return F.linear(_q(quant, pooled), _q(quant, p["fc.weight"][:, :, 0]), p["fc.bias"])
