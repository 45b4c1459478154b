"""Analytic FLOP counts for the two models (MFU reporting).

2 * output_positions * fan_in multiply-adds per conv/matmul, the standard
convention, counted from the architecture; elementwise and normalization
flops are ignored (<1%). The counts are the JAX package's utils/flops.py,
number for number, so an H100 MFU and a TPU MFU count the same work.

Reference for the architectures: SURVEY.md section 2.2 P9 (ECAPA,
reference embeddings/ECAPA-TDNN.py:7-142) and the pyannote SincNet+LSTM
topology (reference segment/export2.py:16-53).
"""

from __future__ import annotations

from ..models.ecapa import EcapaConfig
from ..models.pyannet import PyanNetConfig, pyannet_num_frames


def _conv1d_flops(out_t: int, in_c: int, out_c: int, k: int) -> float:
    return 2.0 * out_t * in_c * out_c * k


def pyannet_flops(num_samples: int, cfg: PyanNetConfig = PyanNetConfig()) -> float:
    """FLOPs of one PyanNet forward on a ``num_samples`` window."""
    t1 = (num_samples - cfg.kernel_size) // cfg.stride + 1
    f = _conv1d_flops(t1, 1, cfg.num_filters, cfg.kernel_size)
    t2 = (t1 - 3) // 3 + 1
    t3 = t2 - 4
    f += _conv1d_flops(t3, cfg.num_filters, cfg.conv_channels, 5)
    t4 = (t3 - 3) // 3 + 1
    t5 = t4 - 4
    f += _conv1d_flops(t5, cfg.conv_channels, cfg.conv_channels, 5)
    frames = pyannet_num_frames(num_samples, cfg)
    # bidirectional LSTM stack: per step/direction 2*(in+hidden)*4*hidden
    in_size = cfg.conv_channels
    for _ in range(cfg.lstm_layers):
        f += 2 * frames * 2.0 * (in_size + cfg.lstm_hidden) * 4 * cfg.lstm_hidden
        in_size = 2 * cfg.lstm_hidden
    lin_in = 2 * cfg.lstm_hidden
    for _ in range(cfg.linear_layers):
        f += 2.0 * frames * lin_in * cfg.linear_hidden
        lin_in = cfg.linear_hidden
    f += 2.0 * frames * lin_in * cfg.num_classes
    return f


def ecapa_flops(num_frames: int, cfg: EcapaConfig = EcapaConfig()) -> float:
    """FLOPs of one ECAPA-TDNN forward on ``num_frames`` feature frames."""
    ch = cfg.channels
    t = num_frames
    f = _conv1d_flops(t, cfg.in_channels, ch[0], cfg.kernel_sizes[0])
    width = ch[1] // cfg.res2net_scale
    for i in (1, 2, 3):
        f += _conv1d_flops(t, ch[i - 1], ch[i], 1)  # tdnn1
        f += (cfg.res2net_scale - 1) * _conv1d_flops(t, width, width, cfg.kernel_sizes[i])
        f += _conv1d_flops(t, ch[i], ch[i], 1)  # tdnn2
        f += _conv1d_flops(1, ch[i], cfg.se_channels, 1)  # SE (pooled, T=1)
        f += _conv1d_flops(1, cfg.se_channels, ch[i], 1)
    cat = sum(ch[1:4])
    f += _conv1d_flops(t, cat, ch[-1], cfg.kernel_sizes[-1])  # mfa
    # ASP attention: x-part of the (split) tdnn + the expansion conv
    f += _conv1d_flops(t, ch[-1], cfg.attention_channels, 1)
    if cfg.global_context:
        f += 2 * _conv1d_flops(1, ch[-1], cfg.attention_channels, 1)
    f += _conv1d_flops(t, cfg.attention_channels, ch[-1], 1)
    f += _conv1d_flops(1, ch[-1] * 2, cfg.emb_dim, 1)  # fc
    return f
