"""PyanNet segmentation model (pyannote/segmentation@2022.07 topology).

The model behind the reference's ``segment2.onnx`` (exported by reference
segment/export2.py:16-53): SincNet front-end (learnable band-pass sinc
filters, stride 10) + 4-layer bidirectional LSTM (hidden 128) + two 128-d
linear layers + 3-class sigmoid head. A 5 s / 80000-sample window maps to
293 output frames of 270 samples (0.016875 s), the frame grid hard-coded at
reference pipeline/src/speakerDiarizer.cpp:2430-2432.

``valid_samples`` reproduces true-length inference of a short (orphan)
chunk inside a padded batch: instance-norm statistics over the valid prefix
and a reverse LSTM that starts at the true end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L


@dataclasses.dataclass(frozen=True)
class PyanNetConfig:
    sample_rate: int = 16000
    num_filters: int = 80
    kernel_size: int = 251
    stride: int = 10
    min_low_hz: float = 50.0
    min_band_hz: float = 50.0
    conv_channels: int = 60
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_hidden: int = 128
    linear_layers: int = 2
    num_classes: int = 3
    leaky_slope: float = 0.01


def pyannet_num_frames(num_samples: int, cfg: PyanNetConfig = PyanNetConfig()) -> int:
    """Output frame count for an input of ``num_samples`` samples.

    Mirrors the conv/pool arithmetic chain (sinc k251 s10 -> pool3 ->
    conv5 -> pool3 -> conv5 -> pool3): 80000 -> 293.
    """
    n = (num_samples - cfg.kernel_size) // cfg.stride + 1
    n = (n - 3) // 3 + 1
    n = n - 4
    n = (n - 3) // 3 + 1
    n = n - 4
    n = (n - 3) // 3 + 1
    return n


def pyannet_valid_chain(valid_samples, cfg: PyanNetConfig = PyanNetConfig()):
    """Per-stage valid element counts for a (possibly padded) input of
    ``valid_samples`` real samples (integer tensor or array). Every
    convolution/pool in SincNet is VALID-mode with floor counts, so an output
    element below the stage's valid count depends only on real samples;
    padding can only reach the instance-norm statistics and the reverse LSTM,
    both of which take these counts as masks."""
    v = valid_samples
    v1 = ((v - cfg.kernel_size) // cfg.stride + 1).clip(min=0)
    v2 = ((v1 - 3) // 3 + 1).clip(min=0)
    v3 = (v2 - 4).clip(min=0)
    v4 = ((v3 - 3) // 3 + 1).clip(min=0)
    v5 = (v4 - 4).clip(min=0)
    v6 = ((v5 - 3) // 3 + 1).clip(min=0)
    return v1, v2, v3, v4, v5, v6


class SincFilters(nn.Module):
    """Learnable band edges of the SincNet filterbank."""

    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        self.cfg = cfg
        # mel-spaced initial band edges, classic SincNet parameterization
        # (Ravanelli & Bengio, "Speaker Recognition from Raw Waveform with
        # SincNet"; the filterbank behind pyannote's SincNet block)
        low_hz = 30.0
        high_hz = cfg.sample_rate / 2 - (cfg.min_low_hz + cfg.min_band_hz)
        mel = np.linspace(
            2595 * np.log10(1 + low_hz / 700),
            2595 * np.log10(1 + high_hz / 700),
            cfg.num_filters + 1,
        )
        hz = 700 * (10 ** (mel / 2595) - 1)
        self.low_hz = nn.Parameter(torch.tensor(hz[:-1, None], dtype=torch.float32))
        self.band_hz = nn.Parameter(
            torch.tensor(np.diff(hz)[:, None], dtype=torch.float32)
        )

    def forward(self) -> torch.Tensor:
        """(num_filters, 1, kernel_size) band-pass filters.

        Classic SincNet construction: bandpass = (sin(2pi f_hi n) -
        sin(2pi f_lo n)) / (n/2), hamming-windowed, center sample = 2*band,
        normalized by 2*band.
        """
        cfg = self.cfg
        dev = self.low_hz.device
        low = cfg.min_low_hz + torch.abs(self.low_hz)
        high = torch.clamp(
            low + cfg.min_band_hz + torch.abs(self.band_hz),
            cfg.min_low_hz,
            cfg.sample_rate / 2,
        )
        band = (high - low)[:, 0]
        half = (cfg.kernel_size - 1) // 2
        n_ = (
            2 * np.pi * torch.arange(-half, 0, device=dev, dtype=torch.float32)[None, :]
            / cfg.sample_rate
        )
        # SincNet's window spacing is linspace(0, k/2 - 1, half): converted
        # checkpoints depend on these exact taps
        n_lin = torch.linspace(0.0, cfg.kernel_size / 2 - 1, half, device=dev)
        window = 0.54 - 0.46 * torch.cos(2 * np.pi * n_lin / cfg.kernel_size)
        bp_left = (
            (torch.sin(high * n_) - torch.sin(low * n_)) / (n_ / 2)
        ) * window[None, :]
        bp = torch.cat(
            [bp_left, 2 * band[:, None], torch.flip(bp_left, dims=[1])], dim=1
        )
        return (bp / (2 * band[:, None]))[:, None, :]


class SincNet(nn.Module):
    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        self.cfg = cfg
        self.wav_norm = L.InstanceNorm(1)
        self.sinc = SincFilters(cfg)
        self.norm0 = L.InstanceNorm(cfg.num_filters)
        self.conv1 = nn.Conv1d(cfg.num_filters, cfg.conv_channels, 5)
        self.norm1 = L.InstanceNorm(cfg.conv_channels)
        self.conv2 = nn.Conv1d(cfg.conv_channels, cfg.conv_channels, 5)
        self.norm2 = L.InstanceNorm(cfg.conv_channels)

    def forward(
        self, x: torch.Tensor, valid_samples: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, num_samples) waveforms -> (B, conv_channels, frames).

        InstanceNorm -> sinc conv (stride 10) -> |.| -> pool3 -> IN -> leaky
        -> conv5 -> pool3 -> IN -> leaky -> conv5 -> pool3 -> IN -> leaky
        (pyannote.audio SincNet). ``valid_samples``: optional (B,) true
        lengths; instance-norm statistics then run over each stage's valid
        prefix.
        """
        cfg = self.cfg
        v_wav = v_norm0 = v_norm1 = v_norm2 = None
        if valid_samples is not None:
            _, v2, _, v4, _, v6 = pyannet_valid_chain(valid_samples, cfg)
            v_wav, v_norm0, v_norm1, v_norm2 = valid_samples, v2, v4, v6
        out = self.wav_norm(x[:, None, :], v_wav)
        out = F.conv1d(out, self.sinc(), stride=cfg.stride)
        out = F.max_pool1d(torch.abs(out), 3, 3)
        out = F.leaky_relu(self.norm0(out, v_norm0), cfg.leaky_slope)
        out = F.max_pool1d(self.conv1(out), 3, 3)
        out = F.leaky_relu(self.norm1(out, v_norm1), cfg.leaky_slope)
        out = F.max_pool1d(self.conv2(out), 3, 3)
        return F.leaky_relu(self.norm2(out, v_norm2), cfg.leaky_slope)


class PyanNet(nn.Module):
    """SincNet + BiLSTM stack + linear layers + sigmoid classifier.

    Submodule and parameter names follow the JAX package's pytree, with
    each BiLSTM layer an ``nn.LSTM(bidirectional=True)`` (models/convert.py
    params_from_jax maps the names)."""

    def __init__(
        self,
        cfg: PyanNetConfig = PyanNetConfig(),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.sincnet = SincNet(cfg)
        self.lstm = nn.ModuleList()
        in_size = cfg.conv_channels
        for _ in range(cfg.lstm_layers):
            self.lstm.append(
                nn.LSTM(in_size, cfg.lstm_hidden, batch_first=True, bidirectional=True)
            )
            in_size = 2 * cfg.lstm_hidden
        self.linear = nn.ModuleList()
        lin_in = 2 * cfg.lstm_hidden
        for _ in range(cfg.linear_layers):
            self.linear.append(nn.Linear(lin_in, cfg.linear_hidden))
            lin_in = cfg.linear_hidden
        self.classifier = nn.Linear(cfg.linear_hidden, cfg.num_classes)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init mirroring the JAX package's init_pyannet: torch
        default bounds for the LSTM/linear/conv weights, unit instance
        norms and mel-spaced sinc bands."""
        for lstm in self.lstm:
            L.init_lstm_(lstm, generator)
        for lin in self.linear:
            L.init_linear_(lin, generator)
        L.init_conv_(self.sincnet.conv1, generator)
        L.init_conv_(self.sincnet.conv2, generator)
        L.init_linear_(self.classifier, generator)

    def head_forward(
        self, feat: torch.Tensor, valid_frames: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """SincNet features (B, channels, frames) -> (B, frames, classes).
        ``valid_frames``: optional (B,) host tensor of real frames per row."""
        out = L.bilstm_stack(feat.transpose(1, 2), self.lstm, valid_frames)
        for lin in self.linear:
            out = F.leaky_relu(lin(out), self.cfg.leaky_slope)
        return torch.sigmoid(self.classifier(out))

    def forward(
        self, waveforms: torch.Tensor, valid_samples: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, num_samples) -> (B, frames, num_classes) sigmoid activations.

        ``valid_samples``: optional (B,) host integer tensor of true lengths;
        a zero-padded short chunk then scores like true-length inference
        (segment/segment.py:103-108) on its valid frames.
        """
        vs_dev = (
            None
            if valid_samples is None
            else L.host_to_device(valid_samples.cpu(), waveforms.device)
        )
        feat = self.sincnet(waveforms, vs_dev)
        valid_frames = None
        if valid_samples is not None:
            valid_frames = pyannet_valid_chain(valid_samples.cpu(), self.cfg)[5]
        return self.head_forward(feat, valid_frames)
