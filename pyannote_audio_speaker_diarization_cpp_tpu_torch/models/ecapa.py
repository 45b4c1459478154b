"""ECAPA-TDNN speaker-embedding model (speechbrain topology), in PyTorch.

The model behind the reference's ``emd4.onnx`` (exported from
speechbrain/spkrec-ecapa-voxceleb by reference embeddings/export3.py:560-627;
architecture at embeddings/ECAPA-TDNN.py:7-142). Defaults mirror the
speechbrain VoxCeleb recipe: channels 1024, res2net scale 8, SE 128,
attentive-stats pooling with global context, 192-d embedding. ``lengths``
(relative, per row) reproduces speechbrain's masking everywhere it is used:
SE mean, ASP statistics and attention softmax.

All convolutions are stride-1 "same" with reflect padding (speechbrain
Conv1d default); BatchNorm runs in inference mode off running statistics.
The attentive-statistics tail runs as the fused kernel of ops/asp_cuda.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.asp_cuda import asp_pool
from . import layers as L


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    in_channels: int = 80
    channels: Sequence[int] = (1024, 1024, 1024, 1024, 3072)
    kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1)
    dilations: Sequence[int] = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = True
    emb_dim: int = 192
    eps: float = 1e-12  # ASP statistics clamp


class TDNNBlock(nn.Module):
    """Conv -> ReLU -> BatchNorm (speechbrain TDNNBlock order)."""

    def __init__(self, in_c: int, out_c: int, kernel: int, dilation: int = 1):
        super().__init__()
        self.conv = L.conv1d_same(in_c, out_c, kernel, dilation)
        self.bn = nn.BatchNorm1d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(F.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """speechbrain Res2NetBlock ordering: split 0 passes through unchanged,
    block j-1 processes split j (accumulating the previous block's OUTPUT
    from split 2 on): y0 = x0; y1 = b0(x1); yi = b_{i-1}(x_i + y_{i-1})."""

    def __init__(self, channels: int, kernel: int, dilation: int, scale: int):
        super().__init__()
        width = channels // scale
        self.scale = scale
        self.blocks = nn.ModuleList(
            TDNNBlock(width, width, kernel, dilation) for _ in range(scale - 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = torch.chunk(x, self.scale, dim=1)
        outs = [parts[0]]
        y = None
        for i in range(1, self.scale):
            y = self.blocks[i - 1](parts[i] if i == 1 else parts[i] + y)
            outs.append(y)
        return torch.cat(outs, dim=1)


class SEBlock(nn.Module):
    """Squeeze-excitation with masked temporal mean (speechbrain SEBlock)."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv1 = nn.Conv1d(channels, se_channels, 1)
        self.conv2 = nn.Conv1d(se_channels, channels, 1)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        if lengths is None:
            s = x.mean(dim=-1, keepdim=True)
        else:
            mask = L.length_mask(lengths, x.shape[-1], x.dtype)[:, None, :]
            s = (x * mask).sum(dim=-1, keepdim=True) / mask.sum(dim=-1, keepdim=True)
        s = torch.sigmoid(self.conv2(F.relu(self.conv1(s))))
        return x * s


class SERes2NetBlock(nn.Module):
    def __init__(self, cfg: EcapaConfig, idx: int):
        super().__init__()
        c = cfg.channels[idx]
        self.tdnn1 = TDNNBlock(cfg.channels[idx - 1], c, 1)
        self.res2net = Res2NetBlock(
            c, cfg.kernel_sizes[idx], cfg.dilations[idx], cfg.res2net_scale
        )
        self.tdnn2 = TDNNBlock(c, c, 1)
        self.se = SEBlock(c, cfg.se_channels)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        out = self.tdnn2(self.res2net(self.tdnn1(x)))
        return self.se(out, lengths) + x


def masked_stats(x: torch.Tensor, m: torch.Tensor, eps: float):
    """Weighted mean/std over time; ``m`` sums to 1 along time. One pass:
    E[x^2] - E[x]^2, clamped at 0, then at eps under the square root."""
    mean = (m * x).sum(dim=2)
    sq = (m * x * x).sum(dim=2)
    var = torch.clamp(sq - mean * mean, min=0.0)
    return mean, torch.sqrt(torch.clamp(var, min=eps))


class AttentiveStatsPool(nn.Module):
    """(B, C, T) -> (B, 2C) attentive statistics pooling with global context
    and length masking (speechbrain AttentiveStatisticsPooling).

    speechbrain concatenates [x, mean, std] along channels and runs a 1x1
    conv over a (B, 3C, T) tensor. Because the conv is 1x1 and mean/std are
    constant in time, the same result is W_x x plus a per-sequence bias
    (W_m mean + W_s std): the concat never exists. The A -> C expansion,
    masked softmax and weighted statistics then run fused (ops/asp_cuda.py)."""

    def __init__(self, cfg: EcapaConfig):
        super().__init__()
        c = cfg.channels[-1]
        self.cfg = cfg
        self.tdnn = TDNNBlock(c * 3 if cfg.global_context else c, cfg.attention_channels, 1)
        self.conv = nn.Conv1d(cfg.attention_channels, c, 1)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        B, C, T = x.shape
        if lengths is None:
            lengths = torch.ones((B,), device=x.device)
        mask = L.length_mask(lengths, T, x.dtype)  # (B, T)
        if self.cfg.global_context:
            m3 = mask[:, None, :]
            mean, std = masked_stats(x, m3 / m3.sum(dim=2, keepdim=True), self.cfg.eps)
            w = self.tdnn.conv.weight  # (A, 3C, 1)
            pre = F.conv1d(x, w[:, :C], self.tdnn.conv.bias)
            const = mean @ w[:, C : 2 * C, 0].T + std @ w[:, 2 * C :, 0].T
            attn = self.tdnn.bn(F.relu(pre + const[..., None]))
        else:
            attn = self.tdnn(x)
        mean, std = asp_pool(
            x.contiguous(),
            torch.tanh(attn).contiguous(),
            self.conv.weight[:, :, 0],
            self.conv.bias,
            mask,
            eps=self.cfg.eps,
        )
        return torch.cat([mean, std], dim=1)


class EcapaTDNN(nn.Module):
    """(B, T, n_mels) features, (B,) relative lengths -> (B, emb_dim).

    Mirrors speechbrain ECAPA_TDNN.forward as exported to emd4.onnx
    (reference embeddings/export3.py:560-627): transpose to channels-first,
    block chain with skip-cat of blocks 1-3, MFA, ASP, BN, fc. Submodule and
    parameter names follow the JAX package's pytree."""

    def __init__(
        self,
        cfg: EcapaConfig = EcapaConfig(),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.block0 = TDNNBlock(cfg.in_channels, ch[0], cfg.kernel_sizes[0], cfg.dilations[0])
        self.block1 = SERes2NetBlock(cfg, 1)
        self.block2 = SERes2NetBlock(cfg, 2)
        self.block3 = SERes2NetBlock(cfg, 3)
        self.mfa = TDNNBlock(sum(ch[1:4]), ch[-1], cfg.kernel_sizes[-1], cfg.dilations[-1])
        self.asp = AttentiveStatsPool(cfg)
        self.asp_bn = nn.BatchNorm1d(ch[-1] * 2)
        self.fc = nn.Conv1d(ch[-1] * 2, cfg.emb_dim, 1)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init mirroring the JAX package's init_ecapa: torch default
        bounds for every conv, identity batch norms."""
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                L.init_conv_(m, generator)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()

    def forward(
        self, feats: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = feats.transpose(1, 2)  # (B, n_mels, T)
        x0 = self.block0(x)
        x1 = self.block1(x0, lengths)
        x2 = self.block2(x1, lengths)
        x3 = self.block3(x2, lengths)
        x = self.mfa(torch.cat([x1, x2, x3], dim=1))
        pooled = self.asp_bn(self.asp(x, lengths))
        return self.fc(pooled[..., None])[..., 0]
