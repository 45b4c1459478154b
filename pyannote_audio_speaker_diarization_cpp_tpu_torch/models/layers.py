"""Layer primitives shared by PyanNet and ECAPA-TDNN, in PyTorch.

Conventions match the JAX package's parameter pytrees (which already use
torch's): conv weights are (out, in, k), linear weights (out, in), LSTM gates
ordered i,f,g,o. What torch does not ship is here: "same" convolutions with
reflect padding (speechbrain's Conv1d default), instance norm over a valid
prefix of each row, speechbrain's relative-length mask, and a BiLSTM stack
whose reverse direction starts at each row's true end.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


# ---------------------------------------------------------------------------
# seeded initializers (torch's default bounds; explicit generator)
# ---------------------------------------------------------------------------


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(
            (torch.rand(t.shape, generator=generator, dtype=torch.float32) * 2 - 1)
            * bound
        )


def init_conv_(conv: nn.Conv1d, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(conv.in_channels * conv.kernel_size[0])
    uniform_(conv.weight, bound, generator)
    if conv.bias is not None:
        uniform_(conv.bias, bound, generator)


def init_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(lin.in_features)
    uniform_(lin.weight, bound, generator)
    if lin.bias is not None:
        uniform_(lin.bias, bound, generator)


def init_lstm_(lstm: nn.LSTM, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(lstm.hidden_size)
    for p in lstm.parameters():
        uniform_(p, bound, generator)


# ---------------------------------------------------------------------------
# modules and functions
# ---------------------------------------------------------------------------


def conv1d_same(
    in_channels: int, out_channels: int, kernel_size: int, dilation: int = 1
) -> nn.Conv1d:
    """Stride-1 Conv1d with speechbrain's "same" reflect padding:
    (k-1)*d/2 reflected samples per side."""
    pad = (kernel_size - 1) * dilation // 2
    return nn.Conv1d(
        in_channels,
        out_channels,
        kernel_size,
        dilation=dilation,
        padding=pad,
        padding_mode="reflect" if pad else "zeros",
    )


def instancenorm1d(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, C, T) instance norm over T, optionally affine.

    ``valid``: optional (B,) count of real timesteps per row — statistics run
    over the valid prefix only, which is what torch InstanceNorm1d gives on
    the unpadded input. Values past ``valid`` are normalized with the same
    statistics (callers mask them downstream).
    """
    if valid is None:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
    else:
        t = torch.arange(x.shape[-1], device=x.device)
        mask = (t[None, :] < valid.to(x.device)[:, None]).to(x.dtype)[:, None, :]
        n = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
        mean = (x * mask).sum(dim=-1, keepdim=True) / n
        var = ((x - mean) ** 2 * mask).sum(dim=-1, keepdim=True) / n
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight[None, :, None] + bias[None, :, None]
    return out


class InstanceNorm(nn.Module):
    """Affine instance norm with an optional valid-prefix mask."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None):
        return instancenorm1d(x, self.weight, self.bias, self.eps, valid)


def length_mask(
    lengths_rel: torch.Tensor, max_len: int, dtype=torch.float32
) -> torch.Tensor:
    """(B,) relative lengths -> (B, max_len) mask, speechbrain length_to_mask
    semantics: frame t is valid iff t < rel_len * max_len (no rounding)."""
    bounds = lengths_rel * max_len
    idx = torch.arange(max_len, device=lengths_rel.device)[None, :]
    return (idx < bounds[:, None]).to(dtype)


def bilstm_stack(
    x: torch.Tensor,
    layers: Sequence[nn.LSTM],
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T, I) -> (B, T, 2H) through single-layer bidirectional LSTMs.

    ``valid``: optional (B,) host (CPU) tensor of real timesteps per row.
    When some row is short, each layer runs over a packed sequence, so the
    reverse direction starts at the row's true end, and outputs past it are
    zeroed before the next layer — what true-length inference feeds it.
    Rows with no valid frame are packed with length 1 and zeroed.
    """
    T = x.shape[1]
    if valid is None or bool((valid >= T).all()):
        out = x
        for lstm in layers:
            out, _ = lstm(out)
        return out
    lengths = valid.to("cpu", torch.int64).clamp(1, T)
    frame_mask = (torch.arange(T)[None, :] < valid.cpu()[:, None]).to(
        x.device, x.dtype
    )[..., None]
    out = x
    for lstm in layers:
        packed = pack_padded_sequence(
            out, lengths, batch_first=True, enforce_sorted=False
        )
        out, _ = lstm(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
        out = out * frame_mask
    return out
