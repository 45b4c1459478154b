"""Layer primitives shared by PyanNet and ECAPA-TDNN, in PyTorch.

Conventions match the JAX package's parameter pytrees (which already use
torch's): conv weights are (out, in, k), linear weights (out, in), LSTM gates
ordered i,f,g,o. What torch does not ship is here: "same" convolutions with
reflect padding (speechbrain's Conv1d default), instance norm over a valid
prefix of each row, speechbrain's relative-length mask, a BiLSTM stack
whose reverse direction starts at each row's true end, and the copy of a
host tensor to the card that does not wait for it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.nn.utils.rnn import PackedSequence


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


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``. To a CUDA device it is copied from pinned
    memory behind the work already queued on the current stream, so the host
    does not wait for the card (a copy from pageable memory drains the
    stream first)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def packed_layout(valid: torch.Tensor, T: int):
    """Host plan of a packed sequence over (B, T) rows with ``valid`` (B,)
    real steps each (at least one step is packed per row). Returns
    (batch_sizes (steps,) int64; gather (N,) int64: the flat index b * T + t
    of each packed step, time-major, rows by descending length; scatter (N,)
    int64: the same index where t < valid, else B * T, a spare row)."""
    valid = valid.to("cpu", torch.int64)
    B = valid.shape[0]
    lengths = valid.clamp(1, T)
    sorted_len, order = torch.sort(lengths, descending=True, stable=True)
    t = torch.arange(int(sorted_len[0]))
    live = sorted_len[None, :] > t[:, None]  # (steps, B)
    rows = order[None, :].expand_as(live)[live]
    times = t[:, None].expand_as(live)[live]
    gather = rows * T + times
    scatter = torch.where(times < valid[rows], gather, B * T)
    return live.sum(dim=1), gather, scatter


def bilstm_stack(
    x: torch.Tensor,
    layers: Sequence[nn.LSTM],
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T, I) -> (B, T, 2H) through single-layer bidirectional LSTMs.

    ``valid``: optional (B,) host (CPU) tensor of real timesteps per row.
    When some row is short, each layer runs over a packed sequence, so the
    reverse direction starts at the row's true end, and outputs past it are
    zero before the next layer: what true-length inference feeds it. Rows
    with no valid frame are packed with length 1 and come out zero. The
    packing plan is built on the host from ``valid`` and reaches the card
    without a wait (``pack_padded_sequence`` would copy its sort indices
    from pageable memory, and unpacking would fetch them back).
    """
    B, T = x.shape[:2]
    if valid is None or bool((valid >= T).all()):
        out = x
        for lstm in layers:
            out, _ = lstm(out)
        return out
    batch_sizes, gather, scatter = packed_layout(valid, T)
    gather = host_to_device(gather, x.device)
    scatter = host_to_device(scatter, x.device)
    out = x
    for lstm in layers:
        data = out.reshape(B * T, -1).index_select(0, gather)
        packed, _ = lstm(PackedSequence(data, batch_sizes))
        rows = out.new_zeros((B * T + 1, packed.data.shape[-1]))
        out = rows.index_copy_(0, scatter, packed.data)[: B * T].reshape(B, T, -1)
    return out
