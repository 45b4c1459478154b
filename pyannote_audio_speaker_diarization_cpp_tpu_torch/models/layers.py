"""Layer primitives shared by PyanNet and ECAPA-TDNN, in PyTorch.

Conventions match the JAX package's parameter pytrees (which already use
torch's): conv weights are (out, in, k), linear weights (out, in), LSTM gates
ordered i,f,g,o. What torch does not ship is here: "same" convolutions with
reflect padding (speechbrain's Conv1d default), channels-last (B, T, C)
convolutions and batch norm (the ECAPA trunk's "nhc" and "gemm" layouts),
instance norm over a valid prefix of each row, speechbrain's
relative-length mask, a BiLSTM stack whose reverse direction starts at each
row's true end, and the copy of a host tensor to the card that does not
wait for it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
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


# ---------------------------------------------------------------------------
# channels-last (B, T, C) forms, for the ECAPA trunk's "nhc" and "gemm"
# layouts (models/ecapa.py): the same math on the same torch-layout weights
# ---------------------------------------------------------------------------


def reflect_pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, T, C) -> (B, T + 2 pad, C), reflected along T (torch's "reflect":
    the edge sample is not repeated)."""
    if pad == 0:
        return x
    return torch.cat([x[:, 1 : pad + 1].flip(1), x, x[:, -pad - 1 : -1].flip(1)], dim=1)


def conv1d_nhc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dilation: int = 1,
    padding="same",
    pad_mode: str = "zeros",
) -> torch.Tensor:
    """(B, T, C_in) -> (B, T', C_out): conv1d in channels-last layout, with
    the (C_out, C_in, k) weight. The activations go to cuDNN as a
    channels-last (B, C, T, 1) conv2d over x's own memory, and the output
    comes back as a (B, T', C_out) view of the channels-last result.
    ``padding``: "same" ((k-1)*dilation/2 a side, reflected when
    ``pad_mode`` is "reflect") or a number of zeros a side."""
    k = weight.shape[-1]
    if padding == "same":
        pad = (k - 1) * dilation // 2
        if pad_mode == "reflect":
            x, pad = reflect_pad_time(x, pad), 0
    else:
        pad = int(padding)
    x = x.contiguous()
    B, T, C = x.shape
    O = weight.shape[0]
    # channels-last strides in full, the size-1 width's included: PyTorch
    # reads the memory format from the strides, and a width stride of 1
    # makes it take x for NCHW and copy it into that layout
    x4 = x.as_strided((B, C, T, 1), (T * C, 1, C, C))
    w = weight.permute(0, 2, 1).contiguous()  # (O, k, C): a view when k = 1
    w4 = w.as_strided((O, C, k, 1), (k * C, 1, C, C))
    out = F.conv2d(x4, w4, bias, padding=(pad, 0), dilation=(dilation, 1))
    return out.squeeze(-1).transpose(1, 2)


def conv1d_gemm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dilation: int = 1,
    padding="same",
    pad_mode: str = "zeros",
) -> torch.Tensor:
    """(B, T, C_in) -> (B, T, C_out) "same" conv1d as k shifted products:
    tap j is the product of the input shifted by j*dilation, as
    (B*T, C_in) rows, with the (C_in, C_out) weight of that tap
    (``F.linear``, the bias added in tap 0's product), and the k products
    are summed. Stride 1, odd k, "same" geometry only (every ECAPA conv);
    k = 1 is a single product over the whole batch."""
    k = weight.shape[-1]
    if k > 1 and (padding != "same" or k % 2 == 0):
        raise ValueError(
            "conv1d_gemm supports only odd-k 'same' geometry "
            f"(got k={k}, padding={padding!r})"
        )
    T = x.shape[1]
    pad = (k - 1) * dilation // 2
    if pad == 0:
        xp = x
    elif pad_mode == "reflect":
        xp = reflect_pad_time(x, pad)
    else:
        xp = F.pad(x, (0, 0, pad, pad))
    out = F.linear(xp[:, :T], weight[:, :, 0], bias)
    for tap in range(1, k):
        out = out + F.linear(xp[:, tap * dilation : tap * dilation + T], weight[:, :, tap])
    return out


def statistics_trained(bn: nn.BatchNorm1d) -> bool:
    """Whether ``bn``'s running statistics require a gradient: a train step
    (models/training.py) trains them, as the JAX package's optimizer does."""
    return bn.running_mean.requires_grad or bn.running_var.requires_grad


def batchnorm_arithmetic(x: torch.Tensor, bn: nn.BatchNorm1d, shape) -> torch.Tensor:
    """Inference-mode ``bn`` written out as the JAX package's
    ``batchnorm1d``, (x - mean) * rsqrt(var + eps) * w + b, its parameters
    viewed as ``shape``: differentiable in the running statistics, which
    ``F.batch_norm`` refuses."""
    return (x - bn.running_mean.view(shape)) * torch.rsqrt(
        bn.running_var.view(shape) + bn.eps
    ) * bn.weight.view(shape) + bn.bias.view(shape)


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over (B, C) or (B, C, T), used in inference mode
    (the module stays in ``eval()``); when its running statistics require a
    gradient it runs ``batchnorm_arithmetic`` instead of ``F.batch_norm``.
    Same parameters and state dict."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if statistics_trained(self):
            return batchnorm_arithmetic(x, self, (1, -1) + (1,) * (x.dim() - 2))
        return super().forward(x)


def batchnorm1d_nlc(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Inference-mode ``bn`` over channels-last (B, C) or (B, T, C): its
    running statistics, channels on the last axis."""
    if statistics_trained(bn):
        return batchnorm_arithmetic(x, bn, (-1,))
    flat = F.batch_norm(
        x.reshape(-1, x.shape[-1]),
        bn.running_mean,
        bn.running_var,
        bn.weight,
        bn.bias,
        False,
        0.0,
        bn.eps,
    )
    return flat.reshape(x.shape)


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
