"""ECAPA attentive-statistics pooling tail: CUDA kernel wrapper and plain
version.

Replaces the TPU kernel ``asp_pool_pallas`` (JAX package ops/asp_pallas.py).
The kernel is ``csrc/asp.cu``; its header says what bounds it on the H100
(the bytes of x) and how it is laid out. Unlike the TPU kernel it takes any
channel count C (the channel edge is masked).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_lib


def asp_pool_plain(
    x: torch.Tensor,
    a_tanh: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-12,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same contract as ``asp_pool``:
    scores = W a + b, softmax over the frames where mask > 0, weighted mean
    and std, all in float32; outputs in x's dtype."""
    s = torch.einsum("ca,bat->bct", w.float(), a_tanh.float()) + bias.float()[None, :, None]
    s = torch.where(mask[:, None, :] > 0, s, torch.full_like(s, float("-inf")))
    p = torch.softmax(s, dim=2)
    xf = x.float()
    mean = (p * xf).sum(dim=2)
    sq = (p * xf * xf).sum(dim=2)
    var = torch.clamp(sq - mean * mean, min=0.0)
    std = torch.sqrt(torch.clamp(var, min=eps))
    return mean.to(x.dtype), std.to(x.dtype)


def asp_pool(
    x: torch.Tensor,
    a_tanh: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-12,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ASP tail.

    x:      (B, C, T)  pooled-over activations, float32 or bfloat16
    a_tanh: (B, A, T)  tanh of the attention TDNN output, x's dtype
    w:      (C, A)     the 1x1 conv weight expanding A -> C, x's dtype
    bias:   (C,)       its bias (any float dtype; used in float32)
    mask:   (B, T)     > 0 on valid frames (length mask)
    Returns (mean, std), each (B, C) in x's dtype.

    On a CUDA tensor this launches ``csrc/asp.cu``; on a CPU tensor it runs
    ``asp_pool_plain``.
    """
    if x.dim() != 3 or a_tanh.dim() != 3 or w.dim() != 2 or mask.dim() != 2:
        raise ValueError("asp_pool wants x (B,C,T), a_tanh (B,A,T), w (C,A), mask (B,T)")
    B, C, T = x.shape
    A = a_tanh.shape[1]
    if (
        a_tanh.shape != (B, A, T)
        or w.shape != (C, A)
        or bias.shape != (C,)
        or mask.shape != (B, T)
    ):
        raise ValueError(
            f"asp_pool: shapes x {tuple(x.shape)}, a_tanh {tuple(a_tanh.shape)}, "
            f"w {tuple(w.shape)}, bias {tuple(bias.shape)}, mask {tuple(mask.shape)}"
        )
    if x.device.type == "cpu":
        return asp_pool_plain(x, a_tanh, w, bias, mask, eps)
    if x.device.type != "cuda" or any(
        t.device != x.device for t in (a_tanh, w, bias, mask)
    ):
        raise ValueError("asp_pool: all tensors must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"asp_pool: x must be float32 or bfloat16, got {x.dtype}")
    if a_tanh.dtype != x.dtype or w.dtype != x.dtype:
        raise ValueError("asp_pool: a_tanh and w must have x's dtype")
    if not (x.is_contiguous() and a_tanh.is_contiguous()):
        raise ValueError("asp_pool: x and a_tanh must be contiguous")
    wt = w.t().contiguous()  # (A, C): coalesced weight loads in the kernel
    bias32 = bias.to(torch.float32).contiguous()
    mask32 = mask.to(torch.float32).contiguous()
    mean = torch.empty((B, C), dtype=x.dtype, device=x.device)
    std = torch.empty((B, C), dtype=x.dtype, device=x.device)
    if B == 0 or C == 0:
        return mean, std
    if T == 0:
        raise ValueError("asp_pool: no frames to pool")
    lib = _cuda_lib.library("asp")
    fn = lib.asp_pool_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p]
    )
    with torch.cuda.device(x.device):
        err = fn(
            int(x.dtype == torch.bfloat16),
            x.data_ptr(),
            a_tanh.data_ptr(),
            wt.data_ptr(),
            bias32.data_ptr(),
            mask32.data_ptr(),
            mean.data_ptr(),
            std.data_ptr(),
            B,
            C,
            A,
            T,
            eps,
            _cuda_lib.stream_of(x),
        )
    _cuda_lib.check("asp", err)
    asp_pool.launches += 1
    return mean, std


asp_pool.launches = 0
