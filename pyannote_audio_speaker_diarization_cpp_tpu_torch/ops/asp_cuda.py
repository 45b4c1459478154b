"""ECAPA attentive-statistics pooling tail: CUDA kernel wrapper and plain
version.

Replaces the TPU kernel ``asp_pool_pallas`` (JAX package ops/asp_pallas.py).
The kernels are in ``csrc/asp.cu``, one per type of x, both with the score
product on the tensor cores and each row walked only to its last valid
frame: bfloat16 (the main path) on ``mma.sync``; float32 on ``wgmma`` in
3xTF32 (three TF32 products per float32 product, as accurate as float32).
The file's header says what bounds them on the H100 (bf16: the bytes of x;
float32: the operations) and how they are laid out. Unlike the TPU kernel
they take any channel count C (the channel edge is masked).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_lib

_BF16_OR_F32 = (torch.bfloat16, torch.float32)
_MAX_FRAMES_BF16 = 1 << 22  # the bf16 kernel indexes a row's frames in 32 bits


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


def _frame_rows(B: int, A: int, T: int, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, A, T) tensor whose rows of frames start 16-byte aligned:
    a view of a buffer with rows padded to a multiple of 8 frames."""
    return torch.empty((B, A, -(-T // 8) * 8), dtype=like.dtype, device=like.device)[..., :T]


def attention_tanh(attn: torch.Tensor) -> torch.Tensor:
    """tanh(attn) for ``asp_pool``'s a_tanh, (B, A, T), laid out as the
    kernels read it: for bfloat16 and float32, rows padded to a multiple of 8
    frames (written by the one tanh launch), so each starts 16-byte aligned
    for the bf16 kernel's copies and a float32 row's 8-frame segments fill
    whole 32-byte sectors; for other dtypes, or where autograd records the
    call, contiguous."""
    if attn.dtype not in _BF16_OR_F32 or (torch.is_grad_enabled() and attn.requires_grad):
        return torch.tanh(attn).contiguous()
    return torch.tanh(attn, out=_frame_rows(*attn.shape, like=attn))


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
    a_tanh: (B, A, T)  tanh of the attention TDNN output, x's dtype, best as
                       ``attention_tanh`` lays it out (bfloat16: else copied
                       so; float32: any rows of frames at one stride)
    w:      (C, A)     the 1x1 conv weight expanding A -> C, x's dtype
    bias:   (C,)       its bias (any float dtype; used in float32)
    mask:   (B, T)     > 0 on valid frames (length mask), any float dtype
    Returns (mean, std), each (B, C) in x's dtype.

    On a CUDA tensor this launches the kernel of x's dtype in
    ``csrc/asp.cu`` or raises: bfloat16 takes A up to
    ``asp_max_attention()`` (256), float32 up to ``asp_max_attention_f32()``
    (128). Where autograd records the call (grad mode on and an input that
    requires a gradient) the launch is a node whose backward is
    ``asp_pool_backward``; under ``inference_mode`` or ``no_grad`` it is
    not. On a CPU tensor it runs ``asp_pool_plain``.
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a_tanh, w, bias)):
        return _AspPool.apply(x, a_tanh, w, bias, mask, eps)
    return _launch(x, a_tanh, w, bias, mask, eps)


def _launch(x, a_tanh, w, bias, mask, eps):
    """The kernel of x's dtype on (B, C, T) CUDA tensors that ``asp_pool``
    checked; counts the launch."""
    B, C, T = x.shape
    A = a_tanh.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"asp_pool: x must be float32 or bfloat16, got {x.dtype}")
    if a_tanh.dtype != x.dtype or w.dtype != x.dtype:
        raise ValueError("asp_pool: a_tanh and w must have x's dtype")
    if not x.is_contiguous():
        raise ValueError("asp_pool: x must be contiguous")
    mean = torch.empty((B, C), dtype=x.dtype, device=x.device)
    std = torch.empty((B, C), dtype=x.dtype, device=x.device)
    if B == 0 or C == 0:
        return mean, std
    if T == 0:
        raise ValueError("asp_pool: no frames to pool")
    lib = _cuda_lib.library("asp")
    if x.dtype == torch.bfloat16:
        lib.asp_max_attention.restype = ctypes.c_int
        lib.asp_max_attention.argtypes = []
        max_a = lib.asp_max_attention()
        if A > max_a or T >= _MAX_FRAMES_BF16:
            raise ValueError(
                f"asp_pool: the bfloat16 kernel takes A <= {max_a} and "
                f"T < {_MAX_FRAMES_BF16}, got A {A}, T {T}"
            )
        lda = a_tanh.stride(1)
        if not (
            a_tanh.stride(2) == 1
            and lda % 8 == 0
            and a_tanh.stride(0) == A * lda
            and a_tanh.data_ptr() % 16 == 0
        ):
            a_tanh = _frame_rows(B, A, T, like=a_tanh).copy_(a_tanh)
            lda = a_tanh.stride(1)
        # W (C, A) as given (the conv weight's view is contiguous); bias and
        # mask in their own type when that is bfloat16 or float32
        w = w.contiguous()
        bias = bias if bias.dtype in _BF16_OR_F32 else bias.float()
        mask = mask if mask.dtype in _BF16_OR_F32 else mask.float()
        bias, mask = bias.contiguous(), mask.contiguous()
        fn = lib.asp_pool_bf16_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 2
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p]
        )
        args = (
            x.data_ptr(),
            a_tanh.data_ptr(),
            lda,
            w.data_ptr(),
            bias.data_ptr(),
            int(bias.dtype == torch.bfloat16),
            mask.data_ptr(),
            int(mask.dtype == torch.bfloat16),
        )
    else:
        lib.asp_max_attention_f32.restype = ctypes.c_int
        lib.asp_max_attention_f32.argtypes = []
        max_a = lib.asp_max_attention_f32()
        if A > max_a:
            raise ValueError(f"asp_pool: the float32 kernel takes A <= {max_a}, got A {A}")
        # a_tanh: rows of frames at one stride lda >= T, as attention_tanh
        # pads them or contiguous; any other layout is copied into the padded
        # one
        lda = a_tanh.stride(1)
        if not (a_tanh.stride(2) == 1 and lda >= T and a_tanh.stride(0) == A * lda):
            a_tanh = _frame_rows(B, A, T, like=a_tanh).copy_(a_tanh)
            lda = a_tanh.stride(1)
        w = w.contiguous()
        bias = bias.to(torch.float32).contiguous()
        mask = mask.to(torch.float32).contiguous()
        fn = lib.asp_pool_f32_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 2
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p]
        )
        args = (x.data_ptr(), a_tanh.data_ptr(), lda, w.data_ptr(), bias.data_ptr(),
                mask.data_ptr())
    with torch.cuda.device(x.device):
        err = fn(*args, mean.data_ptr(), std.data_ptr(), B, C, A, T, eps, _cuda_lib.stream_of(x))
    _cuda_lib.check("asp", err)
    if x.dtype == torch.float32:
        asp_pool.float32_launches += 1
    else:
        asp_pool.bfloat16_launches += 1
    return mean, std


def asp_pool_backward(
    x: torch.Tensor,
    a_tanh: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor,
    eps: float,
    g_mean: torch.Tensor,
    g_std: torch.Tensor,
):
    """The gradients of ``asp_pool``'s (mean, std) for x, a_tanh, w and bias,
    in closed form, each in its input's dtype: the scores and the masked
    softmax p are recomputed in float32, then with gv the std's gradient
    through sqrt and both clamps and gm = g_mean - 2 mean gv,

        dx = p (gm + 2 gv x),  ds = p (gm (x - mean) + gv (x^2 - E[x^2])),
        dW = sum_b,t ds a^T,   dbias = sum_b,t ds,   da = W^T ds.

    Plain torch ops (products and reductions, no atomics), so a training
    step is deterministic; they equal autograd through ``asp_pool_plain``."""
    a = a_tanh.float()
    wf = w.float()
    s = torch.einsum("ca,bat->bct", wf, a) + bias.float()[None, :, None]
    s = s.masked_fill(~(mask[:, None, :] > 0), float("-inf"))
    p = torch.softmax(s, dim=2)
    xf = x.float()
    mean = (p * xf).sum(dim=2)
    sq = (p * xf * xf).sum(dim=2)
    raw = sq - mean * mean
    var = torch.clamp(raw, min=0.0)
    std = torch.sqrt(torch.clamp(var, min=eps))
    gv = torch.where((raw >= 0) & (var >= eps), g_std.float() / (2 * std), 0.0)
    gm = g_mean.float() - 2 * mean * gv
    gm, gv = gm[..., None], gv[..., None]
    gx = (p * (gm + 2 * gv * xf)).to(x.dtype)
    ds = p * (gm * (xf - mean[..., None]) + gv * (xf * xf - sq[..., None]))
    ga = torch.einsum("ca,bct->bat", wf, ds).to(a_tanh.dtype)
    gw = torch.einsum("bct,bat->ca", ds, a).to(w.dtype)
    gb = ds.sum(dim=(0, 2)).to(bias.dtype)
    return gx, ga, gw, gb


class _AspPool(torch.autograd.Function):
    """``asp_pool`` where autograd records it: the forward launches the
    kernel, the backward is ``asp_pool_backward``."""

    @staticmethod
    def forward(ctx, x, a_tanh, w, bias, mask, eps):
        ctx.save_for_backward(x, a_tanh, w, bias, mask)
        ctx.eps = eps
        return _launch(x, a_tanh, w, bias, mask, eps)

    @staticmethod
    def backward(ctx, g_mean, g_std):
        x, a_tanh, w, bias, mask = ctx.saved_tensors
        grads = asp_pool_backward(x, a_tanh, w, bias, mask, ctx.eps, g_mean, g_std)
        grads = [g if need else None for g, need in zip(grads, ctx.needs_input_grad)]
        return (*grads, None, None)


# one launch count for each of the two kernels
asp_pool.float32_launches = asp_pool.bfloat16_launches = 0
