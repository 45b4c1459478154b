"""Masked left-pack of speech samples: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``pack_frames_pallas`` (JAX package
ops/pack_pallas.py). The kernel is ``csrc/pack.cu``; its header says what
bounds it on the H100 (bytes) and how it is laid out.

Frame masks are FRAME-level (293 frames over 80000 samples), and nearest
upsampling maps sample j to frame floor(j * F / n), so frame f owns the
contiguous run [ceil(f n / F), ceil((f+1) n / F)). Packing the kept samples
is therefore a copy of whole runs; the result is bit-identical to
upsampling the mask to samples and left-packing sample by sample.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_lib


def frame_tables(num_frames: int, num_samples: int, device=None):
    """(run_len, orig_start) int64 tensors: the samples each frame owns
    under out[j] = in[floor(j * F / n)] (torch F.interpolate "nearest")."""
    f = torch.arange(num_frames + 1, device=device, dtype=torch.int64)
    starts = (f * num_samples + num_frames - 1) // num_frames
    return starts[1:] - starts[:-1], starts[:-1]


def pack_frames_plain(
    waveforms: torch.Tensor, keep: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same contract as ``pack_frames``.

    Output sample j < lens comes from the kept frame whose packed run holds
    j: the first frame whose inclusive packed end exceeds j (a searchsorted
    over the cumulative packed lengths; frames that are not kept add no
    length and are never selected).
    """
    batch, n = waveforms.shape
    run_len, orig_start = frame_tables(keep.shape[-1], n, waveforms.device)
    plen = torch.where(keep.bool(), run_len, 0)
    pcum = torch.cumsum(plen, dim=-1)  # inclusive packed ends
    lens = pcum[:, -1]
    j = torch.arange(n, device=waveforms.device).expand(batch, n).contiguous()
    frame = torch.searchsorted(pcum, j, right=True).clamp_(max=keep.shape[-1] - 1)
    src = torch.gather(orig_start.expand(batch, -1), 1, frame) + (
        j - torch.gather(pcum - plen, 1, frame)
    )
    packed = torch.gather(waveforms, 1, src.clamp_(0, n - 1))
    packed = torch.where(j < lens[:, None], packed, torch.zeros_like(packed))
    return packed, lens.to(torch.int32)


def pack_frames(
    waveforms: torch.Tensor, keep: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) float32 waveforms + (B, F) keep flags (bool or 0/1) ->
    (packed (B, n) float32, lens (B,) int32).

    On a CUDA tensor this launches ``csrc/pack.cu``; on a CPU tensor it runs
    ``pack_frames_plain``.
    """
    if waveforms.dim() != 2 or keep.dim() != 2 or keep.shape[0] != waveforms.shape[0]:
        raise ValueError(
            f"pack_frames wants (B, n) waveforms and (B, F) keep flags, got "
            f"{tuple(waveforms.shape)} and {tuple(keep.shape)}"
        )
    if waveforms.device.type == "cpu":
        return pack_frames_plain(waveforms, keep)
    if waveforms.device.type != "cuda" or keep.device != waveforms.device:
        raise ValueError(
            f"pack_frames: tensors on {waveforms.device} and {keep.device}"
        )
    if waveforms.dtype != torch.float32 or not waveforms.is_contiguous():
        raise ValueError("pack_frames: waveforms must be contiguous float32")
    batch, n = waveforms.shape
    num_frames = keep.shape[1]
    lib = _cuda_lib.library("pack")
    if num_frames > lib.pack_max_frames() or num_frames > n:
        raise ValueError(
            f"pack_frames: {num_frames} frames over {n} samples is unsupported"
        )
    keep_u8 = (keep != 0).to(torch.uint8).contiguous()
    packed = torch.empty_like(waveforms)
    lens = torch.empty(batch, dtype=torch.int32, device=waveforms.device)
    if batch == 0:
        return packed, lens
    fn = lib.pack_frames_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(waveforms.device):
        err = fn(
            waveforms.data_ptr(),
            keep_u8.data_ptr(),
            packed.data_ptr(),
            lens.data_ptr(),
            batch,
            n,
            num_frames,
            _cuda_lib.stream_of(waveforms),
        )
    _cuda_lib.check("pack", err)
    pack_frames.launches += 1
    return packed, lens


pack_frames.launches = 0
