"""Stage 2's full batch as one captured CUDA graph, replayed batch by batch.

Every stage-2 batch a request runs on the card has one shape:
``chunk_lattice`` pads the chunk count to a multiple of ``emb_batch``, so a
batch is ``emb_batch`` (chunk, local speaker) rows of one window. Its chain
(the pack kernel, the log-mel kernel with the top-dB clamp and the mean
norm, the ECAPA-TDNN trunk with the ASP kernel, the embedding's cast) is
some 430 launches, and the host takes longer to launch them from Python
than the card takes to run them. So the pipeline captures the chain once
for each ``graph_key`` and replays it for every full batch; the host then
makes four calls a batch: the windows gathered into the graph's input, the
masks copied into it, the replay, and the outputs copied out before the
next replay overwrites them.

The hand-written kernels launch on PyTorch's current stream and their
launchers call only ``cudaGetLastError``, so they run inside the graph as
they run eagerly. The rule (``engages``) reads only what a call can
observe: the device, the batch's row count and whether the caller wants the
packed signals, which the graph does not keep. On the CPU every batch runs
eagerly.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops import asp_cuda, frontend_cuda, pack_cuda

# each kernel wrapper's count of its host calls, (function, attribute): a
# replay launches the kernels without calling the wrappers, so it adds what
# the capture counted
LAUNCH_COUNTERS = (
    (pack_cuda.pack_frames, "launches"),
    (frontend_cuda.log_mel_spectrogram, "launches"),
    (asp_cuda.asp_pool, "bfloat16_launches"),
    (asp_cuda.asp_pool, "float32_launches"),
)

Chain = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def engages(device: torch.device, rows: int, batch: int, with_internals: bool) -> bool:
    """Whether a stage-2 batch of ``rows`` rows replays the captured graph:
    on a CUDA device, a full batch of ``batch`` rows, and not when the
    caller wants the packed signals and lengths (``with_internals``)."""
    return device.type == "cuda" and rows == batch and not with_internals


def graph_key(device: torch.device, shape, dtypes, emb_dtype: torch.dtype, layout: str):
    """What decides which kernels a capture records: the device, the batch's
    (rows, window, frames) ``shape``, the dtypes of the windows and masks,
    the trunk's dtype and layout, and the TF32 and determinism flags that
    choose cuBLAS and cuDNN kernels (``precision_scope`` sets the TF32
    ones), so a graph captured under one precision never replays under
    another."""
    return (
        device,
        tuple(shape),
        tuple(dtypes),
        emb_dtype,
        layout,
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.backends.cudnn.deterministic,
        torch.are_deterministic_algorithms_enabled(),
    )


def _counts():
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


class Stage2Graph:
    """``chain`` (windows (B, n), masks (B, F) -> embeddings (B, D) float32,
    too_short (B,) bool) captured once on static inputs, then replayed for
    each batch (``__call__``).

    The capture runs the chain once eagerly on a side stream (cuBLAS and
    cuDNN set up that stream's handles and plans), then records it on the
    same stream into the graph's own memory pool, under inference mode. Its
    waits for the card are one-time set-up: the sync debug mode is lifted
    around the capture alone, as for ``SpeakerDiarizationPipeline._wait``.
    The warm-up and the capture count no launch; each replay adds to the
    kernels' launch counters what the capture called."""

    @torch.inference_mode()
    def __init__(self, chain: Chain, chunks: torch.Tensor, index: torch.Tensor, masks: torch.Tensor):
        device = chunks.device
        self.windows = torch.empty(
            (index.shape[0], chunks.shape[1]), dtype=chunks.dtype, device=device
        )
        self.masks = torch.empty(masks.shape, dtype=masks.dtype, device=device)
        torch.index_select(chunks, 0, index, out=self.windows)
        self.masks.copy_(masks)
        before = _counts()
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with torch.cuda.device(device):
                current = torch.cuda.current_stream(device)
                side = torch.cuda.Stream(device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    chain(self.windows, self.masks)
                current.wait_stream(side)
                warm = _counts()
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                    self.outputs = chain(self.windows, self.masks)
                self.launches = [a - w for a, w in zip(_counts(), warm)]
        finally:
            torch.cuda.set_sync_debug_mode(previous)
            for (fn, attr), n in zip(LAUNCH_COUNTERS, before):
                setattr(fn, attr, n)

    @torch.inference_mode()
    def __call__(self, chunks: torch.Tensor, index: torch.Tensor, masks: torch.Tensor):
        """The batch of windows ``chunks[index]`` under ``masks`` through the
        graph: (embeddings, too_short), new tensors."""
        torch.index_select(chunks, 0, index, out=self.windows)
        self.masks.copy_(masks)
        self.graph.replay()
        for (fn, attr), n in zip(LAUNCH_COUNTERS, self.launches):
            if n:
                setattr(fn, attr, getattr(fn, attr) + n)
        emb, too_short = self.outputs
        return emb.clone(), too_short.clone()
