"""The data-parallel group: one process a card.

The JAX package's mesh is one process that holds every chip, and its
stages split the batch axis with sharding annotations. PyTorch's idiom is
one process a card in a ``torch.distributed`` process group: NCCL between
CUDA cards, gloo between CPU processes. A ``DataMesh`` is one rank's view
of such a group (the group, the rank, the world size and the device the
rank runs on), and every rank calls the pipeline on the same request
(SPMD). ``batch_spec`` gives a rank its contiguous block of whole batches
(the role of the JAX package's ``batch_spec``); ``replicated`` gathers every
rank's block to every rank (the role of its ``replicated``).

The backend is the group's own and is never switched here: an NCCL group
runs on a CUDA device, a gloo group on the CPU, and a gloo group on a CUDA
device only when the caller names that device (several ranks sharing one
card, which NCCL refuses).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# the name of the mesh's one axis, as the JAX package calls it
DATA_AXIS = "data"
BACKENDS = ("nccl", "gloo")


def backend_for(device) -> str:
    """The collective backend for ranks on ``device``: "nccl" for a CUDA
    device, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank of a 1-D data-parallel group."""

    group: object  # a torch.distributed ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    backend: str


def make_mesh(group=None, device=None) -> DataMesh:
    """This rank's ``DataMesh`` over an initialised process group (the
    default group when ``group`` is None).

    ``device``: None takes ``cuda:<local rank>`` on an NCCL group (the
    ``LOCAL_RANK`` that torchrun sets, else the rank modulo the visible
    cards) and the CPU on a gloo group. A CUDA device becomes the process's
    current device."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group first"
        )
    group = group if group is not None else dist.group.WORLD
    backend = str(dist.get_backend(group))
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        if backend == "nccl":
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else rank % torch.cuda.device_count()
            device = torch.device("cuda", index)
        else:
            device = torch.device("cpu")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group runs on a CUDA device, not {device}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return DataMesh(group, rank, world, device, backend)


def batch_counts(mesh: DataMesh, num_batches: int) -> List[int]:
    """Whole batches each rank runs, in rank order: ``num_batches`` split
    near-evenly, the first ``num_batches % world_size`` ranks one more."""
    base, extra = divmod(num_batches, mesh.world_size)
    return [base + (r < extra) for r in range(mesh.world_size)]


def batch_spec(mesh: DataMesh, num_batches: int) -> range:
    """The indices of this rank's contiguous block of whole batches. A
    batch keeps the shape a single card gives it, so the kernels and the
    libraries see the same calls with or without the mesh."""
    counts = batch_counts(mesh, num_batches)
    lo = sum(counts[: mesh.rank])
    return range(lo, lo + counts[mesh.rank])


# one all-gather of equal blocks into one tensor, rank-major: torch 2.13
# names it all_gather_single and deprecates all_gather_into_tensor, which
# is the only name in the torch 2.11 of the card's host
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _block_counts(local: torch.Tensor, mesh: DataMesh) -> List[int]:
    """Each rank's row count, gathered; the host waits for them."""
    device = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    mine = torch.tensor([local.shape[0]], dtype=torch.int64, device=device)
    counts = torch.empty(mesh.world_size, dtype=torch.int64, device=device)
    _all_gather(counts, mine, group=mesh.group)
    return counts.tolist()


def replicated(
    mesh: DataMesh, local: torch.Tensor, counts: Optional[List[int]] = None
) -> torch.Tensor:
    """(rows_r, ...) on each rank -> (sum of rows_r, ...) on every rank, the
    blocks in rank order.

    ``counts``: every rank's rows, when the caller knows them (the pipeline
    does: they follow from the request's shape); else they are gathered
    first and the host waits for them. Uneven blocks are padded to the
    largest, gathered in one all-gather into one tensor and trimmed. On an
    NCCL group the gather runs on the card behind the queued work, and the
    host does not wait; on gloo it runs on the host (CUDA blocks are copied
    there and back). bool rows travel as bytes.
    """
    if counts is None:
        counts = _block_counts(local, mesh)
    counts = [int(c) for c in counts]
    if len(counts) != mesh.world_size or counts[mesh.rank] != local.shape[0]:
        raise ValueError(
            f"rank {mesh.rank} holds {local.shape[0]} rows, counts say {counts}"
        )
    width = max(counts)
    if width == 0:
        return local
    block = local.view(torch.uint8) if local.dtype == torch.bool else local
    home = block.device
    if mesh.backend == "gloo":
        block = block.cpu()
    if block.shape[0] < width:
        pad = block.new_zeros((width - block.shape[0],) + tuple(block.shape[1:]))
        block = torch.cat([block, pad])
    out = block.new_empty((mesh.world_size * width,) + tuple(block.shape[1:]))
    _all_gather(out, block.contiguous(), group=mesh.group)
    if sum(counts) != out.shape[0]:
        out = torch.cat([out[r * width : r * width + c] for r, c in enumerate(counts)])
    out = out.to(home)
    return out.view(torch.bool) if local.dtype == torch.bool else out
