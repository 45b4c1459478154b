"""The data-parallel gather: every rank's block of rows to every rank.

In the JAX package the stages' sharding constraints make XLA insert the
collectives, and this module holds the one it calls on its own: the
embedding matrix gathered to every device for the global clustering, built
on ``mesh.replicated``. In the port ``mesh.replicated`` is that gather, and
the pipeline gathers each stage's per-rank outputs with it
(pipelines/diarization.py, ``mesh=``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .mesh import DataMesh, replicated


def all_gather_embeddings(
    local: torch.Tensor, mesh: DataMesh, counts: Optional[List[int]] = None
) -> torch.Tensor:
    """(rows_r, D) on each rank -> (sum of rows_r, D) on every rank, in rank
    order (``mesh.replicated``, in the JAX package's argument order)."""
    return replicated(mesh, local, counts)
