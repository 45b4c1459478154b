"""Minimal training loop over the train steps of models/training.py.

Port of the JAX package's models/trainer.py: feed batches, step the
optimizer, checkpoint and resume, optionally data-parallel over a
``parallel.mesh.DataMesh`` (every rank of its group builds the same
``Trainer`` and feeds it the same batches; each runs its block of the rows
and the gradients are summed across ranks) — enough to fine-tune PyanNet
(PIT-BCE) or ECAPA (AAM-softmax) on the card.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch.distributed as dist

from ..pipelines.diarization import resolve_device
from ..utils.checkpoint import CheckpointManager
from . import training as T


class Trainer:
    """Wraps a train step with state management, a fit loop and
    checkpoints.

    ``params``: the parameter tree (the JAX package's layout; numpy arrays
    or tensors). ``make_step``: ``make_step(mesh) -> train_step``, e.g.
    ``lambda mesh: make_segmentation_train_step(cfg, mesh)``.
    ``optimizer``: a factory called with the parameter tensors (default
    ``torch.optim.Adam(lr=1e-3)``, optax.adam(1e-3)'s arithmetic).
    ``mesh``: a ``DataMesh``; the state then lives on its device.
    ``device``: None means the CUDA card (pipelines/diarization.py
    ``resolve_device``); pass "cpu" to train on the CPU.
    """

    def __init__(
        self,
        params,
        make_step: Callable,
        optimizer: Optional[Callable] = None,
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self._mesh = mesh
        self.state = T.init_train_state(params, optimizer, self.device)
        self._step = make_step(mesh)

    def step(self, *batch) -> float:
        self.state, loss = self._step(self.state, *batch)
        return float(loss)

    def fit(
        self,
        batches: Iterable,
        steps: Optional[int] = None,
        log_every: int = 50,
        log_fn=print,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 500,
    ):
        manager = CheckpointManager(checkpoint_dir) if checkpoint_dir is not None else None
        losses = []
        for i, batch in enumerate(batches):
            if steps is not None and i >= steps:
                break
            loss = self.step(*batch)
            losses.append(loss)
            if log_every and (i + 1) % log_every == 0:
                recent = sum(losses[-log_every:]) / min(log_every, len(losses))
                log_fn(f"step {i + 1}: loss {recent:.4f}")
            if manager is not None and checkpoint_every and (
                self.state.step % checkpoint_every == 0
            ):
                self._save(manager)
        if manager is not None:
            self._save(manager)
        return losses

    # ------------------------------------------------------------------
    # checkpoint / resume: params + the optimizer's state + step, in the
    # JAX package's file layout (utils/checkpoint.py)
    # ------------------------------------------------------------------

    def _save(self, manager: CheckpointManager) -> str:
        # with a mesh every rank holds the same state: rank 0 writes it, and
        # no rank goes on (to a restore, say) before it has
        if self._mesh is None:
            return manager.save(self.state.step, T.train_state_tree(self.state))
        path = manager.path(self.state.step)
        if self._mesh.rank == 0:
            manager.save(self.state.step, T.train_state_tree(self.state))
        dist.barrier(group=self._mesh.group)
        return path

    def save_checkpoint(self, directory: str) -> str:
        return self._save(CheckpointManager(directory))

    def restore_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Restore the full state (params + optimizer state + step) in
        place; returns the restored step number."""
        tree, step = CheckpointManager(directory).restore(
            T.train_state_tree(self.state), step
        )
        self.state = T.load_train_state(self.state, tree)
        return step

    @property
    def params(self):
        return self.state.params


def segmentation_trainer(params, cfg=None, optimizer=None, mesh=None, device=None) -> Trainer:
    from .pyannet import PyanNetConfig

    cfg = cfg or PyanNetConfig()
    return Trainer(
        params,
        lambda m: T.make_segmentation_train_step(cfg, m),
        optimizer=optimizer,
        mesh=mesh,
        device=device,
    )
