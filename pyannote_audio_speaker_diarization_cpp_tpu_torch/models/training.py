"""Training steps for the segmentation and embedding models, in PyTorch.

Port of the JAX package's models/training.py:

  - permutation-invariant BCE training for PyanNet (the pyannote
    segmentation objective: the loss is minimized over local-speaker
    permutations per sample), and
  - AAM-softmax (additive angular margin) classification training for
    ECAPA-TDNN (the speechbrain speaker-id objective).

The parameters are a tree in the JAX package's pytree layout (nested dicts
and lists, the names of models/convert.py), its leaves tensors that
require a gradient. The losses apply a model to such a tree with
``torch.func.functional_call``. As in the JAX package, where BatchNorm is
inference arithmetic over parameters that hold the running statistics, a
step trains ECAPA's ``running_mean``/``running_var`` too: the modules stay
in eval semantics and ``models/layers.py`` ``BatchNorm1d`` runs that
arithmetic when the statistics require a gradient. The LSTMs alone run in
``train()`` (their dropout is 0, so nothing else changes): cuDNN's LSTM
backward refuses eval mode on the card.

A step is ``train_step(state, *batch) -> (state, loss)``: zero the
gradients, backward through the loss, ``optimizer.step()`` (Adam by
default, optax.adam's arithmetic). With a ``mesh`` (parallel/mesh.py) each
rank takes its contiguous block of the batch's rows, its summed per-sample
loss is divided by the global batch, and one all-reduce sums the
gradients (and the loss), so every rank steps identically.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import batch_spec
from ..pipelines.diarization import resolve_device
from ..utils.checkpoint import tree_leaves, tree_map, tree_unflatten
from . import convert
from .ecapa import EcapaConfig, EcapaTDNN
from .pyannet import PyanNet, PyanNetConfig


class TrainState(NamedTuple):
    """params: the parameter tree (leaves require a gradient); optimizer: a
    ``torch.optim`` optimizer over its leaves in the tree's leaf order (it
    holds the optimizer state); step: the steps taken."""

    params: Dict
    optimizer: torch.optim.Optimizer
    step: int


def default_optimizer(params) -> torch.optim.Optimizer:
    """optax.adam(1e-3): the same betas (0.9, 0.999) and eps 1e-8."""
    return torch.optim.Adam(params, lr=1e-3)


def init_train_state(
    params: Mapping,
    optimizer: Optional[Callable] = None,
    device=None,
) -> TrainState:
    """A fresh state: ``params`` (numpy arrays or tensors) copied to
    ``device`` (None: the CUDA card, pipelines/diarization.py
    ``resolve_device``; pass "cpu" to train on the CPU) as leaf tensors that
    require a gradient; ``optimizer`` a factory called with those leaves in
    the tree's leaf order (default ``default_optimizer``)."""
    device = resolve_device(device)

    def leaf(value):
        if isinstance(value, torch.Tensor):
            t = value.detach().clone()
        else:
            t = torch.from_numpy(np.array(value))
        return t.to(device).requires_grad_(t.is_floating_point())

    params = tree_map(leaf, params)
    return TrainState(params, (optimizer or default_optimizer)(tree_leaves(params)), 0)


# ---------------------------------------------------------------------------
# the optimizer state in the JAX package's checkpoint layout
# ---------------------------------------------------------------------------


def _adam_state(optimizer, p) -> dict:
    st = optimizer.state.get(p, {})
    if st and "exp_avg" not in st:
        raise ValueError(
            f"{type(optimizer).__name__} keeps no Adam moments: checkpoints hold "
            "Adam's state in the JAX package's layout"
        )
    if any(g.get("amsgrad") for g in optimizer.param_groups):
        raise ValueError("amsgrad has no counterpart in optax.adam's state")
    return st


def train_state_tree(state: TrainState):
    """The state as the JAX ``TrainState`` flattens: (params, (count, mu,
    nu), step), optax adam's ``count`` and ``step`` as int32 scalars, ``mu``
    and ``nu`` trees shaped like params (zeros before the first step)."""
    leaves = tree_leaves(state.params)
    mu, nu, counts = [], [], set()
    for p in leaves:
        st = _adam_state(state.optimizer, p)
        mu.append(st["exp_avg"].detach() if st else torch.zeros_like(p).detach())
        nu.append(st["exp_avg_sq"].detach() if st else torch.zeros_like(p).detach())
        counts.add(int(st["step"]) if st else 0)
    if len(counts) > 1:
        raise ValueError(f"the parameters have taken different Adam step counts {counts}")
    count = np.asarray(counts.pop() if counts else 0, np.int32)
    return (
        tree_map(torch.Tensor.detach, state.params),
        (count, tree_unflatten(state.params, mu), tree_unflatten(state.params, nu)),
        np.asarray(state.step, np.int32),
    )


def load_train_state(state: TrainState, tree) -> TrainState:
    """Copy a tree laid out as ``train_state_tree``'s (tensors or numpy
    arrays, e.g. a restored checkpoint or a JAX state) into ``state``'s
    parameters and optimizer; returns the state with its step."""
    params, (count, mu, nu), step = tree
    leaves = tree_leaves(state.params)
    for p in leaves:
        _adam_state(state.optimizer, p)

    def tensor(value, like):
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        return value.detach().to(like.device, like.dtype).clone()

    with torch.no_grad():
        for p, v in zip(leaves, tree_leaves(params), strict=True):
            p.copy_(tensor(v, p))
        for p, m, n in zip(leaves, tree_leaves(mu), tree_leaves(nu), strict=True):
            state.optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": tensor(m, p),
                "exp_avg_sq": tensor(n, p),
            }
    return state._replace(step=int(np.asarray(step)))


# ---------------------------------------------------------------------------
# applying a model to a parameter tree
# ---------------------------------------------------------------------------


def prepare_for_training(model: nn.Module) -> nn.Module:
    """Eval semantics everywhere (BatchNorm off its running statistics)
    but the LSTMs, which run in ``train()``; their dropout must be 0, so
    that the mode changes nothing but what cuDNN allows."""
    model.eval()
    for m in model.modules():
        if isinstance(m, nn.LSTM):
            if m.dropout != 0:
                raise ValueError(f"an LSTM with dropout {m.dropout}: train() would change it")
            m.train()
    return model


def apply_model(model: nn.Module, state: Dict[str, torch.Tensor], *args):
    """``model(*args)`` with ``state`` (module names) in place of its own
    parameters and buffers; every parameter must be in ``state``."""
    missing = set(dict(model.named_parameters())) - set(state)
    if missing:
        raise KeyError(f"the parameter tree lacks {sorted(missing)}")
    return torch.func.functional_call(model, state, args)


def pyannet_for(params: Mapping, cfg: PyanNetConfig, device) -> PyanNet:
    """A PyanNet to apply ``params`` with: its sinc filterbank in the tree's
    form (band edges, or a baked ``filters``), in training modes."""
    baked = "filters" in params["sincnet"]["sinc"]
    return prepare_for_training(PyanNet(cfg, baked_sinc=baked).to(device))


def ecapa_for(cfg: EcapaConfig, device) -> EcapaTDNN:
    return prepare_for_training(EcapaTDNN(cfg).to(device))


# ---------------------------------------------------------------------------
# segmentation: permutation-invariant BCE
# ---------------------------------------------------------------------------


def _bce(probs, labels, eps=1e-7):
    p = torch.clamp(probs, eps, 1 - eps)
    return -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))


def pit_bce_per_sample(
    params: Mapping,
    waveforms: torch.Tensor,
    labels: torch.Tensor,
    cfg: PyanNetConfig,
    model: Optional[PyanNet] = None,
) -> torch.Tensor:
    """(B,) permutation-invariant BCE: per sample, the least mean BCE over
    the local-speaker permutations (``torch.amin``: a tie splits the
    gradient evenly, as ``jnp.min`` does)."""
    model = model or pyannet_for(params, cfg, waveforms.device)
    state = {convert.pyannet_state_key(k): v for k, v in convert.flatten_pytree(params).items()}
    probs = apply_model(model, state, waveforms)
    losses = []
    for perm in itertools.permutations(range(cfg.num_classes)):
        permuted = probs[..., list(perm)]
        losses.append(torch.mean(_bce(permuted, labels), dim=(1, 2)))
    return torch.amin(torch.stack(losses, dim=0), dim=0)


def pit_bce_loss(
    params: Mapping,
    waveforms: torch.Tensor,
    labels: torch.Tensor,
    cfg: PyanNetConfig,
    model: Optional[PyanNet] = None,
) -> torch.Tensor:
    """Permutation-invariant BCE: min over local-speaker permutations,
    averaged over the batch. labels: (B, frames, num_classes) in {0,1}."""
    return torch.mean(pit_bce_per_sample(params, waveforms, labels, cfg, model))


# ---------------------------------------------------------------------------
# embedding: AAM-softmax speaker classification
# ---------------------------------------------------------------------------


def init_aam_head(generator: torch.Generator, emb_dim: int, num_classes: int) -> Dict:
    """{"weight": (num_classes, emb_dim) normal * 0.01}, drawn from
    ``generator`` on the CPU."""
    w = torch.randn((num_classes, emb_dim), generator=generator) * 0.01
    return {"weight": w}


def aam_softmax_per_sample(
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    head: Mapping,
    margin: float = 0.2,
    scale: float = 30.0,
) -> torch.Tensor:
    emb = embeddings / torch.linalg.norm(embeddings, dim=-1, keepdim=True)
    weight = head["weight"]
    w = weight / torch.linalg.norm(weight, dim=-1, keepdim=True)
    cos = emb @ w.T
    theta = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
    target_cos = torch.cos(theta + margin)
    onehot = F.one_hot(labels.long(), w.shape[0]).to(cos.dtype)
    logits = scale * (onehot * target_cos + (1 - onehot) * cos)
    # optax.softmax_cross_entropy
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)


def aam_softmax_loss(
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    head: Mapping,
    margin: float = 0.2,
    scale: float = 30.0,
) -> torch.Tensor:
    """Additive angular margin softmax (ArcFace), speechbrain's speaker-id
    objective. labels: (B,) int."""
    return torch.mean(aam_softmax_per_sample(embeddings, labels, head, margin, scale))


def _ecapa_embeddings(params, feats, lengths, cfg, model):
    model = model or ecapa_for(cfg, feats.device)
    return apply_model(model, convert.flatten_pytree(params), feats, lengths)


def ecapa_classification_loss(
    params: Mapping,
    head: Mapping,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    labels: torch.Tensor,
    cfg: EcapaConfig,
    model: Optional[EcapaTDNN] = None,
) -> torch.Tensor:
    emb = _ecapa_embeddings(params, feats, lengths, cfg, model)
    return aam_softmax_loss(emb, labels, head)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _device_of(state: TrainState) -> torch.device:
    return tree_leaves(state.params)[0].device


def _rows(mesh, batch: int) -> slice:
    """This rank's contiguous block of a batch's rows (``batch_spec``'s
    split: uneven blocks allowed); all of them without a mesh."""
    if mesh is None:
        return slice(0, batch)
    block = batch_spec(mesh, batch)
    return slice(block.start, block.stop)


def _on(value, rows: slice, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(value)[rows]
    return t.to(device, dtype) if dtype is not None else t.to(device)


def _all_reduce(mesh, leaves, loss: torch.Tensor) -> torch.Tensor:
    """Sum every rank's gradients and loss in one all-reduce (gloo: on the
    host); the summed gradients replace each leaf's."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    buf = flat.cpu() if mesh.backend == "gloo" else flat
    dist.all_reduce(buf, group=mesh.group)
    if buf is not flat:
        flat.copy_(buf)
    offset = 0
    for p in leaves:
        p.grad = flat[offset : offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat[-1]


def _apply_step(state: TrainState, loss_sum: Callable, rows: slice, batch: int, mesh):
    """One optimizer step on the loss ``loss_sum() / batch`` (the sum over
    this rank's rows), the gradients summed over the mesh's ranks."""
    leaves = tree_leaves(state.params)
    state.optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        if rows.stop > rows.start:
            loss = loss_sum() / batch
            loss.backward()
        else:  # a rank with no rows adds nothing
            loss = torch.zeros((), device=leaves[0].device)
    if mesh is not None:
        loss = _all_reduce(mesh, leaves, loss)
    state.optimizer.step()
    return state._replace(step=state.step + 1), loss.detach()


def make_segmentation_train_step(cfg: PyanNetConfig = PyanNetConfig(), mesh=None):
    """``train_step(state, waveforms (B, samples), labels (B, frames,
    classes)) -> (state, loss)``; numpy or tensors, moved to the params'
    device (with ``mesh``, this rank's block of rows only)."""
    models: Dict = {}

    def train_step(state: TrainState, waveforms, labels):
        device = _device_of(state)
        if device not in models:
            models[device] = pyannet_for(state.params, cfg, device)
        batch = len(waveforms)
        rows = _rows(mesh, batch)
        wav = _on(waveforms, rows, device, torch.float32)
        lab = _on(labels, rows, device, torch.float32)
        return _apply_step(
            state,
            lambda: pit_bce_per_sample(state.params, wav, lab, cfg, models[device]).sum(),
            rows,
            batch,
            mesh,
        )

    return train_step


def make_embedding_train_step(cfg: EcapaConfig = EcapaConfig(), mesh=None):
    """``train_step(state, feats (B, T, n_mels), lengths (B,), labels (B,))
    -> (state, loss)`` over ``{"params": ecapa tree, "head": {"weight"}}``."""
    models: Dict = {}

    def train_step(state: TrainState, feats, lengths, labels):
        device = _device_of(state)
        if device not in models:
            models[device] = ecapa_for(cfg, device)
        batch = len(feats)
        rows = _rows(mesh, batch)
        x = _on(feats, rows, device, torch.float32)
        lens = _on(lengths, rows, device, torch.float32)
        lab = _on(labels, rows, device)

        def loss_sum():
            emb = _ecapa_embeddings(state.params["params"], x, lens, cfg, models[device])
            return aam_softmax_per_sample(emb, lab, state.params["head"]).sum()

        return _apply_step(state, loss_sum, rows, batch, mesh)

    return train_step
