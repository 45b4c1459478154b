"""Training-state checkpoint / resume, in the JAX package's file layout.

Port of the JAX package's utils/checkpoint.py. A pytree (nested dicts,
lists, tuples and named tuples whose leaves are tensors, numpy arrays or
scalars; None holds no leaf) is saved as one flat ``.npz`` of its leaves,
``leaf_0`` ... ``leaf_{n-1}``, in JAX's leaf order: dict keys sorted,
sequences in order. A ``CheckpointManager`` keeps a numbered history,
``ckpt_<step>.npz``, with a ``latest.json`` pointer, and writes each file by
an atomic rename. models/training.py ``train_state_tree`` lays a port
``TrainState`` out as the JAX ``TrainState`` flattens (params, the Adam
count, mu and nu, the step), so either package's trainer resumes from the
other's checkpoints.

Leaves are copied to the host to be written; a tensor leaf is restored
with its template leaf's dtype and device. bfloat16 leaves travel as their
raw bytes (numpy's void dtype), as the JAX package writes them.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^ckpt_(\d+)\.npz$")


# ---------------------------------------------------------------------------
# pytrees (what jax.tree_util gives the JAX package)
# ---------------------------------------------------------------------------


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_flatten_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in JAX's leaf order; paths as
    ``jax.tree_util.keystr`` writes them (``['a'][0]``, ``.field``)."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        out = []
        for key in sorted(tree):
            out += tree_flatten_with_path(tree[key], f"{path}[{key!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += tree_flatten_with_path(getattr(tree, name), f"{path}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += tree_flatten_with_path(child, f"{path}[{i}]")
        return out
    return [(path, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``, same structure."""
    leaves = iter([fn(leaf) for leaf in tree_leaves(tree)])
    return _rebuild(tree, leaves)


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s structure holding ``leaves`` (in JAX's leaf order)."""
    leaves = iter(leaves)
    out = _rebuild(template, leaves)
    if next(leaves, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _rebuild(node, leaves):
    if node is None:
        return None
    if isinstance(node, Mapping):
        return {key: _rebuild(node[key], leaves) for key in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*[_rebuild(child, leaves) for child in node])
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(child, leaves) for child in node)
    return next(leaves)


# ---------------------------------------------------------------------------
# one file
# ---------------------------------------------------------------------------


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16: raw bytes
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Serialize any pytree's leaves to one .npz (atomic rename)."""
    payload = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(tree_leaves(tree))}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _restore_leaf(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V":  # bfloat16 (or another 2-byte type) as bytes
            if leaf.element_size() != arr.dtype.itemsize:
                raise ValueError(f"raw {arr.dtype} bytes do not hold {leaf.dtype}")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(leaf.dtype)
        else:
            t = torch.from_numpy(np.array(arr)).to(leaf.dtype)
        return t.to(leaf.device)
    if hasattr(leaf, "dtype"):
        if arr.dtype.kind == "V":
            return arr.view(leaf.dtype)
        return arr.astype(leaf.dtype)
    return arr


def restore_pytree(path: str, template: Any) -> Any:
    """Rebuild a pytree from ``path`` using ``template``'s structure.

    A tensor leaf comes back as a tensor of the template leaf's dtype on its
    device; a numpy leaf in its dtype. Shape and leaf-count mismatches raise
    with the offending leaf's index and path.
    """
    pairs = tree_flatten_with_path(template)
    with np.load(path) as data:
        if len(data.files) != len(pairs):
            raise ValueError(
                f"checkpoint {path} has {len(data.files)} leaves; "
                f"template has {len(pairs)}"
            )
        restored = []
        for i, (keypath, leaf) in enumerate(pairs):
            arr = data[f"leaf_{i}"]
            want_shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if tuple(arr.shape) != tuple(want_shape):
                raise ValueError(
                    f"leaf {i} ({keypath}): checkpoint shape {arr.shape} != "
                    f"template shape {want_shape}"
                )
            restored.append(_restore_leaf(arr, leaf))
    return tree_unflatten(template, restored)


# ---------------------------------------------------------------------------
# a numbered history
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Numbered checkpoint history in one directory.

    Layout::

        <dir>/ckpt_<step>.npz     one file per saved step
        <dir>/latest.json         {"step": N, "file": "ckpt_N.npz"}

    ``keep`` bounds history size (oldest deleted first; ``None`` = keep all).
    """

    def __init__(self, directory: str, keep: Optional[int] = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        pointer = os.path.join(self.directory, "latest.json")
        if os.path.exists(pointer):
            with open(pointer) as f:
                step = json.load(f)["step"]
            if os.path.exists(self.path(step)):
                return step
        steps = self._steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        """The file that holds (or would hold) ``step``."""
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def save(self, step: int, tree: Any) -> str:
        path = self.path(step)
        save_pytree(path, tree)
        pointer = os.path.join(self.directory, "latest.json")
        tmp = pointer + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "file": os.path.basename(path)}, f)
        os.replace(tmp, pointer)
        if self.keep is not None:
            for old in self._steps()[: -self.keep]:
                os.unlink(self.path(old))
        return path

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore ``step`` (default: latest). Returns (tree, step)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_pytree(self.path(step), template), step
