"""Checkpoints: flat ``.npz`` files of a parameter pytree, and the name map
from that pytree to the port's ``nn.Module`` state dicts.

The on-disk layout is the JAX package's (models/convert.py there): one
``segmentation.npz`` and one ``embedding.npz``, keys joined with dots, list
indices as digits, arrays in torch-convention shapes. The port reads the
same files, so a checkpoint saved by either package loads in both.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# flat (de)serialization
# ---------------------------------------------------------------------------


def flatten_pytree(tree, prefix="") -> Dict[str, np.ndarray]:
    flat = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            flat.update(flatten_pytree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_pytree(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def unflatten_pytree(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(directory: str, params: Dict) -> None:
    """Write params["segmentation"] / params["embedding"] as .npz files."""
    os.makedirs(directory, exist_ok=True)
    for name, tree in params.items():
        np.savez(os.path.join(directory, f"{name}.npz"), **flatten_pytree(tree))


def load_checkpoint(directory: str) -> Dict:
    """{"segmentation": tree, "embedding": tree} of numpy arrays."""
    params = {}
    for name in ("segmentation", "embedding"):
        path = os.path.join(directory, f"{name}.npz")
        if os.path.exists(path):
            with np.load(path) as data:
                params[name] = unflatten_pytree({k: data[k] for k in data.files})
    if not params:
        raise FileNotFoundError(f"no checkpoint files in {directory}")
    return params


# ---------------------------------------------------------------------------
# pytree -> nn.Module state dicts
# ---------------------------------------------------------------------------


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def pyannet_state_from_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """PyanNet pytree -> ``models.pyannet.PyanNet`` state dict. The only
    renames are the LSTM's: layer i's ``fwd``/``bwd`` gate blocks become
    the single-layer bidirectional ``nn.LSTM`` parameters
    ``*_l0`` / ``*_l0_reverse`` (same i,f,g,o gate order)."""
    state = {}
    for key, value in flatten_pytree(tree).items():
        parts = key.split(".")
        if parts[0] == "lstm":
            i, direction, name = parts[1], parts[2], parts[3]
            suffix = "_l0" if direction == "fwd" else "_l0_reverse"
            key = f"lstm.{i}.{name}{suffix}"
        state[key] = _tensor(value)
    return state


def ecapa_state_from_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """ECAPA pytree -> ``models.ecapa.EcapaTDNN`` state dict. Names match
    one to one; every BatchNorm also gets its ``num_batches_tracked``."""
    state = {}
    for key, value in flatten_pytree(tree).items():
        state[key] = _tensor(value)
        if key.endswith(".running_var"):
            state[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def params_from_jax(
    params: Mapping,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """{"segmentation": tree, "embedding": tree} (numpy or JAX arrays, as
    ``load_checkpoint`` or the JAX package's init gives them) ->
    (pyannet_state, ecapa_state) for ``load_state_dict``."""
    return (
        pyannet_state_from_tree(params["segmentation"]),
        ecapa_state_from_tree(params["embedding"]),
    )


def params_to_jax(seg_model: torch.nn.Module, emb_model: torch.nn.Module) -> Dict:
    """The inverse of ``params_from_jax``: the models' weights as
    ``{"segmentation": tree, "embedding": tree}`` of float32 numpy arrays in
    the JAX package's layout, for ``save_checkpoint``."""
    seg = {}
    for key, value in seg_model.state_dict().items():
        parts = key.split(".")
        if parts[0] == "lstm":
            name = parts[2]
            direction = "bwd" if name.endswith("_reverse") else "fwd"
            key = f"lstm.{parts[1]}.{direction}.{name.split('_l0')[0]}"
        seg[key] = value.detach().float().cpu().numpy()
    emb = {
        key: value.detach().float().cpu().numpy()
        for key, value in emb_model.state_dict().items()
        if not key.endswith("num_batches_tracked")
    }
    return {"segmentation": unflatten_pytree(seg), "embedding": unflatten_pytree(emb)}
