"""Checkpoints: flat ``.npz`` files of a parameter pytree, the name map
from that pytree to the port's ``nn.Module`` state dicts, and the
converters between the pytree and the published torch state-dict layouts
(pyannote/segmentation, speechbrain spkrec-ecapa-voxceleb).

The on-disk layout is the JAX package's (models/convert.py there): one
``segmentation.npz`` and one ``embedding.npz``, keys joined with dots, list
indices as digits, arrays in torch-convention shapes. The port reads the
same files, so a checkpoint saved by either package loads in both. Trees
here hold numpy arrays.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .ecapa import EcapaConfig
from .pyannet import PyanNet, PyanNetConfig

# ---------------------------------------------------------------------------
# flat (de)serialization
# ---------------------------------------------------------------------------


def flatten_pytree(tree, prefix="") -> Dict[str, np.ndarray]:
    """{dot-joined key: leaf}; a tensor leaf stays the tensor (a training
    step applies a tree of them, models/training.py), any other becomes a
    numpy array."""
    flat = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            flat.update(flatten_pytree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_pytree(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
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
    ``*_l0`` / ``*_l0_reverse`` (same i,f,g,o gate order). A baked
    filterbank stays ``sincnet.sinc.filters`` (a ``PyanNet`` built with
    ``baked_sinc=True`` holds that buffer; ``build_pyannet`` picks it)."""
    return {
        pyannet_state_key(key): _tensor(value) for key, value in flatten_pytree(tree).items()
    }


def pyannet_state_key(key: str) -> str:
    """A PyanNet pytree key (dot-joined) -> its ``PyanNet`` state-dict name
    (``pyannet_state_from_tree``'s renames)."""
    parts = key.split(".")
    if parts[0] != "lstm":
        return key
    i, direction, name = parts[1], parts[2], parts[3]
    suffix = "_l0" if direction == "fwd" else "_l0_reverse"
    return f"lstm.{i}.{name}{suffix}"


def build_pyannet(
    tree: Optional[Mapping],
    cfg: PyanNetConfig = PyanNetConfig(),
    generator: Optional[torch.Generator] = None,
) -> PyanNet:
    """A ``PyanNet`` holding ``tree``'s weights, its sinc filterbank in the
    tree's form: learnable band edges, or the baked ``filters`` of an
    ingested constant-folded export. ``tree`` None keeps the seeded random
    init (``generator`` is drawn from either way, so models built after
    this one get the same weights whether or not ``tree`` is given)."""
    baked = tree is not None and "filters" in tree["sincnet"]["sinc"]
    model = PyanNet(cfg, generator=generator, baked_sinc=baked)
    if tree is not None:
        model.load_state_dict(pyannet_state_from_tree(tree))
    return model


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


def train_state_from_jax(params, count, mu, nu, step, optimizer=None, device=None):
    """A JAX ``TrainState`` carried into the port's (models/training.py):
    its params tree, optax adam's ``count``, ``mu`` and ``nu`` and its
    ``step``, as numpy arrays (``jax.device_get`` gives them). The params
    go to ``device`` (None: the CUDA card; pass "cpu" for the CPU) and
    Adam's moments and count into ``optimizer`` (a factory, default Adam at
    lr 1e-3), so the next step continues the JAX run."""
    from .training import init_train_state, load_train_state

    state = init_train_state(params, optimizer, device)
    return load_train_state(state, (params, (count, mu, nu), step))


def params_to_jax(seg_model: torch.nn.Module, emb_model: torch.nn.Module) -> Dict:
    """The inverse of ``params_from_jax``: the models' weights as
    ``{"segmentation": tree, "embedding": tree}`` of float32 numpy arrays in
    the JAX package's layout, for ``save_checkpoint``. A baked filterbank
    comes back as ``sincnet.sinc.filters``, as the JAX package saves it."""
    return {"segmentation": pyannet_tree(seg_model), "embedding": ecapa_tree(emb_model)}


def pyannet_tree(model: torch.nn.Module) -> Dict:
    """A PyanNet's weights as the JAX package's pytree (float32 numpy)."""
    seg = {}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        if parts[0] == "lstm":
            name = parts[2]
            direction = "bwd" if name.endswith("_reverse") else "fwd"
            key = f"lstm.{parts[1]}.{direction}.{name.split('_l0')[0]}"
        seg[key] = value.detach().float().cpu().numpy()
    return unflatten_pytree(seg)


def ecapa_tree(model: torch.nn.Module) -> Dict:
    """An ECAPA-TDNN's weights as the JAX package's pytree (float32 numpy,
    the BatchNorm running statistics included)."""
    return unflatten_pytree(
        {
            key: value.detach().float().cpu().numpy()
            for key, value in model.state_dict().items()
            if not key.endswith("num_batches_tracked")
        }
    )



# ---------------------------------------------------------------------------
# the published torch state-dict layouts <-> pytree
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _bn(sd, prefix):
    return {
        "weight": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
        "running_mean": _np(sd[f"{prefix}.running_mean"]),
        "running_var": _np(sd[f"{prefix}.running_var"]),
    }


def _conv(sd, prefix):
    p = {"weight": _np(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _tdnn(sd, prefix):
    """speechbrain TDNNBlock: {prefix}.conv.conv.* + {prefix}.norm.norm.*"""
    return {"conv": _conv(sd, f"{prefix}.conv.conv"), "bn": _bn(sd, f"{prefix}.norm.norm")}


def ecapa_from_speechbrain(state_dict: Mapping, cfg: EcapaConfig = EcapaConfig()) -> Dict:
    """A speechbrain ECAPA_TDNN (spkrec-ecapa-voxceleb embedding_model)
    state dict -> the ECAPA pytree.

    speechbrain module paths: blocks.0 (TDNN), blocks.1..3 (SERes2NetBlock
    with tdnn1 / res2net_block.blocks.N / tdnn2 / se_block.{conv1,conv2}),
    mfa, asp.{tdnn,conv}, asp_bn, fc.
    """
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def se_res2net(i):
        base = f"blocks.{i}"
        return {
            "tdnn1": _tdnn(sd, f"{base}.tdnn1"),
            "res2net": {
                "blocks": [
                    _tdnn(sd, f"{base}.res2net_block.blocks.{j}")
                    for j in range(cfg.res2net_scale - 1)
                ]
            },
            "tdnn2": _tdnn(sd, f"{base}.tdnn2"),
            "se": {
                "conv1": _conv(sd, f"{base}.se_block.conv1.conv"),
                "conv2": _conv(sd, f"{base}.se_block.conv2.conv"),
            },
        }

    return {
        "block0": _tdnn(sd, "blocks.0"),
        "block1": se_res2net(1),
        "block2": se_res2net(2),
        "block3": se_res2net(3),
        "mfa": _tdnn(sd, "mfa"),
        "asp": {
            "tdnn": _tdnn(sd, "asp.tdnn"),
            "conv": _conv(sd, "asp.conv.conv"),
        },
        "asp_bn": _bn(sd, "asp_bn.norm"),
        "fc": _conv(sd, "fc.conv"),
    }


def pyannet_from_pyannote(state_dict: Mapping, cfg: PyanNetConfig = PyanNetConfig()) -> Dict:
    """A pyannote PyanNet (pyannote/segmentation@2022.07) state dict -> the
    PyanNet pytree.

    pyannote module paths: sincnet.wav_norm1d, sincnet.conv1d.{0,1,2},
    sincnet.norm1d.{0,1,2}, lstm.weight_*_l{i}[_reverse], linear.{0,1},
    classifier. The sinc filterbank parameters are the (low_hz_, band_hz_)
    pair of conv1d.0 (asteroid ParamSincFB).
    """
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def pair(prefix):
        return {"weight": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    # sinc parameter naming differs across pyannote/asteroid versions
    low_key = next(k for k in sd if k.endswith("low_hz_"))
    band_key = next(k for k in sd if k.endswith("band_hz_"))

    def lstm_half(i, tag):
        return {
            name: sd[f"lstm.{name}_l{i}{tag}"]
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        }

    return {
        "sincnet": {
            "wav_norm": pair("sincnet.wav_norm1d"),
            "sinc": {"low_hz": sd[low_key], "band_hz": sd[band_key]},
            "norm0": pair("sincnet.norm1d.0"),
            "conv1": _conv(sd, "sincnet.conv1d.1"),
            "norm1": pair("sincnet.norm1d.1"),
            "conv2": _conv(sd, "sincnet.conv1d.2"),
            "norm2": pair("sincnet.norm1d.2"),
        },
        "lstm": [
            {"fwd": lstm_half(i, ""), "bwd": lstm_half(i, "_reverse")}
            for i in range(cfg.lstm_layers)
        ],
        "linear": [pair(f"linear.{i}") for i in range(cfg.linear_layers)],
        "classifier": pair("classifier"),
    }


def ecapa_to_speechbrain(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of ``ecapa_from_speechbrain``: the ECAPA pytree -> the
    spkrec-ecapa-voxceleb embedding_model state-dict key layout."""
    sd: Dict[str, np.ndarray] = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.weight"] = _np(p["weight"])
        if "bias" in p:
            sd[f"{prefix}.bias"] = _np(p["bias"])

    def put_bn(prefix, p):
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.{k}"] = _np(p[k])

    def put_tdnn(prefix, p):
        put_conv(f"{prefix}.conv.conv", p["conv"])
        put_bn(f"{prefix}.norm.norm", p["bn"])

    put_tdnn("blocks.0", params["block0"])
    for i in (1, 2, 3):
        blk = params[f"block{i}"]
        put_tdnn(f"blocks.{i}.tdnn1", blk["tdnn1"])
        for j, sub in enumerate(blk["res2net"]["blocks"]):
            put_tdnn(f"blocks.{i}.res2net_block.blocks.{j}", sub)
        put_tdnn(f"blocks.{i}.tdnn2", blk["tdnn2"])
        put_conv(f"blocks.{i}.se_block.conv1.conv", blk["se"]["conv1"])
        put_conv(f"blocks.{i}.se_block.conv2.conv", blk["se"]["conv2"])
    put_tdnn("mfa", params["mfa"])
    put_tdnn("asp.tdnn", params["asp"]["tdnn"])
    put_conv("asp.conv.conv", params["asp"]["conv"])
    put_bn("asp_bn.norm", params["asp_bn"])
    put_conv("fc.conv", params["fc"])
    return sd


def pyannet_to_pyannote(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of ``pyannet_from_pyannote``: the PyanNet pytree -> the
    pyannote/segmentation state-dict key layout. Needs the parametric
    filterbank: a tree with baked ``filters`` raises."""
    sn = params["sincnet"]
    if "low_hz" not in sn["sinc"]:
        raise ValueError(
            "pytree carries baked sinc filters (no low_hz/band_hz); "
            "cannot export to the parametric pyannote layout"
        )
    sd: Dict[str, np.ndarray] = {
        "sincnet.wav_norm1d.weight": _np(sn["wav_norm"]["weight"]),
        "sincnet.wav_norm1d.bias": _np(sn["wav_norm"]["bias"]),
        "sincnet.conv1d.0.low_hz_": _np(sn["sinc"]["low_hz"]),
        "sincnet.conv1d.0.band_hz_": _np(sn["sinc"]["band_hz"]),
    }
    for i, name in ((0, "norm0"), (1, "norm1"), (2, "norm2")):
        sd[f"sincnet.norm1d.{i}.weight"] = _np(sn[name]["weight"])
        sd[f"sincnet.norm1d.{i}.bias"] = _np(sn[name]["bias"])
    for i, name in ((1, "conv1"), (2, "conv2")):
        sd[f"sincnet.conv1d.{i}.weight"] = _np(sn[name]["weight"])
        sd[f"sincnet.conv1d.{i}.bias"] = _np(sn[name]["bias"])
    for i, layer in enumerate(params["lstm"]):
        for tag, half in (("", layer["fwd"]), ("_reverse", layer["bwd"])):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                sd[f"lstm.{name}_l{i}{tag}"] = _np(half[name])
    for i, lin in enumerate(params["linear"]):
        sd[f"linear.{i}.weight"] = _np(lin["weight"])
        sd[f"linear.{i}.bias"] = _np(lin["bias"])
    sd["classifier.weight"] = _np(params["classifier"]["weight"])
    sd["classifier.bias"] = _np(params["classifier"]["bias"])
    return sd
