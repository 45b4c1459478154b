"""Seeded random weights at the configuration's widths, made on the device.

One draw of uniform numbers from a generator on the device covers every
leaf of both models; each leaf is a slice of it, scaled to torch's default
bound (1/sqrt(fan in) for convolutions and linear layers, 1/sqrt(hidden)
for the LSTM). Norms start as identities, and the sinc band edges at their
mel-spaced initial values. The same seed gives the same weights.

The program under test receives them as the parameter tree of its
``params`` argument (numpy arrays, nested dicts and lists); the plain
reference keeps the flat dict of device tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .reference import models


def leaves(cfg: Dict):
    return {
        "segmentation": models.pyannet_tree(cfg["pyannet"]),
        "embedding": models.ecapa_tree(cfg["ecapa"]),
    }


def make(cfg: Dict, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"segmentation": {name: tensor}, "embedding": {...}} float32 on
    ``device``, drawn from ``cfg["weights_seed"]``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(cfg["weights_seed"]))
    spec = leaves(cfg)
    total = sum(int(np.prod(shape)) for part in spec.values() for _, shape, _ in part)
    draw = torch.rand(total, generator=gen, device=device) * 2 - 1
    low, band = models.sinc_init(cfg["pyannet"], cfg["sample_rate"])
    fixed = {"sinc_low": low, "sinc_band": band}
    out, at = {}, 0
    for part, items in spec.items():
        out[part] = {}
        for name, shape, kind in items:
            n = int(np.prod(shape))
            if kind[0] == "uniform":
                t = draw[at : at + n].reshape(shape) * kind[1]
                at += n
            elif kind[0] in fixed:
                t = torch.tensor(fixed[kind[0]], dtype=torch.float32, device=device)
            else:
                t = (torch.ones if kind[0] == "ones" else torch.zeros)(shape, device=device)
            out[part][name] = t
    return out


def nested(flat: Dict[str, torch.Tensor]):
    """{dotted name: tensor} -> nested dicts, digit keys as lists, numpy
    leaves: the parameter tree layout the program reads."""
    host = {k: v.detach().cpu() for k, v in flat.items()}
    root: Dict = {}
    for key, value in host.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)

