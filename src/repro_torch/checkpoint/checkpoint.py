"""Minimal npz+json checkpointing of trees of dicts and lists (a model's
params, optimizer state, RL agents) — the port of
``repro/checkpoint/checkpoint.py``, in its on-disk format, so a file
either package writes the other reads.

Leaves are saved flattened under their tree paths, dict keys (sorted)
and list indices joined by ``/``, in ``path + ".npz"``; the sidecar
``path + ".json"`` maps each key to its dtype's name. bfloat16, which
numpy lacks, is stored as its uint16 bit patterns: a torch bfloat16
tensor is viewed as int16 on the host and that as uint16 (and back on
load), so neither JAX nor ``ml_dtypes`` is needed. A leaf is a torch
tensor (on any device), a numpy array or a Python number.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.training.optimizer import (tree_leaves_with_path,
                                            tree_unflatten)

_BITCAST = {"bfloat16": np.uint16}


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf):
    """(numpy array, dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    dtypes, stored = {}, {}
    for p, leaf in tree_leaves_with_path(tree):
        key = _key(p)
        stored[key], dtypes[key] = _host(leaf)
    np.savez(path + ".npz", **stored)
    with open(path + ".json", "w") as f:
        json.dump(dtypes, f)


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (shapes must match): each
    leaf in ``like``'s type, dtype and device."""
    data = np.load(path + ".npz")
    with open(path + ".json") as f:
        dtypes = json.load(f)
    leaves = []
    for p, leaf in tree_leaves_with_path(like):
        key = _key(p)
        arr = data[key]
        if dtypes[key] in _BITCAST:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if isinstance(leaf, torch.Tensor):
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} in the file, "
                                 f"{tuple(leaf.shape)} expected")
            leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
        elif isinstance(leaf, np.ndarray):
            leaves.append(t.float().numpy().astype(leaf.dtype)
                          if t.dtype == torch.bfloat16
                          else arr.astype(leaf.dtype))
        else:
            leaves.append(type(leaf)(arr))
    return tree_unflatten(like, leaves)
