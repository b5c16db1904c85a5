"""The paper's small fully-connected Q-network (§5.4) as a plain list of
``{"w", "b"}`` tensors, weights ``(in, out)`` and applied as ``x @ w``
— the layout of ``repro/core/networks.py``, so parameters carry across
unchanged."""
from __future__ import annotations

import math

import torch


def mlp_init(draws, sizes):
    """He-initialized MLP params for layer ``sizes`` (normal draws at site
    ``"init"``), on ``draws.device``."""
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = draws.normal("init", (a, b)) * math.sqrt(2.0 / a)
        params.append({"w": w, "b": torch.zeros(b, device=draws.device)})
    return params


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """ReLU between layers, none after the last."""
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x
