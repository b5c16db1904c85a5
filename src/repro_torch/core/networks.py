"""The paper's small fully-connected Q-network (§5.4) as a plain list of
``{"w", "b"}`` tensors, weights ``(in, out)`` and applied as ``x @ w``
— the layout of ``repro/core/networks.py``, so parameters carry across
unchanged — and the factored per-user Q head over it."""
from __future__ import annotations

import math

import torch

from repro_torch.core.spaces import N_PER_USER_ACTIONS


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


def make_factored_q(n_users: int, allowed):
    """Factored per-user Q head over an ``(n_users, N_PER_USER_ACTIONS)``
    allowed-action mask (numpy, or a tensor on the params' device).
    Returns ``per_user_q(params, s)`` mapping ``(B, state_dim) -> (B,
    n_users, N_PER_USER_ACTIONS)`` with disallowed entries at -1e30, so
    argmax and max never pick them."""
    allowed = torch.as_tensor(allowed, dtype=torch.bool)

    def per_user_q(params, s):
        q = mlp_apply(params, s).reshape(-1, n_users, N_PER_USER_ACTIONS)
        return torch.where(allowed.to(q.device)[None], q, -1e30)

    return per_user_q
