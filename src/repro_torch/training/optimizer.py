"""AdamW with global-norm clipping — the RL agents' optimizer, the port
of ``repro/training/optimizer.py``.

This is the reference's exact rule, not ``torch.optim.AdamW`` with its
defaults: the clip scale is ``min(1, clip / (norm + 1e-9))``, ``b2`` is
0.95, ``eps`` is added outside ``sqrt(v / b2c)``, and the RL
configuration has no weight decay. State mirrors the params:
``{"m": [...], "v": [...], "step": int}``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def constant_lr_adamw(lr: float, grad_clip: float = 10.0) -> AdamWConfig:
    """The RL agents' optimizer: constant LR, no weight decay."""
    return AdamWConfig(lr=lr, warmup_steps=0, total_steps=10**9,
                       weight_decay=0.0, grad_clip=grad_clip,
                       min_lr_frac=1.0)


def init_opt_state(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": [{k: zeros(v) for k, v in p.items()} for p in params],
            "v": [{k: zeros(v) for k, v in p.items()} for p in params],
            "step": 0}


def lr_at(cfg: AdamWConfig, step: int) -> np.float32:
    """Warmup + cosine schedule, in float32 like the reference."""
    f = np.float32
    step = f(step)
    warm = f(cfg.lr) * step / f(max(1, cfg.warmup_steps))
    prog = np.clip((step - f(cfg.warmup_steps))
                   / f(max(1, cfg.total_steps - cfg.warmup_steps)),
                   f(0), f(1))
    cos = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * f(0.5) * (
        f(1) + np.cos(f(math.pi) * prog))
    return warm if step < cfg.warmup_steps else f(cfg.lr) * cos


def _leaves(tree):
    """Leaves in the reference's pytree order: layer by layer, each
    layer's keys sorted ("b" before "w")."""
    return [p[k] for p in tree for k in sorted(p)]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in _leaves(tree)))


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, updating ``params`` and ``state`` IN PLACE.
    Returns ``(params, state, {"grad_norm", "lr"})``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = float(lr_at(cfg, step))
    f = np.float32
    b1c = float(f(1) - f(cfg.b1) ** f(step))
    b2c = float(f(1) - f(cfg.b2) ** f(step))
    with torch.no_grad():
        for p, g, m, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"])):
            g = g.float() * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if cfg.weight_decay and p.ndim >= 2:
                u = u + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
