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


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and the card
    compute it: PyTorch's vectorized CPU ``sqrt`` can be 1 ulp off, so
    the root is taken in float64 and rounded once."""
    return torch.sqrt(x.double()).float()


def global_norm(tree) -> torch.Tensor:
    return _sqrt32(sum(torch.sum(torch.square(g.float()))
                       for g in _leaves(tree)))


def _fma(s: float, x: torch.Tensor, c: torch.Tensor, out: torch.Tensor):
    """``s * x + c`` into the float32 ``out`` with one rounding: the
    reference's step runs under ``jax.jit``, and XLA's CPU compiler (JAX
    0.9.0) contracts these products into fused multiply-adds. Emulated in
    float64, where the product of two float32 values is exact."""
    return torch.add(c.double(), x, alpha=float(np.float32(s)), out=out)


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, updating ``params`` and ``state`` IN PLACE.
    Returns ``(params, state, {"grad_norm", "lr"})``.

    The arithmetic is the reference's as ``jax.jit`` compiles it, on
    every device: the clip scale and ``v / b2c`` are true divisions by
    device tensors (a Python divisor is multiplied by its reciprocal on
    the card, and in ``clip / norm`` on both devices), ``(m / b1c) /
    (sqrt(v / b2c) + eps)`` is the one division ``m / (b1c * (...))``,
    and the moment and parameter updates are fused multiply-adds."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                         / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = float(lr_at(cfg, step))
    f = np.float32
    b1c = torch.tensor(f(1) - f(cfg.b1) ** f(step), device=gnorm.device)
    b2c = torch.tensor(f(1) - f(cfg.b2) ** f(step), device=gnorm.device)
    with torch.no_grad():
        for p, g, m, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"])):
            g = g.float() * scale
            _fma(cfg.b1, m, (1 - cfg.b1) * g, out=m)
            _fma(cfg.b2, v, (1 - cfg.b2) * g * g, out=v)
            u = m / (b1c * (_sqrt32(v / b2c) + cfg.eps))
            if cfg.weight_decay and p.ndim >= 2:
                u = u + cfg.weight_decay * p.float()
            if p.dtype == torch.float32:
                _fma(-lr, u, p, out=p)
            else:
                p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
