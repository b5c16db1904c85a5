"""AdamW with global-norm clipping — the RL agents' and the language
models' optimizer, the port of ``repro/training/optimizer.py``.

This is the reference's exact rule, not ``torch.optim.AdamW`` with its
defaults: the clip scale is ``min(1, clip / (norm + 1e-9))``, ``b2`` is
0.95, ``eps`` is added outside ``sqrt(v / b2c)``, and the RL
configuration has no weight decay. State mirrors the params: ``{"m":
tree, "v": tree, "step": int}``, the moments float32 whatever the
params' dtype.

A tree is the agents' list of ``{"w", "b"}`` dicts or a model's nested
dicts and lists (``models.Model.init``); its leaves run in the
reference's pytree order, dict keys sorted and lists in order
(``tree_leaves``). Weight decay falls on the leaves the reference calls
matrices (``ndim >= 2``) in its own layout, which stacks each segment's
layers on a leading axis: a leaf under ``segments`` (a model's or its
encoder's) counts one dim more than the port's per-layer leaf, so every
leaf there is decayed, norm gains included, and the top-level
``final_norm`` is not (``_decayed``).
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


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts and lists, the structure
    kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves_with_path(tree, path=()):
    """(path, leaf) of every leaf in the reference's pytree order: dict
    keys sorted, lists in order; a path is the tuple of keys and
    indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree of the structure of ``like`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def init_opt_state(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
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


def _decayed(path, p) -> bool:
    """Whether the reference decays this leaf: a matrix (``ndim >= 2``)
    in its layout, where the leaves under ``segments`` carry the stacked
    layer axis the port's per-layer leaves lack."""
    return p.ndim + ("segments" in path) >= 2


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and the card
    compute it: PyTorch's vectorized CPU ``sqrt`` can be 1 ulp off, so
    the root is taken in float64 and rounded once."""
    return torch.sqrt(x.double()).float()


def global_norm(tree) -> torch.Tensor:
    return _sqrt32(sum(torch.sum(torch.square(g.float()))
                       for g in tree_leaves(tree)))


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
        for (path, p), g, m, v in zip(tree_leaves_with_path(params),
                                      tree_leaves(grads),
                                      tree_leaves(state["m"]),
                                      tree_leaves(state["v"])):
            g = g.float() * scale
            _fma(cfg.b1, m, (1 - cfg.b1) * g, out=m)
            _fma(cfg.b2, v, (1 - cfg.b2) * g * g, out=v)
            u = m / (b1c * (_sqrt32(v / b2c) + cfg.eps))
            if cfg.weight_decay and _decayed(path, p):
                u = u + cfg.weight_decay * p.float()
            if p.dtype == torch.float32:
                _fma(-lr, u, p, out=p)
            else:
                p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
