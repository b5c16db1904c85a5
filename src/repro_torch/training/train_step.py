"""Training step: loss -> grads -> AdamW update — the port of
``repro/training/train_step.py``.

``jax.value_and_grad`` of ``Model.loss`` becomes ``torch.autograd.grad``
over the params' floating leaves (on the card the attention's gradient
is P2, ``kernels.flash_attention.flash_attention_backward_cuda``); the
update is ``optimizer.apply_updates``, in place. Nothing is jitted: the
step runs eagerly.
"""
from __future__ import annotations

import torch

from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                            init_opt_state, tree_leaves,
                                            tree_unflatten)


def make_train_step(model, opt_cfg: AdamWConfig, *, remat: bool = True):
    """Returns ``train_step(state, batch) -> (state, metrics)`` where
    ``state = {"params", "opt"}`` (``init_state``) and ``batch`` holds
    tensors on the params' device. The params and moments are updated
    IN PLACE. Metrics: ``loss`` and ``aux_loss`` (``Model.loss``'s),
    ``grad_norm`` (before clipping), ``lr`` (a float) and
    ``total_loss`` (the loss differentiated, aux included), as the
    reference's."""

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        trained = [p for p in leaves if p.requires_grad]
        loss, metrics = model.loss(params, batch, remat=remat)
        grads = iter(torch.autograd.grad(loss, trained, allow_unused=True))
        flat = []
        for p in leaves:
            g = next(grads) if p.requires_grad else None
            flat.append(torch.zeros_like(p) if g is None else g)
        params, opt, opt_metrics = apply_updates(
            params, tree_unflatten(params, flat), state["opt"], opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics, total_loss=loss.detach())
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_state(model, seed: int = 0, device=None):
    """``{"params", "opt"}``: ``model.init(seed, device)`` with every
    floating leaf requiring grad, and zero float32 moments."""
    params = model.init(seed, device=device)
    for p in tree_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params)}
