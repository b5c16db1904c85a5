"""The fleet loop's fused ops, dispatched by the device of their tensors:
a CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor
launches the hand-written kernel or raises. There is no fallback from
one to the other and no switch to choose."""
from __future__ import annotations

import torch

from repro_torch.kernels import dqn_head as _dqn_head
from repro_torch.kernels import tabular_rl as _tabular_rl


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused op path for device {t.device}")
    return t.device.type


def fused_tabular_update(q, s, a, r, s2, *, alpha: float, gamma: float):
    """Fused tabular act+update: ``q`` (cells, S, K) f32 is updated IN
    PLACE; ``s``/``a``/``s2`` (cells,) int32, ``r`` (cells,) f32.
    Returns ``(q, greedy2, td)``; see ``ref.fused_tabular_ref``."""
    if _route(q) == "cpu":
        return _tabular_rl.plain(q, s, a, r, s2, alpha=alpha, gamma=gamma)
    return _tabular_rl.tabular_rl_cuda(q, s, a, r, s2, alpha=alpha,
                                       gamma=gamma)


def dqn_head(active, member, end_b, agg, params, allowed, acc_table, *,
             threshold: float, topk: int):
    """Fused featurize + constraint-aware greedy head.

    active/member/end_b: (cells, N) f32; agg: (cells, 8) f32 cell
    aggregates; params: the shared MLP (``[{"w", "b"}] * 3``, weights
    ``(in, out)``); allowed: (N, A) bool or 0/1 mask; acc_table: (A,)
    f32 accuracy ladder. Returns ``(dec, q)``; see ``ref.dqn_head_ref``.
    """
    (w1, b1), (w2, b2), (w3, b3) = [(p["w"], p["b"]) for p in params]
    allowed_f = allowed.to(torch.float32)
    fn = _dqn_head.plain if _route(active) == "cpu" else \
        _dqn_head.dqn_head_cuda
    return fn(active, member, end_b, agg, w1, b1, w2, b2, w3, b3, allowed_f,
              acc_table, threshold=threshold, topk=topk)
