"""Brute-force oracle (paper §4.2.2 Eq. 5-6, Table 11 last column) — the
port of ``repro/core/bruteforce.py``.

Searches the entire joint action space (10^N) against the environment's
noise-free expected model, as the paper's design-time "true optimal
configuration" that scores the agents' prediction accuracy. Every
candidate is evaluated in one batched call on the environment's device
(float64, 10^5 x 5 at N=5), and the first index of the smallest feasible
mean response wins, as numpy's ``argmin`` picks it in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.env import EndEdgeCloudEnv
from repro_torch.fleet.dynamics import feasible as _feasible


def bruteforce_optimal(env: EndEdgeCloudEnv, threshold: float,
                       actions: Optional[np.ndarray] = None):
    """Returns (best_action, best_ms, best_acc, n_evaluated)."""
    actions = env.spec.all_actions() if actions is None else actions
    ms, acc = env.expected_response_batch(actions)
    feasible = _feasible(acc, threshold)
    if not bool(feasible.any()):
        raise ValueError("no feasible action for threshold %.2f" % threshold)
    i = int(torch.argmin(torch.where(feasible, ms, torch.inf)))
    best_ms, best_acc = torch.stack([ms[i], acc[i]]).tolist()
    return int(actions[i]), best_ms, best_acc, len(actions)


def bruteforce_complexity(n_users: int) -> float:
    """Eq. 6: |S| x |A| state-action pairs the naive search visits."""
    l_end = 2 * 2 * 2
    l_up = 9 * 2 * 2
    return (l_end ** n_users) * (l_up ** 2) * (10.0 ** n_users)
