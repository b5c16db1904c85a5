"""Epsilon-greedy tabular Q-Learning agent (paper Algorithm 1) — the port
of ``repro/core/qlearning.py``.

The Q-table is lazily materialized: rows (one per *visited* state) are
allocated on first visit, so the full Table-3 state space (42 M states
at N=5) is never built, as the paper's runtime agent behaves. The update
is Algorithm 1 lines 11-13:

  Q(S,A) <- Q(S,A) + alpha [R + gamma Q(S', argmax_a Q(S',a)) - Q(S,A)]

This agent does no device work, in either package: its table is a dict
of float32 numpy rows on the host, its arithmetic is the reference's
(Python floats mixed with float32 rows, so the rows are bit-equal), and
its draws come from ``np.random.default_rng(seed)`` as the reference's
do. Moving a row of ten floats to a card each step would add a
synchronisation and nothing else; the device work of the loop is the
environment's (``core.env``). Hyper-parameters default to the paper's
Table 7 (alpha=0.9, per-N epsilon decay). The agent takes a restricted
action set (the SOTA [36] offloading-only baseline uses {local-d0, edge,
cloud}^N).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.spaces import SpaceSpec

# paper Table 7: per-user-count epsilon decay for Q-Learning
PAPER_EPS_DECAY = {1: 1e-1, 2: 1e-2, 3: 1e-2, 4: 1e-3, 5: 1e-4}


@dataclasses.dataclass
class QLearningConfig:
    alpha: float = 0.9               # paper Table 7
    gamma: float = 0.1               # paper §5.4: low discount converges best
    eps_start: float = 1.0
    eps_decay: Optional[float] = None  # None -> paper Table 7 by n_users
    eps_min: float = 0.01


class QLearningAgent:
    def __init__(self, spec: SpaceSpec, cfg: Optional[QLearningConfig] = None,
                 actions: Optional[np.ndarray] = None, seed: int = 0):
        self.spec = spec
        self.cfg = cfg or QLearningConfig()
        if self.cfg.eps_decay is None:
            decay = PAPER_EPS_DECAY.get(spec.n_users, 1e-4)
            self.cfg = dataclasses.replace(self.cfg, eps_decay=decay)
        self.actions = (spec.all_actions() if actions is None
                        else np.asarray(actions))
        self.n_actions = len(self.actions)
        self._aidx = {int(a): i for i, a in enumerate(self.actions)}
        self.q: Dict[tuple, np.ndarray] = {}
        self.eps = self.cfg.eps_start
        self.rng = np.random.default_rng(seed)
        self.steps = 0

    # ------------------------------------------------------------------
    def _row(self, state: tuple) -> np.ndarray:
        row = self.q.get(state)
        if row is None:
            row = np.zeros(self.n_actions, np.float32)
            self.q[state] = row
        return row

    def greedy_action(self, state: tuple) -> int:
        return int(self.actions[int(np.argmax(self._row(state)))])

    def act(self, state: tuple) -> int:
        if self.rng.random() < self.eps:
            return int(self.actions[self.rng.integers(self.n_actions)])
        return self.greedy_action(state)

    def update(self, state, action: int, reward: float, next_state):
        row = self._row(state)
        nxt = self._row(next_state)
        i = self._aidx[int(action)]
        td = reward + self.cfg.gamma * float(nxt.max()) - row[i]
        row[i] += self.cfg.alpha * td
        self.steps += 1
        # multiplicative decay per invocation (paper: "decay the exploration
        # by epsilon decay parameter per agent invocation")
        self.eps = max(self.cfg.eps_min, self.eps * (1.0 - self.cfg.eps_decay))

    # transfer learning (paper Fig. 7): warm-start from another agent
    def warm_start_from(self, other: "QLearningAgent"):
        for s, row in other.q.items():
            self.q[s] = row.copy()

    @property
    def table_entries(self) -> int:
        return len(self.q) * self.n_actions
