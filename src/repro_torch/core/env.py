"""Multi-user end-edge-cloud environment (paper §3, §5) — the port of
``repro/core/env.py``: the stateful single-cell gym view over the
calibrated latency/accuracy model of ``repro_torch.fleet.dynamics``.

The model runs on ``device`` (``cuda`` unless the caller passes
``device="cpu"``) in float64, the type the reference's numpy path
computes in. Float64 matters: ``feasible`` has an absolute slack of
1e-9, and many joint actions' mean accuracies land on a goal within it
(at N=5 and the 80% goal, 240 of the 10^5 actions), 24 of which a
float32 mean moves across it. Means over the users are summed left to right, as
numpy sums a row of fewer than eight, so decisions whose per-user times
are permutations of each other tie, or not, exactly as in the reference,
and the brute force's first-index argmin picks the same action.

Random draws — the response-time noise of ``step`` and the exogenous
background load's AR(1) innovation — come from
``np.random.default_rng(seed)`` in the reference's order, not through
``repro_torch.rng.Draws`` as the rest of the port draws: the
environment is a host-side, one-step-at-a-time loop over numpy values in
both packages, so sharing the generator gives both the same draws, and
their trajectories can be compared step by step with nothing injected.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.spaces import (A_CLOUD, A_EDGE, CLOUD_CPU_LEVELS,
                                     EDGE_CPU_LEVELS, N_PER_USER_ACTIONS,
                                     SpaceSpec)
from repro_torch.fleet import dynamics
from repro_torch.fleet.dynamics import (A_FP32, A_INT8, B_FP32, B_INT8,
                                        CLOUD_LINK_CAP, EDGE_LINK_CAP,
                                        EXPERIMENTS, IS_INT8, MACS,
                                        MAX_RESPONSE_MS, MEM_BUSY_PENALTY,
                                        Scenario, T_HOP_CLOUD, T_ORCH,
                                        T_UP_EDGE, TIER_CORES, TIER_SPEED,
                                        TOP1, TOP5, t_comp_device)

__all__ = [
    "EndEdgeCloudEnv", "Scenario", "EXPERIMENTS", "THRESHOLDS",
    "MACS", "IS_INT8", "TOP5", "TOP1", "t_comp_device",
    "A_FP32", "B_FP32", "A_INT8", "B_INT8", "TIER_SPEED", "TIER_CORES",
    "T_ORCH", "T_UP_EDGE", "T_HOP_CLOUD", "EDGE_LINK_CAP", "CLOUD_LINK_CAP",
    "MEM_BUSY_PENALTY", "MAX_RESPONSE_MS",
]


# paper §6.1.1 accuracy thresholds (Top-5 averages)
THRESHOLDS = {"Min": 0.0, "80%": 80.0, "85%": 85.0, "89%": 89.0, "Max": 89.9}

F64 = torch.float64


def _user_mean(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mean over the last (user) axis, summed left to right and divided
    by ``n``, the user count as a tensor on ``x``'s device (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    rounds otherwise than numpy's quotient)."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total / n


class EndEdgeCloudEnv:
    """Gym-style multi-user orchestration environment."""

    def __init__(self, n_users: int, scenario: Optional[Scenario] = None,
                 accuracy_threshold: float = 0.0, seed: int = 0,
                 noise: float = 0.02, exogenous: bool = False, device=None):
        self.device = resolve_device(device)
        self.spec = SpaceSpec(n_users)
        self.n = n_users
        self.scenario = scenario or EXPERIMENTS["EXP-A"]
        if len(self.scenario.end_b) < n_users:
            raise ValueError("scenario must cover all users")
        self.threshold = accuracy_threshold
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.exogenous = exogenous
        self._end_b = torch.tensor(self.scenario.end_b[:n_users],
                                   device=self.device)
        self._edge_b = torch.tensor(self.scenario.edge_b, device=self.device)
        self._place = N_PER_USER_ACTIONS ** torch.arange(
            n_users - 1, -1, -1, device=self.device)
        self._n = torch.tensor(float(n_users), dtype=F64, device=self.device)
        self._last_counts = (0, 0)      # jobs at (edge, cloud) last step
        self._bg = np.zeros(2)          # exogenous background load, AR(1)
        self.reset()

    # ------------------------------------------------------------------
    def _cpu_levels(self):
        ne, nc = self._last_counts
        bg_e, bg_c = self._bg if self.exogenous else (0.0, 0.0)
        p_e = int(np.clip(round(ne / self.n * (EDGE_CPU_LEVELS - 1) + bg_e),
                          0, EDGE_CPU_LEVELS - 1))
        p_c = int(np.clip(round(nc / self.n * (CLOUD_CPU_LEVELS - 1) + bg_c),
                          0, CLOUD_CPU_LEVELS - 1))
        return p_e, p_c

    def _observe(self) -> tuple:
        p_e, p_c = self._cpu_levels()
        m_e = int(self._last_counts[0] > dynamics.EDGE_MEM_BUSY_AT)
        m_c = int(self._last_counts[1] > dynamics.CLOUD_MEM_BUSY_AT)
        ends = [(0, 0, self.scenario.end_b[i]) for i in range(self.n)]
        return self.spec.state_tuple(p_e, m_e, self.scenario.edge_b,
                                     p_c, m_c, self.scenario.edge_b, ends)

    def reset(self) -> tuple:
        self._last_counts = (0, 0)
        self._bg = np.zeros(2)
        return self._observe()

    # ------------------------------------------------------------------
    def _per_user(self, per_user, counts=None):
        """(response ms, top-5 accuracy) of each user of one decision,
        computed on the device, as float64 numpy arrays."""
        pu = torch.tensor(np.asarray(per_user, np.int64), device=self.device)
        t = dynamics.response_times(pu, self._end_b, self._edge_b,
                                    counts=counts, dtype=F64)
        acc = dynamics.accuracies(pu, dtype=F64)
        t, acc = torch.stack([t, acc]).cpu().numpy()
        return t, acc

    def response_times(self, per_user: Sequence[int], *, noisy: bool = True,
                       counts: Optional[Tuple[int, int]] = None):
        """Vector of response times (ms) for a joint decision, as numpy
        float64; with ``noisy``, times a clipped normal draw per user."""
        t, _ = self._per_user(per_user, counts)
        if noisy and self.noise:
            t = t * self.rng.normal(1.0, self.noise, t.shape).clip(0.8, 1.2)
        return t

    def accuracies(self, per_user) -> np.ndarray:
        return self._per_user(per_user)[1]

    def expected_response(self, joint_action: int) -> Tuple[float, float]:
        """(mean response ms, mean top-5 accuracy), noise-free."""
        t, acc = self._per_user(self.spec.decode_action(joint_action))
        return float(t.mean()), float(acc.mean())

    def _decode_actions(self, actions) -> torch.Tensor:
        """(K,) joint ids -> (K, N) int64 per-user ids on the device."""
        a = torch.as_tensor(np.asarray(actions, np.int64), device=self.device)
        return a[:, None] // self._place % N_PER_USER_ACTIONS

    def expected_response_batch(self, actions):
        """(K,) joint actions -> (mean_ms (K,), mean_acc (K,)), float64
        tensors on the device: every candidate in one batched call."""
        pu = self._decode_actions(actions)
        t = dynamics.response_times(pu, self._end_b, self._edge_b, dtype=F64)
        return (_user_mean(t, self._n),
                _user_mean(dynamics.accuracies(pu, dtype=F64), self._n))

    # ------------------------------------------------------------------
    def step(self, joint_action: int):
        """Returns (next_state, reward, info). Reward per paper Eq. 4."""
        per_user = self.spec.decode_action(joint_action)
        t, acc_u = self._per_user(per_user)
        if self.noise:
            t = t * self.rng.normal(1.0, self.noise, t.shape).clip(0.8, 1.2)
        acc = float(acc_u.mean())
        avg = float(t.mean())
        ok = bool(dynamics.feasible(acc, self.threshold))
        reward = float(dynamics.reward(avg, acc, self.threshold))
        self._last_counts = (int((np.asarray(per_user) == A_EDGE).sum()),
                             int((np.asarray(per_user) == A_CLOUD).sum()))
        if self.exogenous:
            self._bg = 0.9 * self._bg + self.rng.normal(0, 0.5, 2)
        nxt = self._observe()
        info = {"avg_response_ms": avg, "avg_accuracy": acc,
                "violated": not ok,
                "per_user_ms": t, "decision": per_user}
        return nxt, reward, info
