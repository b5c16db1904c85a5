"""Intelligent Orchestrator (paper Fig. 2/4) — the port of
``repro/core/orchestrator.py``: agent <-> environment glue, training
with convergence tracking, and exploitation over real serving engines.

``train_agent`` reproduces the paper's §6 protocol: train online against
the environment, and every ``check_every`` steps score the *greedy*
policy against the brute-force optimum (the paper's "prediction
accuracy"); convergence = first step where the greedy expected response
is within ``tol`` of optimal and stays there for ``patience`` consecutive
checks (the paper reports 100% prediction accuracy at convergence).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.core.bruteforce import bruteforce_optimal
from repro_torch.core.env import EndEdgeCloudEnv
from repro_torch.core.spaces import A_CLOUD, A_EDGE
from repro_torch.fleet import dynamics


@dataclasses.dataclass
class TrainResult:
    converged_at: Optional[int]
    steps: int
    best_ms: float                 # brute-force optimal expected response
    greedy_ms: float               # final greedy expected response
    greedy_acc: float
    greedy_action: int
    history: List[dict]
    wall_seconds: float

    @property
    def prediction_accuracy(self) -> float:
        """1.0 if the greedy decision matches the brute-force optimum's
        expected response (paper §6.1)."""
        return 1.0 if self.greedy_ms <= self.best_ms * 1.005 + 1e-9 else \
            self.best_ms / max(self.greedy_ms, 1e-9)


def train_agent(agent, env: EndEdgeCloudEnv, max_steps: int,
                check_every: int = 200, tol: float = 0.01,
                patience: int = 3, log_every: int = 0) -> TrainResult:
    actions = getattr(agent, "actions", None)
    best_a, best_ms, _, _ = bruteforce_optimal(env, env.threshold, actions)
    state = env.reset()
    t0 = time.perf_counter()
    history = []
    converged_at = None
    streak = 0
    for step in range(1, max_steps + 1):
        a = agent.act(state)
        nxt, r, info = env.step(a)
        agent.update(state, a, r, nxt)
        state = nxt
        if step % check_every == 0:
            g = agent.greedy_action(state)
            g_ms, g_acc = env.expected_response(g)
            feasible = bool(dynamics.feasible(g_acc, env.threshold))
            ok = feasible and g_ms <= best_ms * (1 + tol)
            streak = streak + 1 if ok else 0
            history.append({"step": step, "greedy_ms": g_ms,
                            "greedy_acc": g_acc, "optimal_ms": best_ms,
                            "eps": agent.eps, "ok": ok})
            if log_every and step % log_every == 0:
                print(f"  step {step:>8d} greedy {g_ms:8.2f} ms "
                      f"(opt {best_ms:8.2f}) eps {agent.eps:.3f}")
            if streak >= patience and converged_at is None:
                converged_at = step - (patience - 1) * check_every
                break
    g = agent.greedy_action(state)
    g_ms, g_acc = env.expected_response(g)
    return TrainResult(converged_at, step, best_ms, g_ms, g_acc, g, history,
                       time.perf_counter() - t0)


class IntelligentOrchestrator:
    """Runtime component (cloud-hosted in the paper): receives the request
    wave, consults the trained agent, and dispatches to serving engines.

    engines: {tier: {variant_id: ServingEngine}} — optional; without
    engines the orchestrator is a pure policy head over the env model.
    """

    TIER_OF_ACTION = {A_EDGE: "E", A_CLOUD: "C"}

    def __init__(self, agent, env: EndEdgeCloudEnv,
                 engines: Optional[Dict] = None):
        self.agent = agent
        self.env = env
        self.engines = engines or {}

    def decide(self, state) -> tuple:
        """Greedy orchestration decision for the current state."""
        joint = self.agent.greedy_action(state)
        return self.env.spec.decode_action(joint)

    def dispatch(self, per_user, prompts):
        """Execute decisions on real engines: user ``u`` with action ``a <
        8`` runs variant ``d{a}`` on the device tier ``S``, 8 / 9 run
        ``d0`` on the edge ``E`` / cloud ``C``. Returns per-user
        (variant, tier, response_ms). Raises ``KeyError`` naming the
        (tier, variant) when ``engines`` has no such engine."""
        out = []
        for u, a in enumerate(per_user):
            if a < A_EDGE:
                tier, variant = "S", f"d{a}"
            else:
                tier, variant = self.TIER_OF_ACTION[int(a)], "d0"
            eng = self.engines.get(tier, {}).get(variant)
            if eng is None:
                raise KeyError(f"no serving engine for tier {tier!r}, "
                               f"variant {variant!r} (user {u}'s action "
                               f"{int(a)})")
            _, wall = eng.generate(prompts[u][None, :], max_new_tokens=4)
            out.append((variant, tier, wall * 1e3))
        return out
