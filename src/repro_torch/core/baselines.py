"""Baselines (paper §6.1) — the port of ``repro/core/baselines.py``:
fixed strategies and the SOTA [36] offloading-only RL agent (offloading
decisions only, always the most-accurate model)."""
from __future__ import annotations

from repro_torch.core.dqn import DQNAgent, DQNConfig
from repro_torch.core.env import EndEdgeCloudEnv
from repro_torch.core.qlearning import QLearningAgent, QLearningConfig
from repro_torch.core.spaces import A_CLOUD, A_EDGE, SpaceSpec, \
    restricted_actions


def fixed_strategy_action(spec: SpaceSpec, strategy: str) -> int:
    """'device' | 'edge' | 'cloud' — all users, most-accurate model d0."""
    per = {"device": 0, "edge": A_EDGE, "cloud": A_CLOUD}[strategy]
    return spec.encode_action([per] * spec.n_users)


def fixed_strategy_response(env: EndEdgeCloudEnv, strategy: str):
    a = fixed_strategy_action(env.spec, strategy)
    return env.expected_response(a)


def make_sota_agent(spec: SpaceSpec, *, algo: str = "q", seed: int = 0,
                    cfg=None, device=None):
    """SOTA [36]: same learner, action space restricted to computation
    offloading with d0 (3^N joint actions). ``device`` places the DQN
    learner's network (``cuda`` unless the caller passes ``"cpu"``)."""
    acts = restricted_actions(spec)
    if algo == "q":
        return QLearningAgent(spec, cfg or QLearningConfig(), actions=acts,
                              seed=seed)
    return DQNAgent(spec, cfg or DQNConfig(form="factored"), actions=acts,
                    seed=seed, device=device)
