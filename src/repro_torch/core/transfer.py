"""Transfer-learning strategy (paper §6.2.1, Fig. 7) — the port of
``repro/core/transfer.py``: train a model with the Min accuracy
threshold from scratch, then initialize agents for other thresholds from
it to cut convergence time (paper: up to 12.5x for QL, 3.3x for DQL)."""
from __future__ import annotations

from typing import Callable

from repro_torch.core.env import EndEdgeCloudEnv
from repro_torch.core.orchestrator import train_agent


def transfer_experiment(make_agent: Callable[[], object],
                        make_env: Callable[[float], EndEdgeCloudEnv],
                        source_threshold: float, target_threshold: float,
                        max_steps: int, check_every: int = 200):
    """Returns (scratch: TrainResult, transferred: TrainResult).

    make_agent() must return a fresh agent; make_env(threshold) a fresh
    environment. The source agent trains at ``source_threshold`` (the
    paper uses Min); the transferred agent warm-starts from it before
    training at ``target_threshold``.
    """
    src_agent = make_agent()
    src_env = make_env(source_threshold)
    train_agent(src_agent, src_env, max_steps, check_every=check_every)

    scratch = train_agent(make_agent(), make_env(target_threshold),
                          max_steps, check_every=check_every)

    warm = make_agent()
    warm.warm_start_from(src_agent)
    transferred = train_agent(warm, make_env(target_threshold), max_steps,
                              check_every=check_every)
    return scratch, transferred
