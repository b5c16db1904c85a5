"""Serving launcher — the port of ``repro/launch/serve.py``: the
three-tier engine set over one config's variant ladder
(``build_engines``), which ``FleetOrchestrator.route(dispatch=...)``
drains routed requests into, and the RL-orchestrated loop of the paper's
Fig. 4 runtime (``main``): train the single-cell orchestration agent
(``repro_torch.core``), then decide each wave of requests and serve every
user's decided (tier, variant) on its engine.

    python -m repro_torch.launch.serve --arch edge-ladder --requests 4
    python -m repro_torch.launch.serve --arch gemma3-4b --device cpu
    python -m repro_torch.launch.serve --device cpu --train-steps 2000

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engines
    engines = build_engines(get_config("edge-ladder"))
    mamba = build_engines(get_config("falcon-mamba-7b"), variants=("d0", "d4"))
    gemma3 = build_engines(get_config("gemma3-4b"), variants=("d0", "d4"),
                           max_len=2064)

An engine's requests carry tokens only, as the reference's do, so a
``vlm`` config (PaliGemma, whose prefill also takes image embeddings) is
served through ``Model.prefill`` / ``decode`` and ``build_engines``
refuses it. ``--arch`` takes every other config, cut by ``reduced`` but
the edge ladder.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import (EXPERIMENTS, EndEdgeCloudEnv,
                              IntelligentOrchestrator, QLearningAgent,
                              train_agent)
from repro_torch.core.spaces import A_EDGE, allowed_per_user
from repro_torch.models import build_model
from repro_torch.models.variants import build_ladder
from repro_torch.serving.engine import ServingEngine

#: per-tier compute_scale (the paper's 1 / 2 / 4 vCPUs, Table 6)
TIER_SCALES = {"S": 1.0, "E": 2.0, "C": 4.0}


def variant_seed(seed: int, vid: str) -> int:
    """The weight seed of variant ``vid`` under ``seed`` (stable across
    processes)."""
    return int(np.random.SeedSequence([int(seed), int(vid[1:])])
               .generate_state(1)[0])


def build_engines(cfg, variants=("d0", "d4", "d7"), max_len: int = 64,
                  hop_ms=None, device=None, seed: int = 0):
    """One engine per (tier, variant): every listed variant on the device
    tier ``S``, and ``d0`` also on the edge ``E`` and cloud ``C`` tiers
    (the paper's setting), the tiers emulated by ``compute_scale``.
    The tiers of one variant share its params.

    ``hop_ms`` (e.g. ``{"E": 25.0, "C": 50.0}``) adds a real per-batch
    network-hop sleep per tier; default: no hops. Weights are random,
    from ``variant_seed(seed, vid)``, drawn on ``device`` (see
    ``Model.init``): one seed serves the same models on every card, but
    other models on the CPU than on a card."""
    if cfg.arch_type == "vlm":
        raise ValueError(f"{cfg.name!r} is a VLM: its prefill takes image "
                         "embeddings, which an engine's tokens-only requests "
                         "lack; serve it through Model.prefill / decode")
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name!r} is an encoder-decoder: its prefill "
                         "takes the encoder's frames, which an engine's "
                         "tokens-only requests lack (the reference's engine "
                         "passes tokens only too); serve it through "
                         "Model.prefill / decode")
    dev = resolve_device(device)
    ladder = build_ladder(cfg)
    engines = {"S": {}, "E": {}, "C": {}}
    hops = dict(hop_ms or {})
    for vid in variants:
        model = build_model(ladder[vid].cfg)
        params = model.init(variant_seed(seed, vid), device=dev)
        for tier, sc in TIER_SCALES.items():
            if tier != "S" and vid != "d0":
                continue  # paper: edge/cloud always run d0
            engines[tier][vid] = ServingEngine(model, params, max_len=max_len,
                                               compute_scale=sc,
                                               hop_ms=hops.get(tier, 0.0))
    return engines


def local_variants(agent) -> tuple:
    """The device-tier variants ``d{a}`` that the agent's action set can
    reach (edge and cloud always run d0)."""
    allowed = allowed_per_user(agent.spec, agent.actions)
    return tuple(f"d{a}" for a in range(A_EDGE) if allowed[:, a].any())


def main(argv=None):
    """Train the orchestration agent (tabular Q-learning on the EXP-A
    scenario), then serve ``--requests`` waves: each wave's decision
    comes from the agent, each user's 16-token prompt runs on its
    decided engine (4 new tokens), and the environment steps on the
    decision. Builds every device-tier variant the agent can decide
    (d0-d7 for the full action set) and d0 on the edge and cloud tiers;
    the reference builds only d0/d4/d7 and so cannot serve a d5 decision.
    Prints one line per wave; returns the ``TrainResult`` and, per wave,
    ``{"decision", "env_avg_ms", "measured_ms"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="edge-ladder")
    ap.add_argument("--users", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=85.0)
    ap.add_argument("--train-steps", type=int, default=6000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch)) if args.arch != "edge-ladder" \
        else get_config(args.arch)
    env = EndEdgeCloudEnv(args.users, EXPERIMENTS["EXP-A"],
                          accuracy_threshold=args.threshold, seed=0,
                          device=dev)
    agent = QLearningAgent(env.spec, seed=0)
    print("training orchestration agent...")
    res = train_agent(agent, env, args.train_steps)
    print(f"  converged_at={res.converged_at} greedy={res.greedy_ms:.1f}ms "
          f"(optimal {res.best_ms:.1f}ms)")

    engines = build_engines(cfg, variants=local_variants(agent), device=dev)
    orch = IntelligentOrchestrator(agent, env, engines)
    state = env.reset()
    rng = np.random.default_rng(0)
    waves = []
    for wave in range(args.requests):
        per_user = orch.decide(state)
        prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
                   for _ in range(args.users)]
        results = orch.dispatch(per_user, prompts)
        joint = env.spec.encode_action(per_user)
        state, _, info = env.step(joint)
        print(f"wave {wave}: decision={per_user} "
              f"env_avg={info['avg_response_ms']:.1f}ms "
              f"measured={[f'{r[2]:.0f}ms' for r in results]}")
        waves.append({"decision": per_user,
                      "env_avg_ms": info["avg_response_ms"],
                      "measured_ms": [r[2] for r in results]})
    return res, waves


if __name__ == "__main__":
    main()
