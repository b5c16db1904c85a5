"""Serving launcher — the port of ``repro/launch/serve.py``'s
``build_engines``: the three-tier engine set over one config's variant
ladder, which ``FleetOrchestrator.route(dispatch=...)`` drains routed
requests into.

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engines
    engines = build_engines(get_config("edge-ladder"))
    mamba = build_engines(get_config("falcon-mamba-7b"), variants=("d0", "d4"))

The reference's command-line loop comes with the single-cell layer
(ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
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
