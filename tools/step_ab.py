#!/usr/bin/env python3
"""Time the port's two fleet training steps (``FleetQLearning`` with K1,
``FleetDQN`` with K2) of one or more source trees, in turns, on one card.

    python3 tools/step_ab.py SRC [SRC ...]

Each ``SRC`` is a directory holding a ``repro_torch`` package (``src``
of this checkout, or of another commit unpacked with ``git archive``).
Each runs in its own process, in the order given, so a change and its
parent compare within one call as parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/step_ab.py build/parent/src src src build/parent/src

One JSON line per tree, for each agent of ``chip_smoke.py``'s
``tabular_agent`` and ``dqn_agent`` (32,768 cells x 5 users, metrics
off, as the ``tabular_training`` and ``dqn_training`` phases run them):
``"<agent> step wall ms"``, ``READINGS`` readings of the host clock around
``STEPS[agent]`` synchronised steps, per step; and from one
``torch.profiler`` window of 5 steps, ``"<agent> step device ms"`` (the
device time of every event) and ``"<agent> device ops per step"`` (the
device events a step: kernels, copies and fills, each one launch from
the host). The card's name and power limit (``nvidia-smi``) come first.
Needs a CUDA device; each tree's kernels are built into its own
``build`` directory.
"""
import json
import os
import sys
import time
import types

from attention_ab import ROOT, turns

#: steps per wall reading: ~0.1-0.3 s of either agent on an H100
STEPS = {"tabular": 50, "dqn": 20}
#: wall readings per agent and tree (host-bound steps spread widely)
READINGS = 10


def run_tree(src):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_ab.py: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fleet import api, policy, population, scenarios
    from repro_torch.kernels import _build, dqn_head, tabular_rl
    from repro_torch.rng import Draws
    _build.build([tabular_rl.KERNEL, dqn_head.KERNEL])
    R = types.SimpleNamespace(api=api, policy=policy, population=population,
                              scenarios=scenarios, Draws=Draws)
    out = {"src": src}
    for name, agent in (("tabular", cs.tabular_agent(R, False)),
                        ("dqn", cs.dqn_agent(R))):
        n = STEPS[name]
        agent.run(5)                                   # warm-up
        walls = []
        for _ in range(READINGS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            agent.run(n)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            agent.run(5)
            torch.cuda.synchronize()
        ev = cs.device_events(prof)
        out[f"{name} step wall ms"] = walls
        out[f"{name} step device ms"] = sum(us for _, us in ev) / 5 / 1e3
        out[f"{name} device ops per step"] = len(ev) / 5
        del agent
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    turns(__file__, run_tree, timeout=600)
