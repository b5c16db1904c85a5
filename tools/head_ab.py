#!/usr/bin/env python3
"""Time the port's DQN head (K2) and the fleet DQN step it serves, for
one or more source trees, in turns, on one card.

    python3 tools/head_ab.py SRC [SRC ...]

Each ``SRC`` is a directory holding a ``repro_torch`` package (``src``
of this checkout, or of another commit unpacked with ``git archive``).
Each runs in its own process, in the order given, so a change and its
parent compare within one call as parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/head_ab.py build/parent/src src src build/parent/src

One JSON line per tree. ``"dqn_head <mask> <goal>"`` for every action
allowed and for the fleet's mask (3 of 10), at goal 0 and 85, on
``chip_smoke.head_inputs`` (32,768 cells x 5 users, hidden 128, top-5):
[warm ms, cold ms, max abs error of q against the plain version,
decisions equal to the plain logic on the kernel's q], warm and cold as
``chip_smoke.timed`` and ``chip_smoke.cold_ms`` take them. ``"sass"``:
for each kernel function of the tree's built library, the backward-branch
loop of its SASS (``cuobjdump -sass``) with the most ``FFMA``: its
instructions, its ``FFMA`` count, their share and its opcodes by count;
``"ptxas"``, each function's registers and spill bytes. End to end, on
``chip_smoke.dqn_agent`` (the smoke's DQN phase): ``"dqn step wall
ms"``, ``REPS`` readings of the host clock around 10 synchronised steps,
per step; ``"dqn step device ms"`` and ``"dqn step K2 ms"``, the device
time per step of every kernel and of K2 alone, from one
``torch.profiler`` window of 5 steps. The card's name and power limit
(``nvidia-smi``) come first. Needs a CUDA device; each tree's kernel is
built into its own ``build`` directory.
"""
import json
import os
import sys
import time
import types

from attention_ab import REPS, ROOT, turns
from scan_ab import op_counts, sass_bodies


def ffma_loops(lib, cuobjdump):
    """{function: {...}} for the innermost loop of each function with the
    most ``FFMA`` (the hidden layers' reduction)."""
    out = {}
    for fn, loops in sass_bodies(lib, cuobjdump).items():
        loops = [b for lo, hi, b in loops if "FFMA" in b and not any(
            lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
            for lo2, hi2, _ in loops)]
        if loops:
            body = max(loops, key=lambda b: (b.count("FFMA"), -len(b)))
            n = body.count("FFMA")
            out[fn] = {"loop_instructions": len(body), "loop_ffma": n,
                       "ffma_share": n / len(body), "ops": op_counts(body)}
    return out


def step_ms(torch, cs, agent, steps=5):
    """(device ms, K2 ms) per step over one profiler window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        agent.run(steps)
        torch.cuda.synchronize()
    ev = cs.device_events(prof)
    return (sum(us for _, us in ev) / steps / 1e3,
            sum(us for n, us in ev if "dqn_head_kernel" in n) / steps / 1e3)


def run_tree(src):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("head_ab.py: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import spaces
    from repro_torch.fleet import api, dynamics, policy, population, \
        scenarios
    from repro_torch.kernels import _build, dqn_head, ref
    from repro_torch.rng import Draws
    dqn_head.KERNEL.lib_path.unlink(missing_ok=True)   # ptxas's report
    _build.build([dqn_head.KERNEL])
    out = {"src": src, "ptxas": cs.ptxas_summary(dqn_head.KERNEL.ptxas_log)}
    out["sass"] = ffma_loops(dqn_head.KERNEL.lib_path, os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump"))
    inputs, masks = cs.head_inputs(torch, dynamics, spaces)
    member, acc = inputs[1], inputs[-1]
    for mask, allowed in masks.items():
        args = inputs[:-1] + (allowed, acc)
        for goal in (0.0, 85.0):
            kw = dict(threshold=goal, topk=5)

            def f():
                return dqn_head.dqn_head_cuda(*args, **kw)
            d, q = f()
            _, q_p = ref.dqn_head_ref(*args, **kw)
            same = torch.equal(d, ref.greedy_head_ref(q, member, acc, **kw))
            ms, _, _ = cs.timed(f)
            out[f"dqn_head {mask} {goal:g}"] = [
                ms, cs.cold_ms(f), float((q - q_p).abs().max()), same]
    R = types.SimpleNamespace(api=api, policy=policy, population=population,
                              scenarios=scenarios, Draws=Draws)
    agent = cs.dqn_agent(R)
    agent.run(3)                                   # warm-up
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.run(10)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / 10)
    out["dqn step wall ms"] = walls
    out["dqn step device ms"], out["dqn step K2 ms"] = step_ms(
        torch, cs, agent)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    turns(__file__, run_tree, timeout=900)
