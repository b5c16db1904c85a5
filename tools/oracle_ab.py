#!/usr/bin/env python3
"""Time the port's coupled-fleet oracle (``topology_bruteforce``, one
best-response round of ``csrc/best_response.cu`` a sweep) of one or
more source trees, in turns, on one card.

    python3 tools/oracle_ab.py SRC [SRC ...]

Each ``SRC`` is a directory holding a ``repro_torch`` package (``src``
of this checkout, or of another commit unpacked with ``git archive``).
Each runs in its own process, in the order given, so a change and its
parent compare within one call as parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/oracle_ab.py build/parent/src src src build/parent/src

Three shapes: ``chip_smoke.py``'s two coupled fleets (its hot edge, 64
cells x 2 users x 100 candidates over 4 edges, and its 1,024 x 3 x
1,000 over 16 skewed edges, goal 89) and the coupled holdout's held-out
fleet (32,768 cells x 5 users, 1-5 members a cell, 64 skewed edges, the
243 candidates of ``default_actions``, goal 85). One JSON line per tree,
for each shape: ``"<shape> changing round ms"`` (the round from the
isolated start) and ``"<shape> converged round ms"`` (the round from the
oracle's fixed point, which changes nothing), ``READINGS`` readings each
of ``chip_smoke.hidden_ms`` (CUDA events with the launch hidden, 5
rounds a reading); ``"<shape> oracle wall s"``, ``READINGS`` host
readings of the whole oracle, synchronised; its rounds, the cells its
result moved from the isolated start and a checksum of its indices, to
hold the trees' results equal. The card's name and power limit
(``nvidia-smi``) come first. Needs a CUDA device; each tree's kernels
are built into its own ``build`` directory.
"""
import json
import os
import sys
import time

from attention_ab import ROOT, turns

#: readings of each time, per shape and tree
READINGS = 5
#: the holdout agent's accuracy goal (``FleetDQNConfig`` in the smoke)
HOLDOUT_GOAL = 85.0


def shapes(torch, R, cs):
    """(label, scenario, candidate table, goal) of the three shapes."""
    out = [(label, scen, pu, cs.COUPLED_GOAL)
           for label, scen, pu in cs.coupled_fleets(torch, R)]
    cfg = R.scenarios.FleetConfig(
        cells=cs.CELLS, users=cs.USERS, arrival_rate=1.2, p_r2w=0.05,
        p_w2r=0.15, min_users=1, max_users=5, n_edges=cs.HOLDOUT_EDGES,
        assignment="skewed", cloud_servers=4.0 * cs.CELLS)
    held, _ = R.api.SyntheticSource(cfg).reset(R.Draws(7, "cuda"))
    spec = R.population.SpaceSpec(cs.USERS)
    pu = torch.tensor(spec.decode_actions_batch(
        R.population.default_actions(spec)), device="cuda")
    out.append((f"holdout_{cs.CELLS}x{cs.HOLDOUT_EDGES}", held, pu,
                HOLDOUT_GOAL))
    return out


def run_tree(src):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("oracle_ab.py: no CUDA device available")
    from repro_torch.kernels import _build, best_response
    _build.build([best_response.KERNEL])
    R = cs.fleet_namespace()
    pop = R.population
    out = {"src": src}
    for label, scen, pu, goal in shapes(torch, R, cs):
        walls = []
        for _ in range(READINGS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, fixed, converged, rounds = pop.topology_bruteforce(scen, pu,
                                                                  goal)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        topo = scen.topo
        feas, ce, cc = pop._candidate_tables(scen, pu, goal, 4096)
        _, idx0 = pop._isolated_bruteforce(scen, pu, goal)
        args = (scen.end_b.to(torch.int32), scen.edge_b.to(torch.int32),
                scen.member, feas, ce, cc, topo.cell_edge,
                topo.edge_capacity, topo.cloud_servers)
        packed = best_response.pack_actions(pu)
        for name, idx in (("changing", idx0), ("converged", fixed)):
            def fn(idx=idx):
                return best_response.best_response_cuda(idx, packed, *args)
            out[f"{label} {name} round ms"] = [cs.hidden_ms(fn, reps=5)
                                               for _ in range(READINGS)]
        weights = torch.arange(1, fixed.shape[0] + 1, device="cuda")
        out[f"{label} oracle wall s"] = walls
        out[f"{label} rounds"] = [rounds, converged]
        out[f"{label} moved"] = int((fixed != idx0).sum())
        out[f"{label} checksum"] = int((fixed.long() * weights).sum())
        del feas, ce, cc
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    turns(__file__, run_tree, timeout=900)
