"""The exactness argument under the card's best-response round, on the
CPU with the plain version.

The round's pre-pass scores every cell at the round's start totals, and
its walker keeps that choice wherever a cell meets the start totals at
its turn. That is exact because a cell's choice is a pure function of
its round-invariant rows and two integers: its edge's job total and the
cloud's at its turn. Here, on random coupled fleets drawn with numpy,
calibrated and not:

* each cell rescored alone from the two integers it met in ``plain``'s
  sweep (the start totals plus the count changes of the cells before
  it, added up in a plain loop) makes ``plain``'s choice;
* the speculate-then-walk order, written out with ``choose``, gives
  ``plain``'s round and rescores exactly the cells that met an integer
  away from its start value, as ``rescored_cells`` counts them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import spaces
from repro_torch.fleet import dynamics, population, scenarios, topology
from repro_torch.kernels import best_response

#: seed, users, goal, calibrated: at goal 89 cells offload and the
#: sweep takes 2-4 rounds; (0, 3, 89, False) has a round whose one switch
#: keeps both counts, and the calibrated two-user fleets rounds whose
#: first count change comes late; at goal 0 the isolated optimum holds
FLEETS = [(0, 2, 89.0, True), (2, 2, 89.0, True), (0, 3, 89.0, False),
          (0, 3, 89.0, True), (1, 1, 89.0, False), (2, 1, 89.0, True),
          (0, 2, 0.0, False)]


def _fleet(seed, users, calibrated, cells=48, n_edges=4):
    """A coupled fleet of 1..users members a cell over ``n_edges`` edges
    of mixed capacity and a small cloud queue, so both totals matter."""
    rng = np.random.default_rng(seed)
    member = rng.random((cells, users)) < 0.75
    member[np.arange(cells), rng.integers(0, users, cells)] = True
    t = lambda x, dt: torch.tensor(x, dtype=dt)  # noqa: E731
    topo = topology.Topology(
        t(rng.integers(0, n_edges, cells), torch.int32),
        t(rng.choice([0.5, 1.0, 2.0], n_edges), torch.float32),
        float(rng.integers(cells // 4, cells // 2)))
    calib = None
    if calibrated:
        calib = dynamics.Calibration(
            t(rng.uniform(0.6, 1.4, 3), torch.float32),
            t(rng.uniform(-20.0, 20.0, 3), torch.float32))
    return scenarios.FleetScenario(
        t(rng.integers(0, 2, (cells, users)), torch.int32),
        t(rng.integers(0, 2, cells), torch.int32), t(member, torch.bool),
        t(member, torch.bool), 0, topo, calib)


def _rounds(scen, goal, max_rounds=6):
    """Yield (idx, new, args, pu) for each round of the sweep from the
    isolated optimum, until one changes nothing."""
    spec = spaces.SpaceSpec(scen.end_b.shape[1])
    pu = torch.tensor(spec.decode_actions_batch(spec.all_actions()))
    feas, ce, cc = population._candidate_tables(scen, pu, goal, 4096)
    _, idx = population._isolated_bruteforce(scen, pu, goal)
    topo = scen.topo
    args = (scen.end_b, scen.edge_b, scen.member, feas, ce, cc,
            topo.cell_edge, topo.edge_capacity, topo.cloud_servers)
    for _ in range(max_rounds):
        new, changed = best_response.plain(idx, pu, *args, calib=scen.calib)
        yield idx, new, args, pu
        if not bool(changed):
            return
        idx = new


def _walk(idx, pu, args, calib):
    """The card's order: every cell scored at the start totals, then a
    walk that keeps that choice where a cell meets the start totals and
    rescores it from the two integers elsewhere. (new, rescored)."""
    end_b, edge_b, member, feas, ce, cc, cell_edge, cap, servers = args
    rows = torch.arange(idx.shape[0])
    e_cnt, c_cnt = ce[rows, idx.long()], cc[rows, idx.long()]
    start_e = topology._segment_totals(e_cnt, cell_edge, cap.shape[0])
    start_c = c_cnt.sum()

    def choose(i, e, e_tot, c_tot):
        return int(best_response.choose(
            i, e, idx[i].long(), e_tot - e_cnt[i], c_tot - c_cnt[i], pu,
            end_b, edge_b, member, feas, ce, cc, cap, servers, calib))
    edges = cell_edge.tolist()
    spec = [choose(i, e, start_e[e], start_c) for i, e in enumerate(edges)]
    drift_e, drift_c = torch.zeros_like(start_e), 0
    new, rescored = idx.clone(), 0
    for i, e in enumerate(edges):
        nxt = spec[i]
        if drift_e[e] != 0 or drift_c != 0:
            nxt = choose(i, e, start_e[e] + drift_e[e], start_c + drift_c)
            rescored += 1
        drift_e[e] += ce[i, nxt] - e_cnt[i]
        drift_c += int(cc[i, nxt] - c_cnt[i])
        new[i] = nxt
    return new, rescored


def _met(idx, new, args):
    """(start, met): each cell's two integers at the round's start and
    at its turn in the sweep from ``idx`` to ``new``, as (edge total,
    cloud total) pairs, from the count changes of the cells before it."""
    ce, cc, cell_edge = args[4].tolist(), args[5].tolist(), args[6].tolist()
    old, now = idx.tolist(), new.tolist()
    edge, cloud = {}, 0
    for i, e in enumerate(cell_edge):
        edge[e] = edge.get(e, 0) + ce[i][old[i]]
        cloud += cc[i][old[i]]
    start = [(edge[e], cloud) for e in cell_edge]
    met = []
    for i, e in enumerate(cell_edge):
        met.append((edge[e], cloud))
        edge[e] += ce[i][now[i]] - ce[i][old[i]]
        cloud += cc[i][now[i]] - cc[i][old[i]]
    return start, met


@pytest.mark.parametrize("seed,users,goal,calibrated", FLEETS)
def test_a_cell_rescored_from_its_two_integers_makes_the_sweeps_choice(
        seed, users, goal, calibrated):
    scen = _fleet(seed, users, calibrated)
    for idx, new, args, pu in _rounds(scen, goal):
        _, met = _met(idx, new, args)
        end_b, edge_b, member, feas, ce, cc, cell_edge, cap, servers = args
        for i, (e_tot, c_tot) in enumerate(met):
            cur = idx[i].long()
            got = best_response.choose(
                i, int(cell_edge[i]), cur,
                torch.tensor(e_tot, dtype=torch.int32) - ce[i, cur],
                torch.tensor(c_tot) - cc[i, cur], pu, end_b, edge_b, member,
                feas, ce, cc, cap, servers, scen.calib)
            assert int(got) == int(new[i]), (i, e_tot, c_tot)


@pytest.mark.parametrize("seed,users,goal,calibrated", FLEETS)
def test_speculate_then_walk_is_the_sweep(seed, users, goal, calibrated):
    """The last round, which changes nothing, rescores no cell."""
    scen = _fleet(seed, users, calibrated)
    seen = []
    for idx, new, args, pu in _rounds(scen, goal):
        got, rescored = _walk(idx, pu, args, scen.calib)
        assert torch.equal(got, new)
        start, met = _met(idx, new, args)
        assert rescored == sum(s != m for s, m in zip(start, met))
        assert rescored == best_response.rescored_cells(idx, new, args[4],
                                                        args[5], args[6])
        seen.append(rescored)
    assert seen[-1] == 0
