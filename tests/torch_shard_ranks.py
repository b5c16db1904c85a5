"""The ranks of ``tests/test_torch_shard.py``: each spawned process joins
a gloo group on the CPU, runs every case of the sharded port on its
block of the fleet and saves what it got, assembled whole, for the test
to hold against the unsharded port and the reference.

This module imports only ``torch`` and ``repro_torch``, so a spawned
rank starts without loading JAX.
"""
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.fleet import api, policy, population, scenarios, shard
from repro_torch.fleet import topology
from repro_torch.obs import MetricDef, MetricsAccumulator
from repro_torch.obs.prof import scaling_sweep
from repro_torch.rng import Draws


class Recorded(Draws):
    """Draws that replay recorded values site by site, in order (one
    list a site, whatever the method)."""

    def __init__(self, **sites):
        super().__init__(0, "cpu")
        self.sites = {k: list(v) for k, v in sites.items()}

    def _pop(self, site, shape, dtype):
        arr = np.asarray(self.sites[site].pop(0))
        assert arr.shape == tuple(shape), (site, arr.shape, shape)
        return torch.tensor(arr, dtype=dtype)

    def uniform(self, site, shape):
        return self._pop(site, shape, torch.float32)

    def normal(self, site, shape):
        return self._pop(site, shape, torch.float32)

    def randint(self, site, shape, high, low=0):
        return self._pop(site, shape, torch.int64)


def _np(x):
    """A copy of ``x`` as numpy (an agent's table goes on training in
    place)."""
    return x.detach().cpu().numpy().copy()


def whole(x, scen):
    """A per-cell tensor of ``scen`` assembled whole, as numpy."""
    return _np(population.gather_cells(x, scen))


def scen_fields(scen):
    out = {f: whole(getattr(scen, f), scen)
           for f in ("end_b", "edge_b", "member", "active")}
    if scen.topo is not None:
        out["cell_edge"] = whole(scen.topo.cell_edge, scen)
    out["t"] = scen.t
    return out


def metrics_leaves(acc):
    """Every leaf of an accumulator, lanes assembled whole."""
    return {(n, k): _np(acc._whole(n, k)) for n in acc.data
            for k in acc.data[n]}


def case_step(mesh, inp):
    """Five chained scenario steps of every dynamic at once under the
    reference's draws, then five under seeded draws."""
    cfg = scenarios.FleetConfig(**inp["cfg"])
    scen0 = convert.scenario(*inp["scen0"], device="cpu")
    src = api.SyntheticSource(cfg, scen=scen0, mesh=mesh)
    draws = Recorded(**inp["draws"])
    scen, _ = src.reset(draws)
    out = []
    for _ in range(5):
        scen, _ = src.step(draws, scen)
        out.append(scen_fields(scen))
    seeded = Draws(11, "cpu")
    for _ in range(5):
        scen, _ = src.step(seeded, scen)
        out.append(scen_fields(scen))
    return out


def _tabular(agent, n, scen=None):
    ms, acc = agent.run(n)
    s = agent.scen
    got = {"q": whole(agent.q, s), "counts": whole(agent.counts, s),
           "greedy": whole(agent.greedy_decisions(), s), "ms": ms,
           "acc": acc, "scen": scen_fields(s),
           "summary": agent.metrics_summary(),
           "leaves": metrics_leaves(agent.metrics)}
    h = policy.holdout_reward_ratio(agent, s)
    got["holdout"] = (h.ratio, h.achieved, h.optimal, h.feasible)
    r = api.FleetOrchestrator(agent).route(with_edge_util=True,
                                           as_result=True)
    got["route"] = (_np(r.decisions), _np(r.ids), _np(r.edge_util))
    return got


def case_qlearning(mesh, inp):
    """Q-learning on the recorded trace under the reference's draws (the
    mesh on the source), then on the full synthetic fleet under seeded
    draws with per-window telemetry (the mesh on the agent)."""
    src = api.TraceSource.load(inp["trace"], device="cpu", mesh=mesh)
    agent = population.FleetQLearning(src, device="cpu",
                                      draws=Recorded(**inp["draws"]),
                                      seed=4)
    assert agent.mesh is mesh
    out = {"trace": _tabular(agent, inp["n"])}
    cfg = scenarios.FleetConfig(**inp["cfg"])
    agent = population.FleetQLearning(api.SyntheticSource(cfg), seed=3,
                                      device="cpu", mesh=mesh, n_windows=4,
                                      window_len=10)
    out["synthetic"] = _tabular(agent, 40)
    res = agent.train(max_steps=40, check_every=20, patience=1)
    out["train"] = (res.converged_at, res.optimal_ms, res.greedy_ms,
                    res.history, res.manifest["mesh_shape"])
    return out


def case_metrics(mesh, inp):
    """A placed accumulator fed the same stream as a plain one."""
    lanes = inp["lanes"]
    defs = {"r": MetricDef(lo=-2.5, hi=0.0, bins=16, lanes=lanes,
                           n_windows=4, window_len=3),
            "eps": MetricDef(lo=0.0, hi=1.0, bins=8)}
    acc = population.place_metrics(MetricsAccumulator.create(defs, "cpu"),
                                   mesh)
    lo, k = (mesh.block(lanes) if mesh is not None and mesh.splits(lanes)
             else (0, lanes))
    for x, e in inp["stream"]:
        acc.update({"r": torch.tensor(x[lo:lo + k]), "eps": e})
    return {"leaves": metrics_leaves(acc), "summary": acc.summary(),
            "lane_means": acc.lane_means("r")}


def case_dqn(mesh, inp):
    """Cold decisions under the reference's params, then a short sharded
    run under seeded draws."""
    cfg = scenarios.FleetConfig(**inp["cfg"])
    kw = dict(hidden=16, replay_capacity=inp["capacity"], batch_size=8,
              accuracy_threshold=inp["threshold"])
    agent = policy.FleetDQN(api.SyntheticSource(cfg), seed=5, device="cpu",
                            mesh=mesh, cfg=policy.FleetDQNConfig(**kw))
    agent.params = convert.mlp_params(inp["params"], device="cpu")
    scen = shard.shard_scenario(convert.scenario(*inp["held"], device="cpu"),
                                mesh)
    counts = torch.zeros((scen.cells, 2), dtype=torch.int32)
    dec, ids = agent.policy_decisions(counts, scen)
    out = {"cold": (whole(dec, scen), whole(ids, scen))}
    agent = policy.FleetDQN(api.SyntheticSource(cfg), seed=5, device="cpu",
                            mesh=mesh, cfg=policy.FleetDQNConfig(**kw))
    ms, acc = agent.run(12)
    s = agent.scen
    h = policy.holdout_reward_ratio(agent, s)
    out["run"] = {"params": [{k: _np(v) for k, v in p.items()}
                             for p in agent.params],
                  "m": [{k: _np(v) for k, v in p.items()}
                        for p in agent.opt["m"]],
                  "ms": ms, "acc": acc,
                  "greedy": whole(agent.greedy_decisions(), s),
                  "counts": whole(agent.counts, s),
                  "summary": agent.metrics_summary(),
                  "holdout": (h.ratio, h.achieved, h.optimal),
                  "scen": scen_fields(s)}
    return out


def case_local(mesh, inp):
    """The shard-local generator under the reference's draw, and the
    local aggregation against the global one."""
    n = mesh.size
    cells, n_edges = inp["cells"], inp["n_edges"]
    topo = topology.random_topology(
        Recorded(**{"scenario.topology": [inp["topo_draw"][n]]}), cells,
        n_edges, capacity_tiers=(1.0, 2.0), cloud_servers=16.0,
        shard_local=True, n_shards=n)
    scen = convert.scenario(*inp["scen"], topo=None, device="cpu")
    pu = torch.tensor(inp["pu"])
    want = topology.shared_contention(pu, topo, active=scen.active)
    want_resp = topology.topology_expected_response(
        pu, scen.end_b, scen.edge_b, topo, active=scen.active)
    topo_s = shard.shard_topology(topo, mesh)
    scen_s = shard.shard_scenario(scen, mesh)
    pu_s = shard.shard_array(pu, mesh)
    got = shard.local_contention(pu_s, topo_s, mesh, active=scen_s.active)
    got_resp = shard.local_expected_response(pu_s, scen_s.end_b,
                                             scen_s.edge_b, topo_s, mesh,
                                             active=scen_s.active)
    glob = topology.shared_contention(pu_s, topo_s, active=scen_s.active)
    whole_ = lambda x: _np(shard.gather_array(x, mesh)) \
        if topo_s.mesh is not None else _np(x)  # noqa: E731
    out = {"cell_edge": _np(topo.cell_edge),
           "is_local": topology.is_shard_local(topo, n),
           "want": [_np(x) for x in want],
           "want_resp": [_np(x) for x in want_resp],
           "got": [whole_(got[0]), whole_(got[1]), _np(got[2])],
           "got_resp": [whole_(x) for x in got_resp],
           "global": [whole_(glob[0]), whole_(glob[1]), _np(glob[2])]}
    if n > 1:
        bad = topology.hot_edge_topology(cells, n_edges)
        try:
            shard.local_contention(
                torch.zeros((cells // n, 2), dtype=torch.int32),
                shard.shard_topology(bad, mesh), mesh)
            out["reject"] = None
        except ValueError as e:
            out["reject"] = str(e)
    return out


def case_placement(mesh, inp):
    """Placement helpers: specs, blocks, replication and its check."""
    x = torch.arange(8 * 3 * 2).reshape(8 * 2, 3)
    odd = torch.arange(9 * 3).reshape(9, 3)
    out = {"spec": tuple(shard.fleet_spec(mesh, tuple(x.shape))),
           "spec_odd": tuple(shard.fleet_spec(mesh, tuple(odd.shape))),
           "block": _np(shard.shard_array(x, mesh)),
           "block_odd": _np(shard.shard_array(odd, mesh)),
           "gathered": _np(shard.gather_array(shard.shard_array(x, mesh),
                                              mesh))}
    same = [{"w": torch.ones(3)}]
    out["replicate_same"] = shard.replicate(same, mesh) is same
    try:
        shard.replicate([{"w": torch.full((3,), float(mesh.rank))}], mesh)
        out["replicate_diff"] = None
    except ValueError as e:
        out["replicate_diff"] = str(e)
    sweep = scaling_sweep([8, 16], users=2, mesh=mesh, steps=4, chunk=2,
                          device="cpu")
    out["sweep"] = (sweep["devices"], sweep["sharded"],
                    sweep["flops_per_cell"])
    return out


CASES = {"step": case_step, "qlearning": case_qlearning,
         "metrics": case_metrics, "dqn": case_dqn, "local": case_local,
         "placement": case_placement}


def run_rank(rank, world, init_file, payload, out_dir):
    """One rank: join the group, run every case, save the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        with open(payload, "rb") as f:
            inputs = pickle.load(f)
        mesh = shard.fleet_mesh(device="cpu")
        results = {name: fn(mesh, inputs[name])
                   for name, fn in CASES.items()}
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
