"""The sharded fleet (``repro_torch.fleet.shard``) against the unsharded
port and the JAX package's unsharded path, on the CPU.

Every case of ``tests/torch_shard_ranks.py`` runs once at 1 and once at
2 gloo ranks (spawned processes, a ``file://`` rendezvous under the
test's own ``tmp_path``, one intra-op thread a rank, every join under a
time limit), each rank on its block of the fleet; what they assemble
must equal the unsharded port bit for bit: scenario steps, Q-learning
(Q-table, counts, decisions, rewards, telemetry plain and windowed, the
holdout ratio, the orchestrator's route, the training loop), a placed
accumulator, cold DQN decisions and the parameters after a short run.
The unsharded port is then held against the reference as its own parity
tests hold it: integer leaves and decisions equal; floats equal where
the two round alike, else within the tolerances of
``tests/test_torch_fleet.py``. These mirror ``tests/test_fleet_shard.py``.
"""
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_shard_ranks as ranks
from repro.fleet import api as japi
from repro.fleet import policy as jpolicy
from repro.fleet import population as jpop
from repro.fleet import scenarios as jscen
from repro.fleet import topology as jtopo
from repro.obs import metrics as jmetrics
from repro_torch import convert

TRACE = os.path.join(os.path.dirname(__file__), "data", "trace_small.npz")
WORLDS = (1, 2)
JOIN_S = 240

FULL = dict(cells=16, users=2, p_r2w=0.1, p_w2r=0.2, arrival_rate=1.0,
            p_join=0.02, p_leave=0.02, n_edges=4, cloud_servers=8.0,
            capacity_tiers=(1.0, 2.0), p_edge_fail=0.1)
DQN_CFG = dict(cells=16, users=2, arrival_rate=1.0, p_r2w=0.1, p_w2r=0.2,
               n_edges=4, cloud_servers=8.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(js):
    topo = None if js.topo is None else (
        np.asarray(js.topo.cell_edge), np.asarray(js.topo.edge_capacity),
        np.asarray(js.topo.cloud_servers))
    return (np.asarray(js.end_b), np.asarray(js.edge_b),
            np.asarray(js.member), np.asarray(js.active), int(js.t), topo,
            None)


def _step_draws(key, cfg, js):
    """The draws the reference's ``step_fleet(key, js, cfg)`` takes, at
    the port's sites in the port's order."""
    sites = {}
    add = lambda site, x: sites.setdefault(site, []).append(  # noqa: E731
        np.asarray(x))
    cells, users = js.end_b.shape
    if cfg.p_edge_fail and js.topo is not None:
        k_end, k_edge, k_churn, k_arr, k_fail = jax.random.split(key, 5)
        k_ev, k_e, k_re = jax.random.split(k_fail, 3)
        n = js.topo.edge_capacity.shape[0]
        add("scenario.edge_fail", jax.random.uniform(k_ev, ()))
        add("scenario.edge_fail", jax.random.randint(k_e, (), 0, n))
        add("scenario.edge_fail", jax.random.randint(k_re, (cells,), 0,
                                                     n - 1))
    else:
        k_end, k_edge, k_churn, k_arr = jax.random.split(key, 4)
    if cfg.p_r2w or cfg.p_w2r:
        add("scenario.links", jax.random.uniform(k_end, (cells, users)))
        add("scenario.links", jax.random.uniform(k_edge, (cells,)))
    if cfg.p_join or cfg.p_leave:
        add("scenario.churn", jax.random.uniform(k_churn, (cells, users)))
    add("scenario.arrivals", jax.random.uniform(k_arr, (cells, users)))
    return sites


def _tabular_draws(seed, cells, n):
    """The explore uniforms and noise normals of the reference agent's
    ``run(n)`` (as ``tests/test_torch_fleet.py`` records them)."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    u, z = [], []
    for _ in range(n):
        key, k = jax.random.split(key)
        k_exp, k_noise, _ = jax.random.split(k, 3)
        u.append(np.asarray(jax.random.uniform(k_exp, (cells,))))
        z.append(np.asarray(jax.random.normal(k_noise, (cells,))))
    return {"explore": u, "noise": z}


def _inputs_and_reference():
    """Every case's inputs, and what the reference computes from them."""
    inp, ref = {}, {}
    # -- five chained steps of every scenario dynamic
    jcfg = jscen.FleetConfig(**FULL)
    js = jscen.init_fleet(jax.random.PRNGKey(0), jcfg)
    draws, ref["step"] = {}, []
    for i in range(5):
        for site, xs in _step_draws(jax.random.PRNGKey(10 + i), jcfg,
                                    js).items():
            draws.setdefault(site, []).extend(xs)
        js = jscen.step_fleet(jax.random.PRNGKey(10 + i), js, jcfg)
        ref["step"].append(_fields(js))
    inp["step"] = {"cfg": FULL, "draws": draws,
                   "scen0": _fields(jscen.init_fleet(jax.random.PRNGKey(0),
                                                     jcfg))}
    # -- Q-learning on the recorded trace
    n = 30
    jagent = jpop.FleetQLearning(japi.TraceSource.load(TRACE), seed=4)
    jms, jacc = jagent.run(n)
    h = jpolicy.holdout_reward_ratio(jagent, jagent.scen)
    dec, ids, util = japi.FleetOrchestrator(jagent).route(
        with_edge_util=True)
    ref["qlearning"] = {
        "q": np.asarray(jagent.q), "counts": np.asarray(jagent.counts),
        "greedy": np.asarray(jagent.greedy_decisions()), "ms": jms,
        "acc": jacc, "scen": _fields(jagent.scen),
        "summary": jagent.metrics_summary(),
        "holdout": (h.ratio, h.achieved, h.optimal, h.feasible),
        "route": (np.asarray(dec), np.asarray(ids), np.asarray(util))}
    inp["qlearning"] = {"trace": TRACE, "n": n, "cfg": FULL,
                        "draws": _tabular_draws(4, jagent.scen.cells, n)}
    # -- a placed accumulator: 10 updates of 16 lanes
    rng = np.random.default_rng(0)
    stream = [(rng.uniform(-3.0, 0.5, 16).astype(np.float32),
               float(rng.uniform(0, 1))) for _ in range(10)]
    stream[3][0][:4] = (np.nan, -0.0, 0.0, np.inf)
    inp["metrics"] = {"lanes": 16, "stream": stream}
    jacc_ = jmetrics.MetricsAccumulator.create({
        "r": jmetrics.MetricDef(lo=-2.5, hi=0.0, bins=16, lanes=16,
                                n_windows=4, window_len=3),
        "eps": jmetrics.MetricDef(lo=0.0, hi=1.0, bins=8)})
    for x, e in stream:
        jacc_ = jacc_.update({"r": jnp.asarray(x), "eps": e})
    ref["metrics"] = jacc_
    # -- DQN: the reference's params route a held-out fleet cold
    dcfg = jscen.FleetConfig(**DQN_CFG)
    kw = dict(hidden=16, replay_capacity=64, batch_size=8,
              accuracy_threshold=85.0)
    jdqn = jpolicy.FleetDQN(japi.SyntheticSource(dcfg), seed=5,
                            cfg=jpolicy.FleetDQNConfig(**kw), metrics=False)
    held = jscen.init_fleet(jax.random.PRNGKey(1), dcfg)
    jdec, jids = jdqn.policy_decisions(jnp.zeros((16, 2), jnp.int32), held)
    ref["dqn"] = (np.asarray(jdec), np.asarray(jids))
    inp["dqn"] = {"cfg": DQN_CFG, "capacity": 64, "threshold": 85.0,
                  "params": jax.tree_util.tree_map(np.asarray, jdqn.params),
                  "held": _fields(held)}
    # -- the shard-local generator and the local aggregation
    cells, n_edges = 16, 4
    key = jax.random.PRNGKey(1)
    ref["local"] = {
        w: np.asarray(jtopo.random_topology(
            key, cells, n_edges, capacity_tiers=(1.0, 2.0),
            cloud_servers=16.0, shard_local=True, n_shards=w).cell_edge)
        for w in WORLDS}
    scen = jscen.init_fleet(jax.random.PRNGKey(2), jscen.FleetConfig(
        cells=cells, users=3, arrival_rate=1.0))
    inp["local"] = {
        "cells": cells, "n_edges": n_edges,
        "topo_draw": {w: np.asarray(jax.random.randint(
            key, (cells,), 0, n_edges // w)) for w in WORLDS},
        "scen": _fields(scen)[:4],
        "pu": np.random.default_rng(0).integers(0, 10, (cells, 3)).astype(
            np.int32)}
    inp["placement"] = {}
    return inp, ref


def _spawn(world, payload, tmp_path):
    """Run every case on ``world`` gloo ranks; the results of each rank.
    A rank that raises fails the test; one that outlasts ``JOIN_S``
    seconds is killed and fails it too."""
    out = tmp_path / f"world{world}"
    out.mkdir()
    ctx = mp.start_processes(
        ranks.run_rank, args=(world, str(out / "init"), str(payload),
                              str(out)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world}-rank run outlasted {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(not p.is_alive() for p in ctx.processes)
    got = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the reference's results, the unsharded port's and
    every rank's at 1 and 2 ranks."""
    tmp = tmp_path_factory.mktemp("shard")
    inp, ref = _inputs_and_reference()
    payload = tmp / "inputs.pkl"
    with open(payload, "wb") as f:
        pickle.dump(inp, f)
    plain = {name: ranks.CASES[name](None, inp[name])
             for name in ("step", "qlearning", "metrics", "dqn")}
    sharded = {w: _spawn(w, payload, tmp) for w in WORLDS}
    return inp, ref, plain, sharded


def _equal(a, b, path="result"):
    """Bit-equal trees: arrays by value and dtype (NaN equal to NaN),
    everything else by ``==``."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype.kind == "f":
            # equal values, NaN equal to NaN (whatever its payload) and
            # zeros of the same sign
            num = ~np.isnan(a)
            assert np.array_equal(a, b, equal_nan=True), path
            assert np.array_equal(np.signbit(a[num]), np.signbit(b[num])), \
                path
        else:
            assert np.array_equal(a, b), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _ranks(runs, name, own=()):
    """(world, rank 0's result) of case ``name``, after checking that
    every rank assembled the same thing (but the keys in ``own``, which
    hold a rank's own block)."""
    for w, got in runs[3].items():
        first = {k: v for k, v in got[0][name].items() if k not in own} \
            if own else got[0][name]
        for other in got[1:]:
            rest = {k: v for k, v in other[name].items() if k not in own} \
                if own else other[name]
            _equal(first, rest, f"{name}@{w}")
        yield w, got[0][name]


# ------------------------------------------------------------ placement ---
def test_placement_helpers_on_one_and_two_ranks(runs):
    x = np.arange(8 * 3 * 2).reshape(16, 3)
    for w, got in _ranks(runs, "placement", own=("block",)):
        assert got["spec"] == ("fleet", None)
        assert got["spec_odd"] == (("fleet", None) if w == 1
                                   else (None, None))
        np.testing.assert_array_equal(got["gathered"], x)
        np.testing.assert_array_equal(got["block_odd"],
                                      np.arange(27).reshape(9, 3))
        assert got["replicate_same"]
        if w == 1:
            assert got["replicate_diff"] is None
            np.testing.assert_array_equal(got["block"], x)
        else:
            assert "differs across" in got["replicate_diff"]
        devices, sharded, flops = got["sweep"]
        assert devices == w and sharded
        assert all(v > 0 for v in flops.values())
    # rank 1's block is the second half
    np.testing.assert_array_equal(runs[3][2][1]["placement"]["block"],
                                  x[8:])


def test_helpers_are_identity_without_mesh():
    from repro_torch.fleet import scenarios, shard
    scen = convert.scenario(*_fields(jscen.init_fleet(
        jax.random.PRNGKey(0), jscen.FleetConfig(**FULL)))[:6],
        device="cpu")
    assert shard.shard_scenario(scen, None) is scen
    assert shard.constrain_array(scen.end_b, None) is scen.end_b
    assert shard.replicate(scen, None) is scen
    assert shard.shard_topology(scen.topo, None) is scen.topo
    assert scenarios.cell_draws(ranks.Draws(0, "cpu"), scen).__class__ \
        is ranks.Draws


# ------------------------------------------------- bit-parity: the step ---
def test_step_fleet_sharded_bit_parity_and_the_reference(runs):
    inp, ref, plain, _ = runs
    for w, got in _ranks(runs, "step"):
        _equal(got, plain["step"], f"step@{w}")
    for got, want in zip(plain["step"], ref["step"]):
        for i, f in enumerate(("end_b", "edge_b", "member", "active")):
            np.testing.assert_array_equal(got[f], want[i], err_msg=f)
        np.testing.assert_array_equal(got["cell_edge"], want[5][0])
        assert got["t"] == want[4]


# --------------------------------------------- bit-parity: Q-learning -----
def test_qlearning_training_bit_parity(runs):
    _, _, plain, _ = runs
    want = dict(plain["qlearning"], train=plain["qlearning"]["train"][:4])
    assert plain["qlearning"]["train"][4] is None
    for w, got in _ranks(runs, "qlearning"):
        _equal(dict(got, train=got["train"][:4]), want, f"qlearning@{w}")
        assert got["train"][4] == {"fleet": w}      # the manifest's mesh


def test_qlearning_on_the_trace_matches_the_reference(runs):
    """Under the reference's draws the Q-table, counts, decisions, the
    holdout ratio and the route are the reference's bit for bit; the
    per-step fleet means and the telemetry's sums of squares are float32
    sums taken in another order (rtol 1e-5, as in
    ``tests/test_torch_fleet.py``)."""
    _, ref, plain, _ = runs
    got, want = plain["qlearning"]["trace"], ref["qlearning"]
    for k in ("q", "counts", "greedy"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["ms"], want["ms"], rtol=1e-5)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=1e-6)
    for i, f in enumerate(("end_b", "edge_b", "member", "active")):
        np.testing.assert_array_equal(got["scen"][f], want["scen"][i])
    for name, s in want["summary"].items():
        p = got["summary"][name]
        for k in ("count", "hist", "underflow", "overflow", "mean", "min",
                  "max"):
            assert p[k] == s[k], (name, k)
        # the std comes from sumsq / n - mean^2; hold the second moment
        assert p["std"] ** 2 + p["mean"] ** 2 == pytest.approx(
            s["std"] ** 2 + s["mean"] ** 2, rel=1e-5), name
    ratio, achieved, optimal, feasible = got["holdout"]
    assert ratio == want["holdout"][0]
    for g, r in zip((achieved, optimal, feasible), want["holdout"][1:]):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(got["route"], want["route"]):
        np.testing.assert_array_equal(g, r)


def test_placed_metrics_bit_parity_and_the_reference(runs):
    _, ref, plain, _ = runs
    for w, got in _ranks(runs, "metrics"):
        _equal(got, plain["metrics"], f"metrics@{w}")
    for (name, key), v in plain["metrics"]["leaves"].items():
        np.testing.assert_array_equal(
            v, np.asarray(ref["metrics"].data[name][key]),
            err_msg=f"{name}.{key}")


# ------------------------------------------------ DQN data parallelism ----
def test_dqn_sharded_cold_decisions_and_short_run(runs):
    _, ref, plain, _ = runs
    for w, got in _ranks(runs, "dqn"):
        _equal(got, plain["dqn"], f"dqn@{w}")
    for g, r in zip(plain["dqn"]["cold"], ref["dqn"]):
        np.testing.assert_array_equal(g, r)
    assert 0.0 < plain["dqn"]["run"]["holdout"][0] <= 1.0 + 1e-6


# ------------------------------------------------- shard-local topology ---
def test_shard_local_generator_and_local_contention(runs):
    _, ref, _, _ = runs
    for w, got in _ranks(runs, "local"):
        np.testing.assert_array_equal(got["cell_edge"], ref["local"][w])
        assert got["is_local"]
        for key in ("got", "global"):
            for g, r in zip(got[key], got["want"]):
                assert np.array_equal(g, r), (w, key)
        for g, r in zip(got["got_resp"], got["want_resp"]):
            assert np.array_equal(g, r), w
        if w > 1:
            assert "shard-local" in got["reject"]


def test_shard_local_divisibility_and_assignment_errors():
    from repro_torch.fleet import scenarios, topology
    d = ranks.Draws(0, "cpu")
    with pytest.raises(ValueError) as want:
        jtopo.random_topology(jax.random.PRNGKey(0), 10, 4,
                              shard_local=True, n_shards=4)
    with pytest.raises(ValueError, match="divisible") as got:
        topology.random_topology(d, 10, 4, shard_local=True, n_shards=4)
    assert str(got.value) == str(want.value)
    for kw, match in ((dict(assignment="skewed"), "random"),
                      (dict(p_edge_fail=0.1), "p_edge_fail")):
        cfg = dict(cells=8, users=2, n_edges=4, shard_local=True,
                   n_shards=2, **kw)
        with pytest.raises(ValueError, match=match):
            jscen.make_topology(jax.random.PRNGKey(0),
                                jscen.FleetConfig(**cfg))
        with pytest.raises(ValueError, match=match):
            scenarios.make_topology(d, scenarios.FleetConfig(**cfg))
    # the unconstrained generator crosses the blocks (same sizes), the
    # capped one never does, with every edge inside its cells' block
    free = topology.random_topology(d, 32, 8)
    assert not topology.is_shard_local(free, 4)
    capped = topology.random_topology(d, 32, 8, shard_local=True,
                                      n_shards=4)
    assert topology.is_shard_local(capped, 4)
    ce = capped.cell_edge.numpy()
    for e in range(8):
        owners = np.nonzero(ce == e)[0]
        assert (owners // 8 == e // 2).all()
