"""The port's fleet loop (``repro_torch``) against the JAX package, on the
CPU at a small size: the same inputs go through both packages, and
where the JAX side draws random numbers the test takes its own draws
from the JAX agent's key chain and injects them into the port through
the ``repro_torch.rng.Draws`` seam.

Integer leaves (decisions, counts, scenario fields) must be equal. Float
leaves are allclose with the tolerance stated at each check.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spaces import SpaceSpec as JSpaceSpec
from repro.fleet import api as japi
from repro.fleet import dynamics as jdyn
from repro.fleet import policy as jpolicy
from repro.fleet import population as jpop
from repro.fleet import replay as jreplay
from repro.fleet import scenarios as jscen
from repro.fleet import topology as jtopo
from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.fleet import api, dynamics, policy, population, scenarios
from repro_torch.fleet import replay, topology
from repro_torch.rng import Draws
from repro_torch.training import optimizer

TRACE = os.path.join(os.path.dirname(__file__), "data", "trace_small.npz")


class Recorded(Draws):
    """Draws that replay recorded values site by site, in order; a draw
    at a site with nothing recorded fails the test."""

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
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _carry(js):
    """A JAX ``FleetScenario`` carried across through ``convert``."""
    topo = None if js.topo is None else (
        np.asarray(js.topo.cell_edge), np.asarray(js.topo.edge_capacity),
        np.asarray(js.topo.cloud_servers))
    calib = None if js.calib is None else (
        np.asarray(js.calib.compute_scale), np.asarray(js.calib.hop_offset_ms))
    return convert.scenario(np.asarray(js.end_b), np.asarray(js.edge_b),
                            np.asarray(js.member), np.asarray(js.active),
                            np.asarray(js.t), topo, calib, device="cpu")


def _assert_same_scenario(ps, js):
    for f in ("end_b", "edge_b", "member", "active"):
        np.testing.assert_array_equal(_np(getattr(ps, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ps.t == int(js.t)


# ------------------------------------------------------------ dynamics ----
@pytest.mark.parametrize("users", [1, 2, 3])
def test_dynamics_every_joint_action_matches_jnp(users):
    """response_times / expected_response for all 10^N joint actions
    under several link patterns, with and without an active mask, and
    the calibrated and topology paths."""
    spec = JSpaceSpec(users)
    pu = spec.decode_actions_batch(spec.all_actions())           # (K, N)
    k = pu.shape[0]
    rng = np.random.default_rng(users)
    end_b = rng.integers(0, 2, (k, users))
    edge_b = rng.integers(0, 2, k)
    active = rng.random((k, users)) < 0.7
    t = [torch.tensor(x) for x in (pu, end_b, edge_b, active)]
    j = [jnp.asarray(x) for x in (pu, end_b, edge_b, active)]
    # float32 elementwise math with the reference's op order; XLA may
    # fuse a multiply-add, so allow a few ulp
    tol = dict(rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(
        _np(dynamics.response_times(t[0], t[1], t[2])),
        np.asarray(jdyn.response_times(j[0], j[1], j[2], xp=jnp)), **tol)
    for act_t, act_j in ((None, None), (t[3], j[3])):
        ms, acc = dynamics.expected_response(t[0], t[1], t[2], active=act_t)
        jms, jacc = jdyn.expected_response(j[0], j[1], j[2], active=act_j,
                                           xp=jnp)
        np.testing.assert_allclose(_np(ms), np.asarray(jms), **tol)
        np.testing.assert_allclose(_np(acc), np.asarray(jacc), **tol)
    scale, off = [1.3, 0.8, 1.1], [5.0, -20.0, 12.5]
    calib = dynamics.Calibration(torch.tensor(scale), torch.tensor(off))
    jcal = jdyn.Calibration(jnp.asarray(scale), jnp.asarray(off))
    np.testing.assert_allclose(
        _np(dynamics.response_times(t[0], t[1], t[2], active=t[3],
                                    calib=calib)),
        np.asarray(jdyn.response_times(j[0], j[1], j[2], active=j[3],
                                       calib=jcal, xp=jnp)), **tol)
    np.testing.assert_array_equal(
        _np(dynamics.feasible(acc, 85.0)),
        np.asarray(jdyn.feasible(jacc, 85.0, xp=jnp)))
    ce = rng.integers(0, 7, k).astype(np.int32)
    cap = np.asarray([1.0, 2.0, 0.5, 1.0, 1.0, 3.0, 1.0], np.float32)
    ptopo = topology.Topology(torch.tensor(ce), torch.tensor(cap), 40.0)
    jt = jtopo.Topology(jnp.asarray(ce), jnp.asarray(cap),
                        jnp.float32(40.0))
    ms, acc = topology.topology_expected_response(t[0], t[1], t[2], ptopo,
                                                  active=t[3])
    jms, jacc = jtopo.topology_expected_response(j[0], j[1], j[2], jt,
                                                 active=j[3])
    np.testing.assert_allclose(_np(ms), np.asarray(jms), **tol)
    np.testing.assert_allclose(_np(acc), np.asarray(jacc), **tol)
    np.testing.assert_allclose(
        _np(topology.edge_utilization(t[0], ptopo, active=t[3])),
        np.asarray(jtopo.edge_utilization(j[0], jt, active=j[3])), **tol)


def test_identity_topology_reduces_to_isolated_path():
    spec = JSpaceSpec(3)
    pu = torch.tensor(spec.decode_actions_batch(spec.all_actions()))
    rng = np.random.default_rng(1)
    end_b = torch.tensor(rng.integers(0, 2, (1000, 3)))
    edge_b = torch.tensor(rng.integers(0, 2, 1000))
    iso = dynamics.expected_response(pu, end_b, edge_b)
    topo = topology.topology_expected_response(
        pu, end_b, edge_b, topology.identity_topology(1000))
    for a, b in zip(iso, topo):
        np.testing.assert_array_equal(_np(a), _np(b))


# ----------------------------------------------------------- scenarios ----
@pytest.mark.parametrize("name", ["EXP-A", "EXP-B", "EXP-C", "EXP-D"])
def test_table5_fleet_fields_equal(name):
    _assert_same_scenario(scenarios.table5_fleet(name, 9, 4, device="cpu"),
                          jscen.table5_fleet(name, 9, 4))


@pytest.mark.parametrize("sizes", [(None, None), (1, 3)])
def test_mixed_table5_fleet_carried_draws_give_equal_fields(sizes):
    lo, hi = sizes
    cells, users = 40, 3
    key = jax.random.PRNGKey(11)
    js = jscen.mixed_table5_fleet(key, cells, users, min_users=lo,
                                  max_users=hi)
    k_pick, k_size = jax.random.split(key)
    sites = {"scenario.pick": [jax.random.randint(k_pick, (cells,), 0, 4)]}
    if lo is not None:
        sites["scenario.sizes"] = [jax.random.randint(k_size, (cells,), lo,
                                                      hi + 1)]
    ps = scenarios.mixed_table5_fleet(Recorded(**sites), cells, users,
                                      min_users=lo, max_users=hi)
    _assert_same_scenario(ps, js)
    _assert_same_scenario(_carry(js), js)


def test_trace_source_replays_trace_small_frame_for_frame():
    jsrc = japi.TraceSource.load(TRACE)
    psrc = api.TraceSource.load(TRACE, device="cpu")
    js, _ = jsrc.reset(jax.random.PRNGKey(0))
    ps, _ = psrc.reset(None)
    for _ in range(jsrc.horizon + 3):              # past the wrap
        _assert_same_scenario(ps, js)
        np.testing.assert_array_equal(_np(ps.topo.cell_edge),
                                      np.asarray(js.topo.cell_edge))
        js, _ = jsrc.step(jax.random.PRNGKey(0), js)
        ps, _ = psrc.step(None, ps)
    np.testing.assert_array_equal(
        api.load_trace(TRACE).active_frames(),
        japi.load_trace(TRACE).active_frames())


def test_trace_round_trips_through_save_trace(tmp_path):
    trace = api.load_trace(TRACE)
    api.save_trace(tmp_path / "t.npz", trace)
    again = japi.load_trace(tmp_path / "t.npz")
    for f in ("end_b", "edge_b", "arrival_time", "member", "cell_edge"):
        np.testing.assert_array_equal(getattr(again, f), getattr(trace, f))


# ---------------------------------------------------------- tabular RL ----
def _tabular_pair(cells=16, users=3, seed=3, noise=0.02, threshold=0.0):
    js = jscen.mixed_table5_fleet(jax.random.PRNGKey(2), cells, users,
                                  min_users=1, max_users=users)
    fcfg = jscen.FleetConfig(cells=cells, users=users)
    jcfg = jpop.FleetQConfig(noise=noise, accuracy_threshold=threshold)
    jagent = jpop.FleetQLearning(js, fcfg, cfg=jcfg, seed=seed,
                                 metrics=False)
    pcfg = population.FleetQConfig(noise=noise,
                                   accuracy_threshold=threshold)
    return jagent, js, fcfg, pcfg


def _tabular_draws(seed, cells, n, noise):
    """The explore uniforms and noise normals the JAX agent's ``run(n)``
    consumes: run splits the agent key once, the scan splits per step,
    and each step splits (explore, noise, scenario)."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    u, z = [], []
    for _ in range(n):
        key, k = jax.random.split(key)
        k_exp, k_noise, _ = jax.random.split(k, 3)
        u.append(jax.random.uniform(k_exp, (cells,)))
        if noise:
            z.append(jax.random.normal(k_noise, (cells,)))
    return Recorded(explore=u, noise=z)


def test_fleet_qlearning_50_steps_match_jax_under_its_draws():
    cells, n = 16, 50
    jagent, js, fcfg, pcfg = _tabular_pair(cells)
    jms, jacc = jagent.run(n)
    fleet_cfg = scenarios.FleetConfig(cells=cells, users=3)
    pagent = population.FleetQLearning(
        _carry(js), fleet_cfg, cfg=pcfg, device="cpu",
        draws=_tabular_draws(3, cells, n, pcfg.noise))
    pms, pacc = pagent.run(n)
    np.testing.assert_allclose(_np(pagent.q), np.asarray(jagent.q),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_np(pagent.counts),
                                  np.asarray(jagent.counts))
    np.testing.assert_array_equal(_np(pagent.greedy_decisions()),
                                  np.asarray(jagent.greedy_decisions()))
    np.testing.assert_allclose(pms, jms, rtol=1e-5)
    np.testing.assert_allclose(pacc, jacc, rtol=1e-6)
    assert pagent.eps == pytest.approx(jagent.eps, rel=1e-7)
    # the trained tables route and score identically
    g, ids = api.FleetOrchestrator(pagent).route()
    jg, jids = japi.FleetOrchestrator(jagent).route()
    np.testing.assert_array_equal(_np(g), np.asarray(jg))
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    for a, b in zip(pagent.greedy_expected(), jagent.greedy_expected()):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    pb = population.fleet_bruteforce(pagent.scen, pagent.pu_table, 85.0)
    jb = jpop.fleet_bruteforce(js, jagent.pu_table, 85.0)
    np.testing.assert_array_equal(_np(pb[1]), np.asarray(jb[1]))
    np.testing.assert_allclose(_np(pb[0]), np.asarray(jb[0]), rtol=1e-6)


def test_fleet_qlearning_on_trace_small_matches_jax_under_its_draws():
    """Milestone 1: trained on the recorded trace (shared-edge topology,
    finite cloud queue, moving links and arrivals), the port's Q-table
    and greedy decisions equal the reference's under the same draws."""
    n = 30
    jagent = jpop.FleetQLearning(japi.TraceSource.load(TRACE),
                                 cfg=jpop.FleetQConfig(), seed=4,
                                 metrics=False)
    jagent.run(n)
    cells = jagent.scen.cells
    pagent = population.FleetQLearning(
        api.TraceSource.load(TRACE, device="cpu"),
        cfg=population.FleetQConfig(), device="cpu",
        draws=_tabular_draws(4, cells, n, 0.02))
    pagent.run(n)
    np.testing.assert_allclose(_np(pagent.q), np.asarray(jagent.q),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_np(pagent.counts),
                                  np.asarray(jagent.counts))
    np.testing.assert_array_equal(_np(pagent.greedy_decisions()),
                                  np.asarray(jagent.greedy_decisions()))
    _assert_same_scenario(pagent.scen, jagent.scen)


def test_fleet_qlearning_guards_raise_the_reference_errors():
    jagent, js, fcfg, pcfg = _tabular_pair(8)
    pagent = population.FleetQLearning(
        _carry(js), scenarios.FleetConfig(cells=8, users=3), cfg=pcfg,
        device="cpu")
    wide = scenarios.table5_fleet("EXP-A", 8, 4, device="cpu")
    other = scenarios.table5_fleet("EXP-A", 5, 3, device="cpu")
    for bad, jbad in ((wide, jscen.table5_fleet("EXP-A", 8, 4)),
                      (other, jscen.table5_fleet("EXP-A", 5, 3))):
        with pytest.raises(ValueError) as want:
            japi.FleetOrchestrator(jagent).route(scen=jbad)
        with pytest.raises(ValueError) as got:
            api.FleetOrchestrator(pagent).route(scen=bad)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ DQN path ----
def _np_params(hidden, seed):
    rng = np.random.default_rng(seed)
    dims = [11, hidden, hidden, 10]
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a)
                   ).astype(np.float32),
             "b": (rng.standard_normal(b) * 0.05).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def test_apply_updates_one_step_matches_jax():
    params = _np_params(16, 0)
    rng = np.random.default_rng(1)
    grads = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
              for k, v in p.items()} for p in params]
    m = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
          for k, v in p.items()} for p in params]
    v = [{k: rng.random(v.shape).astype(np.float32) * 0.1
          for k, v in p.items()} for p in params]
    state = {"m": m, "v": v, "step": 4}
    cfg = jopt.constant_lr_adamw(1e-3)
    jp, js, _ = jax.jit(jopt.apply_updates, static_argnums=3)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, state), cfg)
    pp = convert.mlp_params(params, device="cpu")
    ps = convert.opt_state(state, device="cpu")
    optimizer.apply_updates(pp, convert.mlp_params(grads, device="cpu"), ps,
                            optimizer.constant_lr_adamw(1e-3))
    assert ps["step"] == int(js["step"])
    for got, want in ((pp, jp), (ps["m"], js["m"]), (ps["v"], js["v"])):
        for g, w in zip(got, want):
            for k in ("w", "b"):
                np.testing.assert_allclose(_np(g[k]), np.asarray(w[k]),
                                           rtol=1e-6, atol=1e-6)


def _dqn_pair(threshold, cells=16, users=3, hidden=32, seed=5):
    src = jscen.FleetConfig(cells=cells, users=users, arrival_rate=1.0,
                            p_r2w=0.05, p_w2r=0.1)
    jcfg = jpolicy.FleetDQNConfig(replay_capacity=256, batch_size=32,
                                  hidden=hidden,
                                  accuracy_threshold=threshold)
    jagent = jpolicy.FleetDQN(japi.SyntheticSource(src), cfg=jcfg,
                              seed=seed, metrics=False)
    pcfg = policy.FleetDQNConfig(replay_capacity=256, batch_size=32,
                                 hidden=hidden,
                                 accuracy_threshold=threshold)
    pagent = policy.FleetDQN(_carry(jagent.scen),
                             scenarios.FleetConfig(cells=cells, users=users),
                             cfg=pcfg, device="cpu")
    return jagent, pagent


def _carry_params(jagent, pagent):
    pagent.params = convert.mlp_params(
        jax.tree_util.tree_map(np.asarray, jagent.params), device="cpu")
    pagent.opt = convert.opt_state(
        jax.tree_util.tree_map(np.asarray, jagent.opt), device="cpu")


def test_dqn_train_step_with_injected_replay_indices_matches_jax():
    jagent, pagent = _dqn_pair(85.0)
    _carry_params(jagent, pagent)
    users, sd = 3, policy.state_dim(3)
    rng = np.random.default_rng(3)
    rows = 48
    s = (rng.random((rows, sd)) < 0.5).astype(np.float32)
    s2 = (rng.random((rows, sd)) < 0.5).astype(np.float32)
    a = rng.integers(0, 10, (rows, users)).astype(np.int32)
    r = -rng.random(rows).astype(np.float32) * 2
    # push the same rows on both sides, sample with the JAX key's indices
    jbuf = jreplay.replay_push(jagent.buffer, *[jnp.asarray(x)
                                                for x in (s, a, r, s2)])
    key = jax.random.PRNGKey(9)
    idx = jax.random.randint(key, (32,), 0, rows)
    batch_j = jreplay.replay_sample(key, jbuf, 32)
    replay.replay_push(pagent.buffer, *[torch.tensor(x)
                                        for x in (s, a, r, s2)])
    batch_p = replay.replay_sample(Recorded(replay=[idx]), pagent.buffer, 32)
    for bp, bj in zip(batch_p, batch_j):
        np.testing.assert_array_equal(_np(bp), np.asarray(bj))
    jp, jo, jloss = jax.jit(jagent._make_train_step())(
        jagent.params, jagent.opt, *batch_j)
    ploss = pagent.train_step(*batch_p)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    for g, w in zip(pagent.params, jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(_np(g[k]), np.asarray(w[k]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold", [0.0, 85.0])
def test_dqn_jax_trained_params_route_a_held_out_fleet_identically(
        threshold):
    jagent, pagent = _dqn_pair(threshold)
    jagent.run(20)
    _carry_params(jagent, pagent)
    held = jscen.mixed_table5_fleet(jax.random.PRNGKey(7), 48, 3,
                                    min_users=1, max_users=3)
    pheld = _carry(held)
    np.testing.assert_array_equal(
        _np(pagent.greedy_decisions(scen=pheld)),
        np.asarray(jagent.greedy_decisions(scen=held)))
    jh = jpolicy.holdout_reward_ratio(jagent, held)
    ph = policy.holdout_reward_ratio(pagent, pheld)
    assert abs(ph.ratio - jh.ratio) <= 1e-6
    np.testing.assert_array_equal(ph.feasible, np.asarray(jh.feasible))
    dec, ids = api.FleetOrchestrator(pagent).route(scen=pheld)
    jdec, jids = japi.FleetOrchestrator(jagent).route(scen=held)
    np.testing.assert_array_equal(_np(dec), np.asarray(jdec))
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    res = api.FleetOrchestrator(pagent).route(scen=pheld,
                                              with_edge_util=True,
                                              as_result=True)
    _, _, jutil = japi.FleetOrchestrator(jagent).route(
        scen=held, with_edge_util=True)
    np.testing.assert_allclose(_np(res.edge_util), np.asarray(jutil))


def test_dqn_features_match_the_reference_encoding():
    jagent, pagent = _dqn_pair(0.0)
    counts = np.random.default_rng(0).integers(0, 3, (16, 2)).astype(
        np.int32)
    js = jagent.scen
    ps = _carry(js)
    np.testing.assert_allclose(
        _np(policy.encode_fleet_state(torch.tensor(counts), ps)),
        np.asarray(jpolicy.encode_fleet_state(jnp.asarray(counts), js)),
        rtol=1e-6)
    for a, b in zip(policy.fused_head_features(torch.tensor(counts), ps),
                    jpolicy.fused_head_features(jnp.asarray(counts), js)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


def test_fleet_dqn_trains_end_to_end_on_the_cpu():
    _, pagent = _dqn_pair(85.0)
    ms, acc = pagent.run(5)
    assert ms.shape == (5,) and np.isfinite(ms).all()
    assert pagent.opt["step"] == 5 and len(pagent.buffer) == 5 * 16


# -------------------------------------------------------- device default --
@pytest.mark.parametrize("build", [
    lambda s, c: population.FleetQLearning(s, c),
    lambda s, c: policy.FleetDQN(s, c),
    lambda s, c: scenarios.table5_fleet("EXP-A", 4, 3),
])
def test_default_device_raises_without_cuda(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scen = scenarios.table5_fleet("EXP-A", 4, 3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(scen, scenarios.FleetConfig(cells=4, users=3))


def test_draws_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Draws(0)
    d = Draws(0, "cpu")
    assert d.device.type == "cpu"
    assert d.uniform("explore", (3,)).device.type == "cpu"


def test_identity_topology_fleet_gives_the_isolated_optimum():
    """A fleet with a topology goes through the coupled oracle, and
    under the identity topology it gives the isolated optimum (here a
    one-candidate table, so index 0 everywhere)."""
    iso = scenarios.table5_fleet("EXP-B", 6, 3, device="cpu")
    scen = scenarios.with_topology(iso, topology.identity_topology(6))
    pu = torch.zeros((1, 3), dtype=torch.int64)
    ms, idx = population.fleet_bruteforce(scen, pu)
    want_ms, want_idx = population.fleet_bruteforce(iso, pu)
    assert torch.equal(idx, want_idx) and torch.equal(ms, want_ms)
