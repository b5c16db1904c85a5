"""The port's coupled-fleet oracle (``population.topology_bruteforce``,
one ``kernels.ops.best_response_round`` a round) against the JAX
package's, on the CPU, where a round runs the kernel's plain version.

The same fleets (drawn by the reference, carried across as numpy) go
through both packages. Integer leaves — the decisions, ``converged``,
``rounds`` — must be equal; each cell's expected ms within a relative
1e-6 (it is in fact bit-equal: the port's float32 latency model rounds
as the reference's jitted one does, see ``fleet.dynamics.fma`` and
``div_const``). The behaviour checks mirror ``tests/test_topology.py``.

Pinned assumption: which multiply-adds the reference's float32 path
fuses, and that it folds constant divisors into reciprocal products, was
fitted to XLA's CPU compiler in JAX/jaxlib 0.9.0 (``XLA_FITTED``), the
version these tests run against. Another JAX version or backend may fuse
otherwise; the bit-equality asserted here is what would show it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spaces import SpaceSpec as JSpaceSpec
from repro.core.spaces import restricted_actions as jrestricted
from repro.fleet import api as japi
from repro.fleet import dynamics as jdyn
from repro.fleet import policy as jpolicy
from repro.fleet import population as jpop
from repro.fleet import scenarios as jscen
from repro.fleet import topology as jtopo
from repro_torch import convert
from repro_torch.fleet import api, dynamics, policy, population, scenarios
from repro_torch.fleet import topology
from repro_torch.kernels import best_response

MS_RTOL = 1e-6
#: the JAX/jaxlib version whose XLA CPU fusions ``fleet.dynamics.fma`` and
#: ``div_const`` reproduce (see the module docstring)
XLA_FITTED = "0.9.0"


def _carry(js, calib=None):
    topo = None if js.topo is None else (
        np.asarray(js.topo.cell_edge), np.asarray(js.topo.edge_capacity),
        np.asarray(js.topo.cloud_servers))
    return convert.scenario(np.asarray(js.end_b), np.asarray(js.edge_b),
                            np.asarray(js.member), np.asarray(js.active),
                            0, topo, calib, device="cpu")


def _fleet(name):
    """(reference scenario, port scenario, users, goal) of a named
    coupled fleet."""
    if name == "hot_edge_16x4":
        js = jscen.mixed_table5_fleet(jax.random.PRNGKey(0), 16, 2)
        topo = jtopo.hot_edge_topology(16, 4, hot_fraction=0.6,
                                       cloud_servers=8.0)
        users, goal = 2, 89.0
    elif name == "skewed_64x8":
        js = jscen.mixed_table5_fleet(jax.random.PRNGKey(0), 64, 3,
                                      min_users=1, max_users=3)
        topo = jtopo.skewed_topology(jax.random.PRNGKey(1), 64, 8, skew=1.5,
                                     cloud_servers=128.0)
        users, goal = 3, 89.0
    elif name == "one_user_24x3":
        js = jscen.mixed_table5_fleet(jax.random.PRNGKey(4), 24, 1)
        topo = jtopo.hot_edge_topology(24, 3, hot_fraction=0.7,
                                       cloud_servers=6.0)
        users, goal = 1, 80.0
    else:
        raise KeyError(name)
    js = jscen.with_topology(js, topo)
    return js, _carry(js), users, goal


def _table(users, restricted=False):
    spec = JSpaceSpec(users)
    acts = jrestricted(spec) if restricted else spec.all_actions()
    return spec.decode_actions_batch(acts)


def _check_same(got, want):
    ms, idx, converged, rounds = got
    jms, jidx, jconverged, jrounds = want
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (converged, rounds) == (bool(jconverged), int(jrounds))
    np.testing.assert_allclose(ms.numpy(), np.asarray(jms), rtol=MS_RTOL,
                               atol=0.0)


@pytest.mark.parametrize("name", ["hot_edge_16x4", "skewed_64x8",
                                  "one_user_24x3"])
def test_topology_bruteforce_matches_the_reference(name):
    js, ps, users, goal = _fleet(name)
    pu = _table(users)
    want = jpop.topology_bruteforce(js, jnp.asarray(pu), goal)
    got = population.topology_bruteforce(ps, torch.tensor(pu), goal)
    assert want[3] >= 1
    _check_same(got, want)


@pytest.mark.parametrize("max_rounds", [1, 2])
def test_a_cut_sweep_matches_the_reference(max_rounds):
    """max_rounds below the fixed point: the last sweep comes back
    unconverged, on both sides alike."""
    js, ps, users, goal = _fleet("hot_edge_16x4")
    pu = _table(users)
    want = jpop.topology_bruteforce(js, jnp.asarray(pu), goal,
                                    max_rounds=max_rounds)
    got = population.topology_bruteforce(ps, torch.tensor(pu), goal,
                                         max_rounds=max_rounds)
    _check_same(got, want)


def test_a_calibrated_coupled_fleet_matches_the_reference():
    scale, off = [1.3, 0.8, 1.1], [5.0, -20.0, 12.5]
    js, _, users, goal = _fleet("skewed_64x8")
    js = jscen.FleetScenario(js.end_b, js.edge_b, js.member, js.active, js.t,
                             js.topo, jdyn.Calibration(jnp.asarray(scale),
                                                       jnp.asarray(off)))
    ps = _carry(js, (np.float32(scale), np.float32(off)))
    pu = _table(users, restricted=True)
    want = jpop.topology_bruteforce(js, jnp.asarray(pu), goal)
    got = population.topology_bruteforce(ps, torch.tensor(pu), goal)
    _check_same(got, want)


def test_one_round_of_the_plain_sweep_matches_the_reference_round():
    js, ps, users, goal = _fleet("skewed_64x8")
    pu = _table(users)
    _, idx = jpop._isolated_bruteforce(js, jnp.asarray(pu), goal)
    feas, ce, cc = population._candidate_tables(ps, torch.tensor(pu), goal,
                                                4096)
    topo = js.topo
    want = jpop._best_response_round(
        idx, jnp.asarray(pu), js.end_b, js.edge_b, js.member,
        jnp.asarray(feas.numpy()), jnp.asarray(ce.numpy()),
        jnp.asarray(cc.numpy()), topo.cell_edge, topo.edge_capacity,
        topo.cloud_servers)
    got, changed = best_response.plain(
        torch.tensor(np.asarray(idx)), torch.tensor(pu), ps.end_b,
        ps.edge_b, ps.member, feas, ce, cc, ps.topo.cell_edge,
        ps.topo.edge_capacity, ps.topo.cloud_servers)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(changed) == bool((np.asarray(want) != np.asarray(idx)).any())
    assert population.BEST_RESPONSE_TOL == jpop.BEST_RESPONSE_TOL


def test_candidate_tables_match_the_references_numpy_tables():
    """feas / cand_e / cand_c, built on the scenario's device chunked over
    K, against the reference's host arithmetic (a chunk smaller than K)."""
    js, ps, users, goal = _fleet("skewed_64x8")
    pu = _table(users)
    feas, ce, cc = population._candidate_tables(ps, torch.tensor(pu), goal,
                                                chunk=300)
    member = np.asarray(js.member)
    nm = np.maximum(member.sum(-1), 1)[:, None]
    acc = jdyn.accuracies(pu)
    macc = np.where(member.any(-1)[:, None],
                    (acc[None] * member[:, None, :]).sum(-1) / nm, 100.0)
    np.testing.assert_array_equal(feas.numpy(), jdyn.feasible(macc, goal))
    np.testing.assert_array_equal(
        ce.numpy(), ((pu[None] == jdyn.A_EDGE) & member[:, None]).sum(-1))
    np.testing.assert_array_equal(
        cc.numpy(), ((pu[None] == jdyn.A_CLOUD) & member[:, None]).sum(-1))


def test_identity_topology_matches_the_isolated_oracle():
    """Under the 1:1 identity topology the coupled oracle terminates at
    the isolated optimum in a single sweep (``test_topology.py:250``)."""
    iso = _carry(jscen.mixed_table5_fleet(jax.random.PRNGKey(2), 16, 2))
    pu = torch.tensor(_table(2))
    iso_ms, iso_idx = population.fleet_bruteforce(iso, pu, 85.0)
    coupled = scenarios.with_topology(iso, topology.identity_topology(16))
    ms, idx, converged, rounds = population.topology_bruteforce(coupled, pu,
                                                                85.0)
    assert converged and rounds == 1
    assert torch.equal(idx, iso_idx)
    torch.testing.assert_close(ms, iso_ms, rtol=1e-6, atol=0.0)
    # without a topology it is the isolated oracle, converged in 0 rounds
    ms0, idx0, converged0, rounds0 = population.topology_bruteforce(
        iso, pu, 85.0)
    assert converged0 and rounds0 == 0 and torch.equal(idx0, iso_idx)


def test_fleet_bruteforce_dispatches_on_topology():
    _, ps, users, goal = _fleet("hot_edge_16x4")
    pu = torch.tensor(_table(users))
    ms, idx = population.fleet_bruteforce(ps, pu, goal)
    want = population.topology_bruteforce(ps, pu, goal)
    assert torch.equal(idx, want[1]) and torch.equal(ms, want[0])
    with pytest.raises(ValueError, match="no feasible action"):
        population.fleet_bruteforce(ps, pu, 99.0)


def test_topology_aware_beats_blind_routing_on_hot_edge():
    """The best-response decisions earn more expected reward than the
    isolated-optimal ones judged under the same shared contention, and
    every cell stays QoS-feasible (``test_topology.py:265``)."""
    cells, th = 24, 89.0
    iso = _carry(jscen.mixed_table5_fleet(jax.random.PRNGKey(0), cells, 2))
    topo = topology.hot_edge_topology(cells, 4, hot_fraction=0.6,
                                      cloud_servers=8.0)
    pu = torch.tensor(_table(2))
    _, blind_idx = population.fleet_bruteforce(iso, pu, th)
    b_ms, b_acc = topology.fleet_topology_expected_response(
        pu[blind_idx.long()], iso.end_b, iso.edge_b, topo, iso.member)
    a_ms, a_idx, converged, _ = population.topology_bruteforce(
        scenarios.with_topology(iso, topo), pu, th)
    _, a_acc = topology.fleet_topology_expected_response(
        pu[a_idx.long()], iso.end_b, iso.edge_b, topo, iso.member)
    assert converged
    assert float(dynamics.reward(a_ms, a_acc, th).mean()) > \
        float(dynamics.reward(b_ms, b_acc, th).mean())
    assert bool(dynamics.feasible(a_acc, th).all())


def test_best_response_never_worse_than_blind_per_round():
    """Each round's fleet cost stays at or below the isolated start's:
    every accepted switch strictly improves the switching cell against
    the then-current background (``test_topology.py:304``)."""
    js = jscen.mixed_table5_fleet(jax.random.PRNGKey(5), 16, 2)
    jt = jtopo.skewed_topology(jax.random.PRNGKey(6), 16, 3, skew=2.0,
                               cloud_servers=6.0)
    ps = _carry(jscen.with_topology(js, jt))
    pu = torch.tensor(_table(2))
    blind_ms, idx = population._isolated_bruteforce(ps, pu, 89.0)
    blind_ms, _ = topology.fleet_topology_expected_response(
        pu[idx.long()], ps.end_b, ps.edge_b, ps.topo, ps.member)
    feas, ce, cc = population._candidate_tables(ps, pu, 89.0, 4096)
    costs = [float(blind_ms.mean())]
    for _ in range(10):
        idx, changed = population._best_response_round(
            idx, pu, ps.end_b, ps.edge_b, ps.member, feas, ce, cc,
            ps.topo.cell_edge, ps.topo.edge_capacity, ps.topo.cloud_servers)
        ms, _ = topology.fleet_topology_expected_response(
            pu[idx.long()], ps.end_b, ps.edge_b, ps.topo, ps.member)
        costs.append(float(ms.mean()))
        if not bool(changed):
            break
    assert not bool(changed)
    assert all(c <= costs[0] + 1e-6 for c in costs[1:])


def test_holdout_reward_ratio_on_a_coupled_fleet_matches_the_reference():
    """A DQN's held-out score against the coupled oracle, with the
    reference's trained params carried across by ``convert``."""
    users = 2
    cfg = jscen.FleetConfig(cells=16, users=users, arrival_rate=1.0)
    jcfg = jpolicy.FleetDQNConfig(replay_capacity=256, batch_size=32,
                                  hidden=32, accuracy_threshold=85.0)
    jagent = jpolicy.FleetDQN(japi.SyntheticSource(cfg), cfg=jcfg, seed=5,
                              metrics=False)
    jagent.run(20)
    pagent = policy.FleetDQN(
        _carry(jagent.scen), scenarios.FleetConfig(cells=16, users=users),
        cfg=policy.FleetDQNConfig(replay_capacity=256, batch_size=32,
                                  hidden=32, accuracy_threshold=85.0),
        device="cpu")
    pagent.params = convert.mlp_params(
        jax.tree_util.tree_map(np.asarray, jagent.params), device="cpu")
    js, ps, _, _ = _fleet("hot_edge_16x4")
    jh = jpolicy.holdout_reward_ratio(jagent, js)
    ph = policy.holdout_reward_ratio(pagent, ps)
    assert abs(ph.ratio - jh.ratio) <= 1e-6
    np.testing.assert_array_equal(ph.feasible, np.asarray(jh.feasible))
    np.testing.assert_allclose(ph.optimal, np.asarray(jh.optimal),
                               rtol=MS_RTOL)


def test_oracle_policy_routes_a_coupled_fleet_as_the_reference():
    js, ps, users, goal = _fleet("skewed_64x8")
    jdec, jids = japi.OraclePolicy(users, threshold=goal).decisions(None, js)
    dec, ids = api.OraclePolicy(users, threshold=goal).decisions(None, ps)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("users", [1, 3, 5, 8])
def test_packed_candidates_keep_every_user_in_its_four_bits(users):
    """The kernel reads user u of candidate j as ``(packed[j] >> 4u) &
    15``: every id 0..9 of every user, the fifth user's in bits 16-19,
    comes back as the table holds it."""
    rng = np.random.default_rng(users)
    pu = torch.tensor(rng.integers(0, 10, (64, users)))
    pu[0] = 9
    packed = best_response.pack_actions(pu)
    assert packed.dtype == torch.int32 and packed.shape == (64,)
    back = torch.stack([(packed >> (4 * u)) & 15 for u in range(users)], -1)
    assert torch.equal(back.long(), pu)


def test_the_kernels_constants_are_built_once_and_read_only():
    c = best_response.consts()
    assert c is best_response.consts() and not c.flags.writeable
    assert c.dtype == np.float32 and c.shape == (18,)   # struct Consts
