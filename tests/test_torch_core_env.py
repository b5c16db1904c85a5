"""The port's single-cell environment and brute-force oracle
(``repro_torch.core.env``, ``repro_torch.core.bruteforce``) against the
JAX package's (``repro.core``, numpy), on the CPU.

Both environments draw their noise and exogenous load from
``np.random.default_rng(seed)``, so the same seed gives both the same
draws and the trajectories are compared step by step. Responses are
held to rtol 1e-12 (they agree bit for bit: both compute in float64 in
the same order); brute-force actions must be equal.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import spaces as jspaces
from repro.fleet import dynamics as jdyn
import repro_torch.core as P
from repro_torch.core import spaces as pspaces
from repro_torch.fleet import dynamics as pdyn

EXPS = sorted(J.EXPERIMENTS)
RTOL = 1e-12


def _envs(n, exp="EXP-A", **kw):
    return (J.EndEdgeCloudEnv(n, J.EXPERIMENTS[exp], **kw),
            P.EndEdgeCloudEnv(n, P.EXPERIMENTS[exp], device="cpu", **kw))


def _actions(spec, n):
    """Every joint action for N <= 3; 2,000 sampled (seeded) at N = 5."""
    if n <= 3:
        return spec.all_actions()
    return np.random.default_rng(n).integers(0, spec.n_joint_actions, 2000)


def test_constants_and_exports_match_the_reference():
    for name in P.env.__all__:
        got, want = getattr(P.env, name), getattr(J.env, name)
        if name in ("EndEdgeCloudEnv", "Scenario", "t_comp_device"):
            continue
        if name == "EXPERIMENTS":
            assert {k: (v.end_b, v.edge_b) for k, v in got.items()} == \
                {k: (v.end_b, v.edge_b) for k, v in want.items()}
        elif isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name
    for name in ("T_ORCH_MS", "T_UP_EDGE_MS", "T_HOP_CLOUD_MS"):
        np.testing.assert_array_equal(getattr(pdyn, name),
                                      getattr(jdyn, name))
    assert (pdyn.A_EDGE, pdyn.A_CLOUD) == (pspaces.A_EDGE, pspaces.A_CLOUD)
    ids = np.arange(8)
    np.testing.assert_array_equal(
        pdyn.t_comp_device(torch.tensor(ids), torch.float64).numpy(),
        jdyn.t_comp_device(ids))
    assert (pspaces.EDGE_CPU_LEVELS, pspaces.CLOUD_CPU_LEVELS) == \
        (jspaces.EDGE_CPU_LEVELS, jspaces.CLOUD_CPU_LEVELS)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_spaces_state_and_action_vectors(n):
    js, ps = jspaces.SpaceSpec(n), pspaces.SpaceSpec(n)
    assert ps.state_dim == js.state_dim
    ends = [(i % 2, 0, (i + 1) % 2) for i in range(n)]
    st = ps.state_tuple(5, 1, 0, 7, 0, 1, ends)
    assert st == js.state_tuple(5, 1, 0, 7, 0, 1, ends)
    np.testing.assert_array_equal(ps.state_vector(st), js.state_vector(st))
    acts = _actions(js, n)
    np.testing.assert_array_equal(ps.action_vectors_batch(acts),
                                  js.action_vectors_batch(acts))
    np.testing.assert_array_equal(ps.action_vector(int(acts[-1])),
                                  js.action_vector(int(acts[-1])))


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_expected_response_matches_the_reference(exp, n):
    je, pe = _envs(n, exp, noise=0)
    acts = _actions(je.spec, n)
    jm, ja = je.expected_response_batch(acts)
    pm, pa = pe.expected_response_batch(acts)
    assert pm.dtype == torch.float64 and pm.shape == (len(acts),)
    np.testing.assert_allclose(pm.numpy(), jm, rtol=RTOL, atol=0)
    np.testing.assert_allclose(pa.numpy(), ja, rtol=RTOL, atol=0)
    for a in acts[:: max(1, len(acts) // 50)]:
        np.testing.assert_allclose(pe.expected_response(int(a)),
                                   je.expected_response(int(a)), rtol=RTOL)
    np.testing.assert_array_equal(
        pe._decode_actions(acts).numpy(), je.spec.decode_actions_batch(acts))


def test_response_times_with_counts_override():
    je, pe = _envs(4, "EXP-C", noise=0)
    for per in ([8, 8, 9, 0], [9, 9, 9, 9], [3, 8, 9, 7]):
        for counts in (None, (3, 1), (0, 4)):
            np.testing.assert_allclose(
                pe.response_times(per, noisy=False, counts=counts),
                je.response_times(per, noisy=False, counts=counts),
                rtol=RTOL)


@pytest.mark.parametrize("exogenous", [False, True])
@pytest.mark.parametrize("n,exp", [(3, "EXP-B"), (5, "EXP-D")])
def test_step_trajectory_matches_the_reference(n, exp, exogenous):
    """500 steps under noise on the same seed: states equal, rewards and
    per-user ms within 1e-12."""
    kw = dict(accuracy_threshold=85.0, seed=7, noise=0.02,
              exogenous=exogenous)
    je, pe = _envs(n, exp, **kw)
    assert je.reset() == pe.reset()
    acts = np.random.default_rng(11).integers(0, je.spec.n_joint_actions,
                                              500)
    for a in acts:
        js, jr, ji = je.step(int(a))
        ps, pr, pi = pe.step(int(a))
        assert ps == js
        np.testing.assert_allclose(pr, jr, rtol=RTOL)
        np.testing.assert_allclose(pi["per_user_ms"], ji["per_user_ms"],
                                   rtol=RTOL)
        assert (pi["violated"], pi["decision"]) == \
            (ji["violated"], ji["decision"])
        assert pi["avg_accuracy"] == ji["avg_accuracy"]


def test_reward_floor_and_feasibility():
    pe = P.EndEdgeCloudEnv(2, P.EXPERIMENTS["EXP-A"], accuracy_threshold=89.0,
                           seed=0, noise=0, device="cpu")
    _, r_ok, info = pe.step(pe.spec.encode_action([0, 0]))
    assert not info["violated"] and r_ok > -2.5
    _, r_bad, info = pe.step(pe.spec.encode_action([7, 7]))
    assert info["violated"] and r_bad == -2.5


# --------------------------------------------------------- brute force ----
@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_bruteforce_matches_the_reference(exp, n):
    """Every threshold, the full action set and the SOTA [36] restricted
    one: the action equal, ms and accuracy within 1e-12, and the same
    error where no action is feasible."""
    je, pe = _envs(n, exp, noise=0)
    for acts in (None, jspaces.restricted_actions(je.spec)):
        for th in J.THRESHOLDS.values():
            try:
                want = J.bruteforce_optimal(je, th, acts)
            except ValueError as e:
                with pytest.raises(ValueError, match="no feasible action"):
                    P.bruteforce_optimal(pe, th, acts)
                assert "no feasible" in str(e)
                continue
            got = P.bruteforce_optimal(pe, th, acts)
            assert got[0] == want[0] and got[3] == want[3], (th, got, want)
            np.testing.assert_allclose(got[1:3], want[1:3], rtol=RTOL)


@pytest.mark.parametrize("n,goal", [(5, 80.0), (4, 85.0), (3, 89.0),
                                    (5, 89.9)])
def test_bruteforce_at_goals_many_actions_hit_exactly(n, goal):
    """Goals that many joint actions' mean accuracies equal exactly: the
    float64 means put each on the same side of the 1e-9 slack as the
    reference's, so the feasible sets are equal, and so is the argmin."""
    for exp in EXPS:
        je, pe = _envs(n, exp, noise=0)
        acts = je.spec.all_actions()
        _, ja = je.expected_response_batch(acts)
        _, pa = pe.expected_response_batch(acts)
        if exp == "EXP-A":
            assert int((ja == goal).sum()) > 0
        np.testing.assert_array_equal(pdyn.feasible(pa, goal).numpy(),
                                      jdyn.feasible(ja, goal))
        assert P.bruteforce_optimal(pe, goal)[0] == \
            J.bruteforce_optimal(je, goal)[0]


def test_float32_means_would_flip_feasibility_at_80_percent():
    """Why the environment computes in float64: at N=5 and the 80% goal,
    24 joint actions change feasibility when the mean accuracy is taken
    in float32 (the fleet path's type) instead of float64."""
    spec = pspaces.SpaceSpec(5)
    pu = torch.tensor(spec.decode_actions_batch(spec.all_actions()))
    acc32 = pdyn.accuracies(pu).mean(-1)
    assert acc32.dtype == torch.float32
    _, acc64 = P.EndEdgeCloudEnv(5, device="cpu").expected_response_batch(
        spec.all_actions())
    flips = pdyn.feasible(acc32, 80.0) != pdyn.feasible(acc64, 80.0)
    assert int(flips.sum()) == 24
    np.testing.assert_array_equal(
        pdyn.feasible(acc64, 80.0).numpy(),
        jdyn.feasible(jdyn.accuracies(spec.decode_actions_batch(
            spec.all_actions())).mean(-1), 80.0))


def test_bruteforce_complexity_eq6():
    for n in range(1, 6):
        assert P.bruteforce_complexity(n) == J.bruteforce_complexity(n)


def test_fleet_path_stays_float32():
    """The default type of the shared dynamics is still float32, and the
    float64 path agrees with it to float32 rounding."""
    rng = np.random.default_rng(0)
    pu = torch.tensor(rng.integers(0, 10, (64, 5)))
    end_b = torch.tensor(rng.integers(0, 2, (64, 5)))
    edge_b = torch.tensor(rng.integers(0, 2, 64))
    t32 = pdyn.cell_response_times(pu, end_b, edge_b)
    t64 = pdyn.cell_response_times(pu, end_b, edge_b, torch.float64)
    assert t32.dtype == torch.float32 and t64.dtype == torch.float64
    np.testing.assert_allclose(t32.numpy(), t64.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        t64.numpy(), np.asarray(jdyn.cell_response_times(
            pu.numpy(), end_b.numpy(), edge_b.numpy())), rtol=1e-6)
