"""The port's sim-to-real calibration loop (``repro_torch.fleet.calibrate``)
against the JAX package's, on the CPU.

* The synthetic fit of ``tests/test_calibrate.py`` (measured = comm +
  1.3 comp + 20 ms) on the same served requests through both packages:
  coefficients within rtol 1e-5 and atol 1e-4 ms (the model's float32
  components computed in another order; the fit itself is float64 in
  both); the model components equal on an isolated fleet and on the
  recorded trace's shared-edge topology within rtol 1e-6.
* Tiers with no served request keep the identity calibration.
* ``CalibratedDynamics`` stamps the fit on every scenario and both port
  agents train on it.
* ``calibrate_serving`` on CPU edge-ladder engines returns the
  reference's report layout and moves ``gap_x`` toward 1.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import api as japi
from repro.fleet import calibrate as jcal
from repro.fleet import dynamics as jdyn
from repro.fleet import scenarios as jscen
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.fleet import (CalibratedDynamics, api, calibrate, dynamics,
                               policy, population, scenarios)
from repro_torch.launch.serve import build_engines
from repro_torch.rng import Draws

TRACE = os.path.join(os.path.dirname(__file__), "data", "trace_small.npz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: ``calibrate_serving`` compares the walls of
    two routes, and several test workers share the host's cores, so
    with torch's default thread count a worker's walls swing with the
    load of the others between the two routes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(js):
    topo = None if js.topo is None else (
        np.asarray(js.topo.cell_edge), np.asarray(js.topo.edge_capacity),
        np.asarray(js.topo.cloud_servers))
    return convert.scenario(np.asarray(js.end_b), np.asarray(js.edge_b),
                            np.asarray(js.member), np.asarray(js.active),
                            np.asarray(js.t), topo, device="cpu")


def _fleet(cells, seed):
    js = jscen.init_fleet(jax.random.PRNGKey(seed),
                          jscen.FleetConfig(cells=cells, users=3,
                                            arrival_rate=None))
    return js, _carry(js)


def _synthetic(js, ps, pu, scale=1.3, offset=20.0):
    """The same served requests as a reference and a port RouteResult:
    measured = comm + scale * comp + offset, from the reference's model
    components (so a perfect fit recovers (scale, offset))."""
    comm, comp = jcal._model_components(pu, js)
    act = np.asarray(js.active)
    jserved, pserved = [], []
    for c in range(js.cells):
        for u in range(pu.shape[1]):
            if not act[c, u]:
                continue
            a = int(pu[c, u])
            tier = ("E" if a == jdyn.A_EDGE else
                    "C" if a == jdyn.A_CLOUD else "S")
            kw = dict(cell=c, user=u, action=a, tier=tier, variant="d0",
                      predicted_ms=float(comm[c, u] + comp[c, u]),
                      measured_ms=float(comm[c, u] + scale * comp[c, u]
                                        + offset))
            jserved.append(japi.ServedRequest(**kw))
            pserved.append(api.ServedRequest(**kw))
    jres = japi.RouteResult(decisions=jnp.asarray(pu),
                            ids=jnp.zeros((js.cells,), jnp.int32),
                            served=jserved, batches=1)
    pres = api.RouteResult(decisions=torch.tensor(pu),
                           ids=torch.zeros((ps.cells,), dtype=torch.int32),
                           served=pserved, batches=1)
    return jres, pres


def _assert_coefficients(got, want):
    assert set(got) == set(want) == {"S", "E", "C"}
    for tier in want:
        assert set(got[tier]) == set(want[tier])
        assert got[tier].get("requests") == want[tier].get("requests")
        for key in ("compute_scale", "hop_offset_ms", "resid_rms_ms"):
            if key in want[tier]:
                np.testing.assert_allclose(got[tier][key], want[tier][key],
                                           rtol=1e-5, atol=1e-4,
                                           err_msg=f"{tier}.{key}")


@pytest.mark.parametrize("seed", [6, 9])
def test_fit_matches_the_reference(seed):
    js, ps = _fleet(8, seed)
    pu = np.asarray(jax.random.randint(jax.random.PRNGKey(seed + 1),
                                       (8, 3), 0, 10))
    jres, pres = _synthetic(js, ps, pu)
    jfit = jcal.fit_calibration(jres, js)
    pfit = calibrate.fit_calibration(pres, ps)
    _assert_coefficients(pfit.coefficients(), jfit.coefficients())
    assert pfit.calib.compute_scale.dtype == torch.float32
    assert pfit.calib.compute_scale.device == ps.device
    assert pfit.coefficients()["S"]["compute_scale"] == pytest.approx(
        1.3, abs=1e-3)
    # the calibrated model reproduces the measurements: gap_x -> 1
    pred = dynamics.calibrated_response_times(
        torch.tensor(pu), ps.end_b, ps.edge_b, pfit.calib,
        active=ps.active).numpy()
    for r in pres.served:
        assert pred[r.cell, r.user] == pytest.approx(r.measured_ms,
                                                     rel=1e-3)
    report = calibrate.calibration_report(pfit, pres, pres)
    want = jcal.calibration_report(jfit, jres, jres)
    assert set(report) == set(want)
    for block in ("before", "after"):
        assert set(report[block]) == set(want[block])
        for k, v in want[block].items():
            if v is None:
                assert report[block][k] is None
            else:
                assert report[block][k] == pytest.approx(v, rel=1e-5)


def test_model_components_match_on_the_shared_edge_trace():
    jsrc = japi.TraceSource.load(TRACE)
    js, _ = jsrc.reset(jax.random.PRNGKey(0))
    ps, _ = api.TraceSource.load(TRACE, device="cpu").reset(None)
    assert ps.topo is not None
    pu = np.asarray(jax.random.randint(jax.random.PRNGKey(3),
                                       (ps.cells, ps.users), 0, 10))
    for got, want in zip(calibrate._model_components(torch.tensor(pu), ps),
                         jcal._model_components(pu, js)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_fit_keeps_the_identity_on_empty_tiers():
    js, ps = _fleet(4, 8)
    pu = np.zeros((4, 3), np.int32)                   # everything local
    jres, pres = _synthetic(js, ps, pu)
    coeff = calibrate.fit_calibration(pres, ps).coefficients()
    _assert_coefficients(coeff, jcal.fit_calibration(jres, js)
                         .coefficients())
    for tier in ("E", "C"):
        assert coeff[tier] == {"compute_scale": 1.0, "hop_offset_ms": 0.0,
                               "requests": 0}


def test_calibrated_dynamics_stamps_and_trains_both_agents():
    cfg = scenarios.FleetConfig(cells=8, users=3, arrival_rate=None)
    calib = dynamics.Calibration(torch.tensor([1.2, 1.1, 0.9]),
                                 torch.tensor([5.0, 2.0, -1.0]))
    src = CalibratedDynamics(api.SyntheticSource(cfg), calib)
    assert src.cells == 8 and src.users == 3 and not src.dynamic
    scen, state = src.reset(Draws(0, "cpu"))
    assert scen.calib is calib and state.calib is calib
    scen2, _ = src.step(Draws(1, "cpu"), state)
    assert scen2.calib is calib
    tab = population.FleetQLearning(src, seed=0, device="cpu")
    tab.run(8)
    assert tab.scen.calib is calib
    assert tab.metrics_summary()["reward"]["count"] == 8 * 8
    dqn = policy.FleetDQN(src, cfg=policy.FleetDQNConfig(hidden=16,
                                                         batch_size=16),
                          seed=0, device="cpu")
    dqn.run(4)
    assert dqn.scen.calib is calib
    # the stamp moves the model the agents train on
    pu = torch.full((8, 3), 2, dtype=torch.int32)
    base, _ = population.nominal_expected_response(
        calibrate.apply_calibration(scen, None), pu)
    cal, _ = population.nominal_expected_response(scen, pu)
    assert not torch.equal(base, cal)
    assert calibrate.apply_calibration(scen, None).calib is None


def test_calibrated_dynamics_requires_scenario_state():
    class _Bad:
        state_is_scenario = False
        cells, users, dynamic = 4, 3, False
    with pytest.raises(TypeError):
        CalibratedDynamics(_Bad(), dynamics.Calibration.identity())


class SpreadPolicy:
    """Users round-robin over (local d0, edge, cloud)."""

    def decisions(self, counts, scen):
        idx = torch.arange(scen.cells)[:, None] * scen.users \
            + torch.arange(scen.users)[None, :]
        acts = torch.tensor([0, dynamics.A_EDGE, dynamics.A_CLOUD],
                            dtype=torch.int32)
        return acts[idx % 3], torch.zeros((scen.cells,), dtype=torch.int32)


def test_calibrate_serving_on_cpu_engines():
    engines = build_engines(get_config("edge-ladder"), variants=("d0",),
                            max_len=48, device="cpu")
    _, ps = _fleet(6, 0)
    orch = api.FleetOrchestrator(SpreadPolicy())
    retrained = []

    def retrain(calib):
        retrained.append(calib)
        return {"holdout_reward_ratio": 1.0}
    kw = dict(max_new_tokens=2, batch_size=4, prompt_len=8)
    orch.route(scen=ps, dispatch=engines, **kw)              # warm-up
    report, fit, after = calibrate.calibrate_serving(
        orch, ps, engines, route_kw=kw, retrain=retrain)
    assert set(report) == {"coefficients", "before", "after", "retrained"}
    assert retrained[0] is fit.calib and after.served
    for tier in ("S", "E", "C"):
        c = report["coefficients"][tier]
        assert c["requests"] == 6 and c["compute_scale"] >= 0.0
        assert np.isfinite(c["hop_offset_ms"])
    before_gap = report["before"]["gap_x"]
    after_gap = report["after"]["gap_x"]
    assert abs(np.log(after_gap)) < abs(np.log(before_gap))
    assert after.lat_acc is not None
