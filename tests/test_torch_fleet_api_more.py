"""The rest of the port's fleet API against the JAX package, on the CPU:
``api.record_trace`` (the public round-trip tool), the
``make_fleet_env_step`` forwarder and its ``TypeError``, the legacy
aliases (``FleetOrchestrator.agent``, ``policy_decisions``) and the
package's ``__all__``.

Every recorded field must be equal (integers and the float timestamps
alike: both sides stamp arrivals mid-bin from the same frames).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as rfleet
import repro_torch.fleet as pfleet
from repro.fleet import api as japi
from repro.fleet import population as jpop
from repro_torch import convert
from repro_torch.fleet import api, policy, population, scenarios
from repro_torch.rng import Draws

TRACE = os.path.join(os.path.dirname(__file__), "data", "trace_small.npz")
FIELDS = ("end_b", "edge_b", "arrival_time", "arrival_cell",
          "arrival_user", "member", "cell_edge", "edge_capacity")


def _assert_same_trace(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
    assert got.step_duration == want.step_duration
    assert got.cloud_servers == want.cloud_servers


@pytest.mark.parametrize("steps", [5, 12, 17])
def test_record_trace_of_trace_small_equals_the_reference(steps):
    """Both packages record the same ``TraceSource`` (past its wrap at 17
    steps); every field equals."""
    want = japi.record_trace(japi.TraceSource.load(TRACE),
                             jax.random.PRNGKey(0), steps)
    got = api.record_trace(api.TraceSource.load(TRACE, device="cpu"),
                           Draws(0, "cpu"), steps)
    _assert_same_trace(got, want)


def test_a_recorded_trace_replays_its_source_frame_for_frame(tmp_path):
    """``TraceSource(record_trace(src, ...))`` replays the exact frames of
    a synthetic coupled fleet, also through ``save_trace`` /
    ``load_trace`` and the reference's loader."""
    cfg = scenarios.FleetConfig(cells=12, users=3, arrival_rate=0.8,
                                p_r2w=0.1, p_w2r=0.2, min_users=1,
                                max_users=3, n_edges=4, assignment="hot",
                                cloud_servers=20.0)
    src = api.SyntheticSource(cfg)
    trace = api.record_trace(src, Draws(3, "cpu"), 8, step_duration=0.25)
    frames = []
    draws = Draws(3, "cpu")
    scen, state = src.reset(draws)
    for _ in range(8):
        frames.append(scen)
        scen, state = src.step(draws, state)
    api.save_trace(tmp_path / "t.npz", trace)
    for replay in (api.TraceSource(trace, device="cpu"),
                   api.TraceSource.load(tmp_path / "t.npz", device="cpu")):
        got, _ = replay.reset(None)
        for want in frames:
            for f in ("end_b", "edge_b", "member", "active"):
                assert torch.equal(getattr(got, f).to(torch.int32),
                                   getattr(want, f).to(torch.int32)), f
            assert torch.equal(got.topo.cell_edge, want.topo.cell_edge)
            assert got.topo.cloud_servers == want.topo.cloud_servers
            got, _ = replay.step(None, got)
    _assert_same_trace(japi.load_trace(tmp_path / "t.npz"), trace)


def test_record_trace_without_a_topology_records_no_deployment_map():
    src = api.SyntheticSource(scenarios.FleetConfig(cells=4, users=2))
    trace = api.record_trace(src, Draws(0, "cpu"), 3)
    assert trace.cell_edge is None and trace.edge_capacity is None
    assert trace.cloud_servers == float("inf")
    assert trace.topology() is None


def test_make_fleet_env_step_refuses_a_bare_config_as_the_reference():
    cfg = scenarios.FleetConfig(cells=4, users=2)
    with pytest.raises(TypeError, match="SyntheticSource"):
        population.make_fleet_env_step(cfg)
    with pytest.raises(TypeError, match="SyntheticSource"):
        jpop.make_fleet_env_step(rfleet.FleetConfig(cells=4, users=2))


def test_make_fleet_env_step_forwards_to_make_env_step():
    """Same source, same draws: the forwarder's step equals
    ``api.make_env_step``'s field for field."""
    src = api.TraceSource.load(TRACE, device="cpu")
    scen, _ = src.reset(None)
    a = torch.tensor(np.random.default_rng(0).integers(0, 10, (6, 3)))
    outs = [fn(Draws(1, "cpu"), scen, a) for fn in (
        population.make_fleet_env_step(src, threshold=85.0),
        api.make_env_step(src, threshold=85.0))]
    for x, y in zip(outs[0][1:], outs[1][1:]):
        assert torch.equal(x, y)
    assert outs[0][0].t == outs[1][0].t == 1


def test_the_legacy_aliases_route_as_the_new_names():
    scen = scenarios.table5_fleet("EXP-B", 6, 3, device="cpu")
    oracle = api.OraclePolicy(3, threshold=85.0)
    orch = api.FleetOrchestrator(oracle)
    assert orch.agent is oracle
    for x, y in zip(oracle.policy_decisions(None, scen),
                    oracle.decisions(None, scen)):
        assert torch.equal(x, y)
    agent = policy.FleetDQN(scen, scenarios.FleetConfig(cells=6, users=3),
                            cfg=policy.FleetDQNConfig(hidden=16),
                            device="cpu")
    counts = torch.zeros((6, 2), dtype=torch.int32)
    for x, y in zip(agent.policy_decisions(counts, scen),
                    agent.decisions(counts, scen)):
        assert torch.equal(x, y)


def test_fleet_exports_the_references_names_but_the_mesh_seams():
    """The name dates from before the fleet sharding was ported, when the
    mesh seams were left out. The port now exports every name of the
    reference's ``__all__``, the mesh seams included, in its order."""
    assert pfleet.__all__ == rfleet.__all__
    for name in pfleet.__all__:
        assert getattr(pfleet, name) is not None, name
    assert pfleet.fleet_mesh is pfleet.shard.fleet_mesh
    with pytest.raises(AttributeError):
        pfleet.no_such_name


def test_a_trace_recorded_by_the_reference_routes_identically():
    """A coupled trace recorded by the reference, replayed by both: the
    oracle's decisions on its first frame equal."""
    want_trace = japi.record_trace(japi.TraceSource.load(TRACE),
                                   jax.random.PRNGKey(0), 4)
    js, _ = japi.TraceSource(want_trace).reset(jax.random.PRNGKey(0))
    ps = convert.scenario(
        np.asarray(js.end_b), np.asarray(js.edge_b), np.asarray(js.member),
        np.asarray(js.active), 0, (np.asarray(js.topo.cell_edge),
                                   np.asarray(js.topo.edge_capacity),
                                   np.asarray(js.topo.cloud_servers)),
        device="cpu")
    jdec, _ = japi.OraclePolicy(3, threshold=85.0).decisions(None, js)
    dec, _ = api.OraclePolicy(3, threshold=85.0).decisions(None, ps)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    assert jnp.asarray(jdec).shape == (6, 3)
