"""``repro_torch.obs.prof`` on the CPU: the cases of ``tests/test_prof.py``
that apply to a traced (not compiled) cost count — the matmul count,
the dict and its derived terms, determinism, the peak rows and their
fallback, nothing executing — the stage breakdown of both agents (and
the cell-form DQN), the agent left as it was, the scaling sweep's
schema and classifier, and each hand kernel's ``cost`` against the
bound arithmetic ``PERF.md`` §6 reports at one of its shapes.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.fleet import api, policy, population, scenarios
from repro_torch.kernels import (_build, best_response, decode_attention,
                                 dqn_head, flash_attention, int8_matmul, ops,
                                 selective_scan, tabular_rl)
from repro_torch.obs import SpanRecorder
from repro_torch.obs.prof import (PEAKS, backend_peaks,
                                  profile_fn, scaling_sweep, stage_costs)

HBM, FP32, BF16, INT8 = 3.35e12, 67e12, 989e12, 1979e12


# ------------------------------------------------------- CostProfile -----
def _matmul_profile(m=64, k=128, n=32):
    a = torch.ones((m, k))
    b = torch.ones((k, n))
    return profile_fn(torch.matmul, a, b, name="mm"), 2 * m * k * n


def test_costprofile_matmul_flops_are_the_analytic_count():
    prof, analytic = _matmul_profile()
    assert prof.name == "mm"
    assert prof.flops == analytic
    assert prof.bytes_accessed == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert prof.arg_bytes == 4 * (64 * 128 + 128 * 32)
    assert prof.out_bytes == 4 * 64 * 32
    assert prof.arithmetic_intensity == pytest.approx(
        prof.flops / prof.bytes_accessed)
    assert prof.dominant in ("compute", "memory")


def test_costprofile_dict_is_jsonable_and_derived():
    prof, _ = _matmul_profile()
    d = prof.as_dict()
    json.dumps(d)
    for key in ("flops", "bytes_accessed", "arithmetic_intensity",
                "ridge_intensity", "compute_s", "memory_s", "dominant",
                "backend", "temp_bytes"):
        assert key in d
    assert d["backend"] == "cpu"
    assert d["ridge_intensity"] == pytest.approx(
        prof.peak_flops_per_s / prof.peak_bytes_per_s)
    expect = "compute" if d["compute_s"] >= d["memory_s"] else "memory"
    assert d["dominant"] == expect


def test_costprofile_is_deterministic():
    p1, _ = _matmul_profile()
    p2, _ = _matmul_profile()
    assert p1.as_dict() == p2.as_dict()


def test_temp_bytes_count_the_intermediates():
    x = torch.ones(1000)
    prof = profile_fn(lambda x: (x * 2.0 + 1.0).sum(), x)
    assert prof.flops == 1000 + 1000 + 1
    assert prof.out_bytes == 4
    assert prof.temp_bytes == 2 * 4000


def test_backend_peaks_known_rows_and_fallback(monkeypatch):
    assert backend_peaks("cuda").flops_per_s == pytest.approx(989e12)
    assert backend_peaks("cuda").bytes_per_s == pytest.approx(3.35e12)
    assert backend_peaks("no_such_backend") == PEAKS["cpu"]
    assert set(PEAKS) == {"cuda", "cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert backend_peaks() == PEAKS["cpu"]


def test_profile_fn_never_executes():
    calls = []
    x = torch.ones(4)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()

    def f(x):
        calls.append(1)          # traced once, never executed again
        x.add_(1.0)              # on a fake copy
        return x * 2.0 + torch.rand(4, generator=gen)

    before = {k.name: k.launches for k in (tabular_rl.KERNEL,
                                           dqn_head.KERNEL)}
    profile_fn(f, x)
    assert len(calls) == 1
    assert torch.equal(x, torch.ones(4))
    assert torch.equal(gen.get_state(), state)
    assert before == {k.name: k.launches for k in (tabular_rl.KERNEL,
                                                   dqn_head.KERNEL)}


def test_a_host_read_inside_a_step_cannot_be_traced():
    with pytest.raises(Exception):
        profile_fn(lambda x: float(x.sum()), torch.ones(3))


# ----------------------------------------------------- kernel costs -----
def test_a_fake_op_records_its_kernels_cost_and_launches_nothing():
    cells, n_states, k = 8, 9, 27
    q = torch.zeros((cells, n_states, k))
    i = torch.zeros(cells, dtype=torch.int32)
    r = torch.zeros(cells)
    prof = profile_fn(lambda q, s, a, r, s2: ops.fused_tabular_update(
        q, s, a, r, s2, alpha=0.9, gamma=0.1), q, i, i, r, i)
    ops_, nbytes = tabular_rl.cost(cells, n_states, k)
    assert (prof.flops, prof.bytes_accessed) == (ops_, nbytes)
    assert _build.COST_SINKS == []


def test_each_kernels_cost_is_the_bound_arithmetic_of_perf_md():
    """One shape each, the bound ``PERF.md`` §6 gives there (ms, by the
    larger of bytes at 3.35 TB/s and operations at the type's peak)."""
    def bound_ms(cost, peak):
        ops_, nbytes = cost
        return max(nbytes / HBM, ops_ / peak) * 1e3
    # K1 at 32,768 x 36 x 243: 0.00982 (bytes)
    assert bound_ms(tabular_rl.cost(32768, 36, 243), FP32) == \
        pytest.approx(0.00982, rel=1e-3)
    # K2 at 32,768 x 5, hidden 128, top-5, goal 85: 0.1086 (operations)
    assert bound_ms(dqn_head.cost(32768, 5, 8, 128, 10, 85.0, 5), FP32) == \
        pytest.approx(0.1086, rel=1e-3)
    # goal 0: 0.0933
    assert bound_ms(dqn_head.cost(32768, 5, 8, 128, 10, 0.0, 5), FP32) == \
        pytest.approx(0.0933, rel=1e-3)
    # K3 at the edge ladder's 64 x 256, 8/4 heads of 32, bf16: 0.00751
    assert bound_ms(flash_attention.cost(64, 256, 256, 8, 4, 32, 2),
                    BF16) == pytest.approx(0.00751, rel=1e-3)
    # K4 at 64 x 512 slots: 0.00507
    assert bound_ms(decode_attention.cost(64, 8, 4, 32, 512, 2), BF16) == \
        pytest.approx(0.00507, rel=1e-3)
    # K5 at 16,384 x 256 x 1,024, bf16 out: 0.01137
    assert bound_ms(int8_matmul.cost(16384, 256, 1024, 2), INT8) == \
        pytest.approx(0.01137, rel=1e-3)
    # K6 at Falcon's 64 x 256 x 8,192 x 16, bf16 u: 0.3313
    assert bound_ms(selective_scan.cost(64, 256, 8192, 16, 2), FP32) == \
        pytest.approx(0.3313, rel=1e-3)


def test_flash_attention_cost_counts_the_pairs_the_mask_keeps():
    ops_c, _ = flash_attention.cost(1, 4, 6, 1, 1, 8, 4, causal=True)
    assert ops_c == 4 * 8 * (3 + 4 + 5 + 6)          # q right-aligned
    ops_w, _ = flash_attention.cost(1, 4, 6, 1, 1, 8, 4, causal=True,
                                    window=2)
    assert ops_w == 4 * 8 * 4 * 2
    ops_f, _ = flash_attention.cost(1, 4, 6, 1, 1, 8, 4, causal=False)
    assert ops_f == 4 * 8 * 4 * 6


def test_best_response_cost_counts_the_tables_once():
    ops_, nbytes = best_response.cost(cells=64, k=100, users=2, n_edges=4)
    assert ops_ == 64 * 100 * (10 + 24)
    assert nbytes == 64 * 100 * 9 + 400 + 64 * 26 + 32


# -------------------------------------------------------- stage_costs ----
def _source(cells=8, users=2):
    return api.SyntheticSource(scenarios.FleetConfig(
        cells=cells, users=users, arrival_rate=1.0))


def _dqn(net="shared"):
    agent = policy.FleetDQN(_source(), cfg=policy.FleetDQNConfig(
        replay_capacity=256, batch_size=16, hidden=16, net=net,
        accuracy_threshold=85.0), device="cpu")
    agent.run(2)
    return agent


def _fractions_ok(rep):
    for fr in ("flop_fracs", "byte_fracs", "wall_fracs"):
        assert sum(rep[fr].values()) == pytest.approx(1.0)
        assert all(v >= 0 for v in rep[fr].values())
    assert rep["dominant_stage_flops"] in rep["stages"]
    assert rep["dominant_stage_wall"] in rep["stages"]
    json.dumps(rep)


def _state(agent):
    """Every tensor of the agent's state, and its host-side scalars."""
    leaves = [agent.counts, *[getattr(agent.scen, f) for f in (
        "end_b", "edge_b", "member", "active")],
        agent.draws.gen.get_state()]
    if hasattr(agent, "buffer"):
        leaves += [t for p in agent.params for t in p.values()]
        leaves += [t for part in ("m", "v") for p in agent.opt[part]
                   for t in p.values()]
        b = agent.buffer
        leaves += [b.s, b.a, b.r, b.s2]
        host = (agent.opt["step"], b.ptr, b.full, agent.eps, agent.steps)
    else:
        leaves.append(agent.q)
        host = (agent.eps, agent.steps)
    return [t.detach().clone() for t in leaves], host


def _unchanged(agent, snap):
    leaves, host = _state(agent)
    assert host == snap[1]
    assert all(torch.equal(a, b) for a, b in zip(leaves, snap[0]))


def test_stage_costs_dqn_stages_and_fractions():
    spans = SpanRecorder()
    agent = _dqn()
    snap = _state(agent)
    rep = stage_costs(agent, reps=2, spans=spans)
    assert rep["kind"] == "dqn" and rep["backend"] == "cpu"
    assert set(rep["stages"]) == {"fused_encode_act", "env_step",
                                  "replay", "update"}
    _fractions_ok(rep)
    assert len(spans.durations_ms("prof.stage.update")) == 2
    _unchanged(agent, snap)


def test_stage_costs_of_the_cell_net_name_the_unfused_act():
    agent = _dqn("cell")
    snap = _state(agent)
    rep = stage_costs(agent, reps=1)
    assert set(rep["stages"]) == {"encode_act", "env_step", "replay",
                                  "update"}
    _fractions_ok(rep)
    _unchanged(agent, snap)


def test_stage_costs_tabular_stages_and_fractions():
    agent = population.FleetQLearning(_source(), device="cpu")
    agent.run(3)
    snap = _state(agent)
    rep = stage_costs(agent, reps=2)
    assert rep["kind"] == "tabular"
    assert set(rep["stages"]) == {"encode_act", "env_step",
                                  "fused_update_act"}
    assert rep["cells"] == 8 and rep["users"] == 2
    # the fused stage's cost is K1's own
    k1 = tabular_rl.cost(8, agent.n_states, agent.n_actions)
    assert rep["stages"]["fused_update_act"]["flops"] == k1[0]
    _fractions_ok(rep)
    _unchanged(agent, snap)


def test_stage_flop_fractions_are_deterministic():
    agent = _dqn()
    r1 = stage_costs(agent, reps=1)
    r2 = stage_costs(agent, reps=1)
    assert r1["flop_fracs"] == r2["flop_fracs"]
    assert r1["byte_fracs"] == r2["byte_fracs"]


# ------------------------------------------------------ scaling_sweep ----
def test_scaling_sweep_schema_and_classification():
    rep = scaling_sweep([8, 16], users=2, steps=20, chunk=5, device="cpu")
    assert rep["grid"] == [8, 16]
    assert rep["devices"] == 1 and rep["sharded"] is False
    assert rep["backend"] == "cpu"
    for key in ("flops_per_cell", "us_device_per_cell_step",
                "per_device_cell_steps_per_s"):
        assert set(rep[key]) == {"8", "16"}
        assert all(v > 0 for v in rep[key].values())
    assert 0 < rep["flatness"] <= 1.0
    assert rep["classification"] in ("flat", "runtime", "algorithmic")
    json.dumps(rep)
    # the env step's work is linear in cells: flops per cell within 15%
    f = rep["flops_per_cell"]
    assert f["16"] <= 1.15 * f["8"]


def test_scaling_sweep_on_a_mesh_waits_for_fleet_sharding():
    with pytest.raises(NotImplementedError, match="sharding"):
        scaling_sweep([8], mesh=object(), device="cpu")


@pytest.mark.parametrize("flops16,want", [(100.0, "runtime"),
                                           (130.0, "algorithmic")])
def test_the_classifier_names_the_cliffs_kind(flops16, want):
    """Time per cell-step doubling at 16 cells: flat flops per cell ->
    runtime overhead, flops per cell grown past ``flop_tol`` ->
    algorithmic growth; a flat series -> flat."""
    from repro_torch.obs.prof import _classify
    grid = [8, 16]
    rep = _classify(grid, {8: 100.0, 16: flops16}, {8: 1.0, 16: 2.0},
                    {8: 1e6, 16: 5e5}, 0.5, 0.15)
    assert rep["cliff_cells"] == 16 and rep["classification"] == want
    assert rep["summary"].startswith("cliff at 16 cells")
    assert rep["flatness"] == 0.5
    flat = _classify(grid, {8: 100.0, 16: 100.0}, {8: 1.0, 16: 1.2},
                     {8: 1e6, 16: 9e5}, 0.5, 0.15)
    assert flat["cliff_cells"] is None and flat["classification"] == "flat"
    assert flat["summary"].startswith("flat:")
