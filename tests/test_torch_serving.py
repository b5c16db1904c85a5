"""The port's serving half (``repro_torch.serving``, ``launch.serve``,
``fleet.api`` dispatch) against the JAX package, on the CPU.

* ``RequestBatcher`` forms the same padded batches as the reference.
* ``ServingEngine.generate`` yields the reference engine's greedy tokens
  on the reference's weights (carried across with
  ``convert.model_params``), where the top-2 logit margin is clear.
* ``FleetOrchestrator.route(dispatch=build_engines(..., device="cpu"))``
  routes the same decisions as the reference's orchestrator, serves the
  same (cell, user) set on the same (tier, variant) engines with the
  same predicted latencies (relative 1e-5: float32 latency model summed
  in another order), and holds the identities of
  ``tests/test_fleet_api.py``: every active user served once, queue +
  measured == e2e, batching + compute + dispatch == wall, attained +
  violated == dispatched. The reference side routes into engines that
  keep its ``serve`` contract without running a model, since only the
  routing is compared there.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.fleet import api as japi
from repro.fleet import scenarios as jscen
from repro.models import build_model as jbuild_model
from repro.models.variants import build_ladder as jbuild_ladder
from repro.serving import ServingEngine as JServingEngine
from repro.serving.batching import Request as JRequest
from repro.serving.batching import RequestBatcher as JRequestBatcher
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.fleet import api
from repro_torch.launch.serve import build_engines
from repro_torch.models import build_model
from repro_torch.models.variants import build_ladder
from repro_torch.serving import Request, RequestBatcher, ServingEngine

TRACE = os.path.join(os.path.dirname(__file__), "data", "trace_small.npz")


# ------------------------------------------------------------ batching ----
def test_request_batcher_buckets_and_splits_like_the_reference():
    rng = np.random.default_rng(0)
    lens = [5, 32, 33, 70, 300, 1, 129, 64, 2]
    prompts = [rng.integers(1, 100, n).astype(np.int32) for n in lens]
    got, want = RequestBatcher(4), JRequestBatcher(4)
    for i, p in enumerate(prompts):
        got.submit(Request(i, p))
        want.submit(JRequest(i, p))
    while True:
        g, w = got.next_batch(), want.next_batch()
        assert [r.rid for r in g[0]] == [r.rid for r in w[0]]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        if not g[0]:
            assert g[1].shape == (0, 32)
            break
    reqs = [Request(i, p) for i, p in enumerate(prompts)]
    jreqs = [JRequest(i, p) for i, p in enumerate(prompts)]
    packed, jpacked = RequestBatcher(4).pack(reqs), \
        JRequestBatcher(4).pack(jreqs)
    assert [b[1].shape for b in packed] == [(4, 128), (4, 256), (1, 32)]
    for (gr, gt, gl), (wr, wt, wl) in zip(packed, jpacked):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


# -------------------------------------------------------------- engine ----
def _host(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


@pytest.mark.parametrize("vid", ["d4", "d7"])
def test_engine_generates_the_reference_tokens(vid):
    jcfg = jbuild_ladder(jget_config("edge-ladder"))[vid].cfg
    cfg = build_ladder(get_config("edge-ladder"))[vid].cfg
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    m = build_model(cfg)
    p = convert.model_params(_host(jp), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (3, 16)).astype(np.int32)
    want, _ = JServingEngine(jm, jp, max_len=24).generate(toks, 5)
    eng = ServingEngine(m, p, max_len=24, compute_scale=2.0)
    got, wall = eng.generate(toks, 5)
    assert got.shape == (3, 5) and got.dtype == np.int32 and wall > 0
    # margins: the reference's top-2 gap at the first generated token
    jlog, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    top2 = np.sort(np.asarray(jlog[:, -1, :cfg.vocab_size], np.float32),
                   -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 0.25
    assert clear.any()
    np.testing.assert_array_equal(got[clear], np.asarray(want)[clear])


# ------------------------------------------------------------- routing ----
class _RoutingOnlyEngine:
    """The reference engine's ``serve`` contract without a model: drain
    one batch and stamp it as served in 1 ms."""

    def __init__(self, vocab):
        self.model = types.SimpleNamespace(
            cfg=types.SimpleNamespace(vocab_size=vocab))

    def serve(self, batcher, spans=None):
        reqs, toks, _ = batcher.next_batch()
        for r in reqs:
            r.output = toks[0, :1]
            r.response_time = r.serve_time = 1e-3
            r.queue_time = 0.0
            r.deadline_met = r.response_time * 1e3 <= r.deadline_ms
        return reqs


def _reference_engines(engines):
    return {t: {v: _RoutingOnlyEngine(8192) for v in tier}
            for t, tier in engines.items()}


@pytest.fixture(scope="module")
def engines():
    """The port's three-tier engine set (d0, d4, d7) on the CPU."""
    return build_engines(get_config("edge-ladder"), max_len=16,
                         device="cpu")


def _check_route(res, jres, scen):
    np.testing.assert_array_equal(res.decisions.cpu().numpy(),
                                  np.asarray(jres.decisions))
    np.testing.assert_array_equal(res.ids.cpu().numpy(),
                                  np.asarray(jres.ids))
    active = scen.active.cpu().numpy()
    n_active = int(active.sum())
    keys = [(r.cell, r.user) for r in res.served]
    assert len(keys) == len(set(keys)) == n_active
    assert set(keys) == set(zip(*map(lambda a: a.tolist(),
                                     np.nonzero(active))))
    assert [(r.cell, r.user, r.action, r.tier, r.variant)
            for r in res.served] == \
        [(r.cell, r.user, r.action, r.tier, r.variant) for r in jres.served]
    np.testing.assert_allclose(res.predicted_ms, jres.predicted_ms,
                               rtol=1e-5)
    assert res.batches == jres.batches
    per, jper = res.timings["per_tier_variant"], \
        jres.timings["per_tier_variant"]
    assert {k: (v["requests"], v["batches"]) for k, v in per.items()} == \
        {k: (v["requests"], v["batches"]) for k, v in jper.items()}
    for r in res.served:
        assert r.measured_ms > 0 and np.isfinite(r.predicted_ms)
        assert r.queue_ms + r.measured_ms == pytest.approx(r.e2e_ms)
    t = res.timings
    assert t["batching_ms"] + t["compute_ms"] + t["dispatch_ms"] == \
        pytest.approx(t["wall_ms"])
    assert t["dispatch_ms"] >= 0
    slo = res.slo()
    assert slo["measured"]["attained"] + slo["measured"]["violated"] == \
        slo["requests"] == n_active
    for tv in slo["per_tier_variant"].values():
        assert tv["measured_attained"] + tv["measured_violated"] == \
            tv["dispatched"]
    s = res.summary()
    assert s["requests"] == n_active and np.isfinite(s["gap_x"])
    assert s["gap_breakdown"]["wall_ms"]["total"] == t["wall_ms"]


@pytest.mark.parametrize("strategy", ["edge", "cloud", 3])
def test_route_dispatch_on_the_trace_matches_reference(engines, strategy):
    """The recorded trace (a deployment map, so the topology latency
    model) under the paper's fixed strategies."""
    trace = japi.load_trace(TRACE)
    jscn, _ = japi.TraceSource(trace).reset(jax.random.PRNGKey(0))
    scn, _ = api.TraceSource(api.load_trace(TRACE), device="cpu").reset(None)
    kw = dict(max_new_tokens=2, batch_size=4, prompt_len=8, seed=3)
    jres = japi.FleetOrchestrator(
        japi.StaticPolicy(trace.users, strategy)).route(
        scen=jscn, dispatch=_reference_engines(engines), **kw)
    res = api.FleetOrchestrator(api.StaticPolicy(trace.users, strategy)) \
        .route(scen=scn, dispatch=engines, with_edge_util=True, **kw)
    _check_route(res, jres, scn)
    assert res.hot_edges is not None


def _three_user_fleet(seed=5, cells=12):
    js = jscen.mixed_table5_fleet(jax.random.PRNGKey(seed), cells, 3,
                                  min_users=1, max_users=3)
    return js, convert.scenario(np.asarray(js.end_b), np.asarray(js.edge_b),
                                np.asarray(js.member), np.asarray(js.active),
                                np.asarray(js.t), device="cpu")


@pytest.mark.parametrize("policy,arg", [("oracle", 0.0), ("oracle", 85.0),
                                        ("static", 4), ("static", 7)])
def test_route_dispatch_on_a_three_user_fleet_matches_reference(
        engines, policy, arg):
    """A 3-user mixed Table-5 fleet over the full 10^3 joint space: the
    oracle at goals 0 and 85 (local decisions snap to d0/d4/d7) and
    fixed local d4 / d7."""
    js, scn = _three_user_fleet()
    if policy == "oracle":
        jpol, pol = japi.OraclePolicy(3, threshold=arg), \
            api.OraclePolicy(3, threshold=arg)
    else:
        jpol, pol = japi.StaticPolicy(3, arg), api.StaticPolicy(3, arg)
    kw = dict(max_new_tokens=2, batch_size=8, prompt_len=12, seed=0)
    jres = japi.FleetOrchestrator(jpol).route(
        scen=js, dispatch=_reference_engines(engines), **kw)
    res = api.FleetOrchestrator(pol).route(scen=scn, dispatch=engines, **kw)
    _check_route(res, jres, scn)
    if policy == "static":
        assert {r.variant for r in res.served} == {f"d{arg}"}
    ms, acc = pol.expected(scn)
    jms, jacc = jpol.expected(js)
    np.testing.assert_allclose(ms, jms, rtol=1e-5)
    np.testing.assert_allclose(acc, jacc, rtol=1e-6)


def test_route_without_dispatch_keeps_its_contract(engines):
    js, scn = _three_user_fleet(seed=6)
    orch = api.FleetOrchestrator(api.OraclePolicy(3))
    dec, ids = orch.route(scen=scn)
    res = orch.route(scen=scn, as_result=True)
    assert torch.equal(res.decisions, dec) and res.served == [] \
        and res.batches == 0 and res.slo() is None \
        and res.gap_breakdown() is None
    with pytest.raises(KeyError, match="no engine for tier 'E'"):
        api.FleetOrchestrator(api.StaticPolicy(3, "edge")).route(
            scen=scn, dispatch={"S": engines["S"]})
    with pytest.raises(KeyError, match="no device-tier"):
        api.FleetOrchestrator(api.StaticPolicy(3, 5)).route(
            scen=scn, dispatch={"E": engines["E"]})
    with pytest.raises(ValueError, match="non-empty"):
        orch.route(scen=scn, dispatch={})
