"""The port's async serving bridge (``repro_torch.serving.bridge``) and
``route(bridge=...)``, on the CPU.

* The eight cases of ``tests/test_bridge.py`` on a copy of its stub
  engine, with the same conservation asserts: overload sheds, deadline
  admission, an unknown tier, a timed-out tier rerouted once or shed,
  the drain timeout, oversize batches, and a bridge reused across
  routes.
* The reference's bridge (``repro.serving.bridge``) and the port's on
  the same stubs and the same submits, in every case whose outcome does
  not depend on timing: deadline admission, an unknown tier, an engine
  that hangs or raises (rerouted once, or shed with no fallback, or
  rerouted and shed) and the drain flush. ``stats()`` equal (counters,
  shed reasons and rids) and the same reroute, shed and timeout
  instants; the port also keeps each engine exception's cause, and an
  exception from an engine on the card fails the drain.
* ``route(bridge=..., spans=...)`` on CPU edge-ladder engines (d0,
  cache 48), as ``tests/test_fleet_api.py`` does for the reference: the
  same request set as the synchronous route, every identity exact, the
  spans a valid Chrome trace whose ``request.e2e`` durations reproduce
  the served e2e, and the histogram quantiles within one bin of the
  exact ones.
* The kernels' lazy build and launch count under many threads.

Every bridge here has ``drain_timeout_s <= 5`` and is stopped on the
way out, so no test can hang the suite.
"""
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.obs import spans as jspans
from repro.serving import batching as jbatching
from repro.serving import bridge as jbridge
from repro_torch.configs.base import get_config
from repro_torch.fleet import api, population
from repro_torch.launch.serve import build_engines
from repro_torch.obs import SpanRecorder, validate_chrome_trace
from repro_torch.serving import BridgeConfig, Request, ServingBridge
from repro_torch.serving import batching as batching_mod
from repro_torch.serving import bridge as bridge_mod

TRACE = os.path.join(os.path.dirname(__file__), "data", "trace_small.npz")
DRAIN_S = 5.0


class StubEngine:
    """serve_batch-compatible stand-in: stamps the same fields as
    ``ServingEngine.serve_batch`` without a model. ``wall_s`` holds the
    engine busy so queues back up deterministically."""

    def __init__(self, wall_s: float = 0.0):
        self.wall_s = wall_s
        self.calls = 0

    def serve_batch(self, reqs, toks, spans=None, t_drain=None):
        self.calls += 1
        if self.wall_s:
            time.sleep(self.wall_s)
        t_drain = time.perf_counter() if t_drain is None else t_drain
        raw = max(self.wall_s, 1e-4)
        for i, r in enumerate(reqs):
            r.output = np.asarray(toks[i][:1])
            r.response_time = raw
            r.queue_time = max(0.0, t_drain - r.arrival_time)
            r.serve_time = raw
            r.deadline_met = \
                (r.queue_time + r.response_time) * 1e3 <= r.deadline_ms
        return reqs


class RaisingEngine(StubEngine):
    """An engine whose every call raises, as a kernel fault would."""

    def serve_batch(self, reqs, toks, spans=None, t_drain=None):
        self.calls += 1
        raise RuntimeError("CUDA error: an illegal memory access")


class GatedEngine(StubEngine):
    """An engine that holds every call until ``gate`` is set."""

    def __init__(self, gate):
        super().__init__()
        self.gate = gate

    def serve_batch(self, reqs, toks, spans=None, t_drain=None):
        self.gate.wait(DRAIN_S)
        return super().serve_batch(reqs, toks, spans, t_drain)


def _req(rid, request=Request, **kw):
    return request(rid=rid, prompt=np.arange(4, dtype=np.int32),
                   max_new_tokens=1, **kw)


def _cfg(**kw):
    kw.setdefault("drain_timeout_s", DRAIN_S)
    return BridgeConfig(**kw)


def _assert_conserved(st):
    assert st["submitted"] == st["admitted"] + st["shed"]["overflow"] \
        + st["shed"]["deadline"]
    assert st["served"] + st["shed"]["total"] == st["submitted"]
    assert len(st["shed_requests"]) == st["shed"]["total"]


def test_bridge_overload_sheds_and_conserves():
    eng = StubEngine(wall_s=0.05)
    cfg = _cfg(max_batch=2, max_wait_ms=0.0, max_queue=4)
    with ServingBridge({"S": {"d0": eng}}, cfg) as br:
        for i in range(40):
            br.submit(_req(i), "S", "d0")
        assert br.drain()
        st = br.stats()
    assert st["submitted"] == 40
    assert st["shed"]["overflow"] > 0
    assert st["served"] == st["admitted"]
    _assert_conserved(st)
    assert all(s["reason"] == "overflow" for s in st["shed_requests"])
    assert eng.calls >= st["served"] / cfg.max_batch


def test_bridge_deadline_admission():
    with ServingBridge({"S": {"d0": StubEngine()}}, _cfg()) as br:
        late = _req(0, deadline_ms=5.0,
                    arrival_time=time.perf_counter() - 1.0)  # 1000 ms ago
        assert br.submit(late, "S", "d0") is False
        assert br.submit(_req(1, deadline_ms=1e6), "S", "d0") is True
        assert br.submit(_req(2), "S", "d0") is True          # inf deadline
        assert br.drain()
        st = br.stats()
    assert st["shed"]["deadline"] == 1 and st["served"] == 2
    _assert_conserved(st)
    assert st["shed_requests"][0] == {"rid": 0, "tier": "S",
                                      "variant": "d0", "reason": "deadline"}


def test_bridge_unknown_tier_raises():
    with ServingBridge({"S": {"d0": StubEngine()}}, _cfg()) as br:
        with pytest.raises(KeyError):
            br.submit(_req(0), "E", "d0")


def test_bridge_timeout_reroutes_once_then_serves():
    spans = SpanRecorder()
    hung, fast = StubEngine(wall_s=1.0), StubEngine()
    cfg = _cfg(max_batch=4, max_wait_ms=0.0, engine_timeout_s=0.1)
    with ServingBridge({"S": {"d0": hung}, "E": {"d0": fast}}, cfg,
                       spans=spans) as br:
        for i in range(3):
            br.submit(_req(i), "S", "d0")
        assert br.drain()
        st = br.stats()
    assert st["timeouts"] >= 1 and st["rerouted"] == 3
    assert st["served"] == 3 and st["shed"]["total"] == 0
    _assert_conserved(st)
    assert fast.calls >= 1
    names = {e["name"] for e in spans.events}
    assert {"bridge.timeout", "bridge.reroute"} <= names
    validate_chrome_trace(spans.chrome_trace())


def test_bridge_timeout_sheds_without_fallback():
    spans = SpanRecorder()
    cfg = _cfg(max_batch=4, max_wait_ms=0.0, engine_timeout_s=0.1,
               reroute={})
    with ServingBridge({"S": {"d0": StubEngine(wall_s=1.0)}}, cfg,
                       spans=spans) as br:
        for i in range(3):
            br.submit(_req(i), "S", "d0")
        assert br.drain()
        st = br.stats()
    assert st["shed"]["timeout"] == 3 and st["served"] == 0
    _assert_conserved(st)
    assert {e["name"] for e in spans.events} >= {"bridge.timeout",
                                                "bridge.shed"}


def test_bridge_drain_timeout_flushes():
    cfg = _cfg(max_batch=2, max_wait_ms=0.0, engine_timeout_s=30.0)
    with ServingBridge({"S": {"d0": StubEngine(wall_s=2.0)}}, cfg) as br:
        for i in range(6):
            br.submit(_req(i), "S", "d0")
        assert br.drain(timeout_s=0.2) is False
        st = br.stats()
    assert st["shed"]["drain"] > 0 and st["served"] == 0
    _assert_conserved(st)


def test_bridge_oversize_submit_splits_batches():
    eng = StubEngine(wall_s=0.01)
    cfg = _cfg(max_batch=3, max_wait_ms=50.0, max_queue=64)
    with ServingBridge({"S": {"d0": eng}}, cfg) as br:
        for i in range(8):
            br.submit(_req(i), "S", "d0")
        assert br.drain()
        st = br.stats()
    assert st["served"] == 8
    _assert_conserved(st)
    assert all(b["requests"] <= cfg.max_batch for b in br.batch_log)
    assert sum(b["requests"] for b in br.batch_log) == 8


def test_route_bridge_reuse_per_call_accounting():
    from repro_torch.fleet import scenarios
    from repro_torch.rng import Draws
    scen = scenarios.init_fleet(
        Draws(0, "cpu"), scenarios.FleetConfig(cells=4, users=3,
                                               arrival_rate=None))
    n_active = int(scen.active.sum())
    eng = StubEngine(wall_s=0.01)
    eng.model = types.SimpleNamespace(cfg=types.SimpleNamespace(
        vocab_size=32))
    engines = {"S": {"d0": eng}}
    orch = api.FleetOrchestrator(api.StaticPolicy(3, "device"))
    # a 50 ms formation window: batches fill even when the submitting
    # thread is slowed by other work on the host
    with ServingBridge(engines, _cfg(max_batch=4, max_wait_ms=50.0)) as br:
        r1 = orch.route(scen=scen, dispatch=engines, bridge=br,
                        max_new_tokens=1, batch_size=4)
        r2 = orch.route(scen=scen, dispatch=engines, bridge=br,
                        max_new_tokens=1, batch_size=4)
    for r in (r1, r2):
        assert len(r.served) == n_active
        per = r.timings["per_tier_variant"]["S/d0"]
        assert per["requests"] == n_active
        assert 1 <= r.batches <= -(-n_active // 4) + 1
    st = r2.bridge
    assert st["submitted"] == 2 * n_active
    assert st["served"] + st["shed"]["total"] == st["submitted"]


def test_streams_only_for_engines_on_the_card():
    """A CPU engine or one without a device gets no stream, so the
    bridge never touches CUDA off the card."""
    cpu_eng = types.SimpleNamespace(device=torch.device("cpu"))
    assert bridge_mod._engine_stream(cpu_eng) is None
    assert bridge_mod._engine_stream(StubEngine()) is None
    with ServingBridge({"S": {"d0": StubEngine()}}, _cfg()) as br:
        assert br.streams == {("S", "d0"): None}


# --------------------------------------------- against the reference ----
#: case -> (engines {tier: engine class name}, config, submits as
#: (rid, tier, request keywords), drain keywords)
_LATE = "late"
_PARITY = {
    "deadline_admission": (
        {"S": "stub"}, {},
        [(0, "S", _LATE), (1, "S", {"deadline_ms": 1e6}), (2, "S", {})],
        {}),
    "unknown_tier": (
        {"S": "stub"}, {}, [(0, "E", {}), (1, "S", {})], {}),
    "hung_rerouted_once": (
        {"S": "hung", "E": "stub"},
        {"max_batch": 3, "max_wait_ms": 1e3, "engine_timeout_s": 0.1},
        [(i, "S", {}) for i in range(3)], {}),
    "raising_rerouted_once": (
        {"S": "raise", "E": "stub"}, {"max_batch": 3, "max_wait_ms": 1e3},
        [(i, "S", {}) for i in range(3)], {}),
    "raising_without_fallback": (
        {"S": "raise"}, {"max_batch": 3, "max_wait_ms": 1e3, "reroute": {}},
        [(i, "S", {}) for i in range(3)], {}),
    "raising_rerouted_then_shed": (
        {"S": "raise", "E": "raise"}, {"max_batch": 3, "max_wait_ms": 1e3},
        [(i, "S", {}) for i in range(3)], {}),
    "drain_flush": (
        {"S": "gated"}, {"max_batch": 2, "max_wait_ms": 0.0},
        [(i, "S", {}) for i in range(6)], {"timeout_s": 0.2}),
}


def _run_bridge(mod, recorder, request, case):
    """One case through one package's bridge: (submit outcomes, drain
    result, stats, the bridge instants as (name, args) without the
    port's error cause, engine calls per tier)."""
    engines_spec, cfg_kw, submits, drain_kw = _PARITY[case]
    gate = threading.Event()
    make = {"stub": StubEngine, "hung": lambda: StubEngine(wall_s=1.0),
            "raise": RaisingEngine, "gated": lambda: GatedEngine(gate)}
    engines = {t: {"d0": make[kind]()} for t, kind in engines_spec.items()}
    spans = recorder()
    cfg = mod.BridgeConfig(**{"drain_timeout_s": DRAIN_S, **cfg_kw})
    outcomes = []
    with mod.ServingBridge(engines, cfg, spans=spans) as br:
        for rid, tier, kw in submits:
            if kw == _LATE:
                kw = {"deadline_ms": 5.0,
                      "arrival_time": time.perf_counter() - 1.0}
            try:
                outcomes.append(br.submit(_req(rid, request, **kw), tier,
                                          "d0"))
            except KeyError:
                outcomes.append("KeyError")
        clean = br.drain(**drain_kw)
        st = br.stats()
        gate.set()
    st["shed_requests"] = sorted(st["shed_requests"],
                                 key=lambda r: r["rid"])
    instants = sorted(
        (e["name"], sorted((k, v) for k, v in e["args"].items()
                           if k != "error"))
        for e in spans.events if e["ph"] == "i")
    calls = {t: e["d0"].calls for t, e in engines.items()}
    return outcomes, clean, st, instants, calls


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_bridge_matches_the_reference(case):
    ref = _run_bridge(jbridge, jspans.SpanRecorder, jbatching.Request, case)
    got = _run_bridge(bridge_mod, SpanRecorder, batching_mod.Request, case)
    errors = got[2].pop("engine_errors")
    assert got == ref
    _, clean, st, _, _ = got
    _assert_conserved(st)
    assert clean == (case != "drain_flush")
    # the port keeps the cause of every exception an engine raised
    assert len(errors) == (st["timeouts"] if case.startswith("raising")
                           else 0)
    assert all("illegal memory access" in e["error"] for e in errors)


def test_card_engine_fault_fails_the_drain(monkeypatch):
    """An exception from an engine on the card is a fault, not a slow
    engine: its requests are rerouted or shed as the reference does, the
    identities balance, and ``drain()`` then raises it. The card is
    stood in for by a stream handle that is never entered."""
    card = object()
    monkeypatch.setattr(bridge_mod, "_engine_stream", lambda eng: card)
    monkeypatch.setattr(
        bridge_mod, "_serve_on",
        lambda stream, eng, reqs, toks, spans, t_drain:
        eng.serve_batch(reqs, toks, spans=spans, t_drain=t_drain))
    spans = SpanRecorder()
    cfg = _cfg(max_batch=3, max_wait_ms=1e3)
    with ServingBridge({"S": {"d0": RaisingEngine()},
                        "E": {"d0": StubEngine()}}, cfg, spans=spans) as br:
        for i in range(3):
            br.submit(_req(i), "S", "d0")
        with pytest.raises(RuntimeError, match="on the card") as err:
            br.drain()
        st = br.stats()
        # raised once: a later drain of the same bridge is clean
        assert br.drain()
    assert isinstance(err.value.__cause__, RuntimeError)
    assert "illegal memory access" in str(err.value.__cause__)
    assert st["rerouted"] == 3 and st["served"] == 3
    _assert_conserved(st)
    assert st["engine_errors"] == [{
        "tier": "S", "variant": "d0", "requests": 3,
        "error": repr(err.value.__cause__)}]
    (timeout,) = [e for e in spans.events if e["name"] == "bridge.timeout"]
    assert timeout["args"]["error"] == st["engine_errors"][0]["error"]


# ------------------------------------------------ real engines, spans ----
@pytest.fixture(scope="module")
def routed():
    """A tabular agent on the recorded trace routed into CPU edge-ladder
    engines, synchronously and through the bridge, with spans."""
    src = api.TraceSource.load(TRACE, device="cpu")
    agent = population.FleetQLearning(
        src, cfg=population.FleetQConfig(eps_decay=5e-3), seed=0,
        device="cpu")
    agent.run(2 * src.horizon)
    engines = build_engines(get_config("edge-ladder"), variants=("d0",),
                            max_len=48, device="cpu")
    orch = api.FleetOrchestrator(agent)
    kw = dict(dispatch=engines, max_new_tokens=2, batch_size=4,
              prompt_len=8)
    sync_spans, bridge_spans = SpanRecorder(), SpanRecorder()
    sync = orch.route(spans=sync_spans, **kw)
    res = orch.route(bridge=_cfg(max_batch=4), spans=bridge_spans, **kw)
    return agent, sync, res, sync_spans, bridge_spans


def _check_identities(res, n_active):
    for r in res.served:
        assert r.queue_ms + r.measured_ms == pytest.approx(r.e2e_ms)
    t = res.timings
    assert t["batching_ms"] + t["compute_ms"] + t["dispatch_ms"] \
        == pytest.approx(t["wall_ms"])
    slo = res.slo()
    assert slo["measured"]["attained"] + slo["measured"]["violated"] \
        == slo["requests"] == n_active
    for tv in slo["per_tier_variant"].values():
        assert tv["measured_attained"] + tv["measured_violated"] == \
            tv["dispatched"]


def _check_spans(res, spans):
    validate_chrome_trace(spans.chrome_trace())
    got = sorted(spans.durations_ms("request.e2e"))
    want = sorted(r.e2e_ms for r in res.served)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    q = res.slo()["quantiles"]
    hist, exact = q["hist_ms"], q["exact_ms"]
    assert hist["n"] == len(res.served)
    if not hist["clipped"]:
        for key in exact:
            assert abs(hist[key] - exact[key]) <= hist["bin_width"]
    assert res.lat_acc.summary()["e2e_ms"]["count"] == len(res.served)


def test_route_bridge_serves_the_sync_request_set(routed):
    agent, sync, res, _, _ = routed
    n_active = int(agent.scen.active.sum())
    assert len(res.served) == len(sync.served) == n_active
    assert ({(r.cell, r.user) for r in res.served}
            == {(r.cell, r.user) for r in sync.served})
    assert [(r.cell, r.user, r.action, r.tier, r.variant)
            for r in res.served] == \
        [(r.cell, r.user, r.action, r.tier, r.variant) for r in sync.served]
    np.testing.assert_array_equal(res.predicted_ms, sync.predicted_ms)
    st = res.bridge
    assert st is not None and res.summary()["bridge"] is st
    assert sync.bridge is None and "bridge" not in sync.summary()
    assert st["submitted"] == n_active
    _check_bridge_counts(st)
    assert st["timeouts"] == st["rerouted"] == st["shed"]["total"] == 0
    assert st["overlap_x"] > 0
    for r in (sync, res):
        _check_identities(r, n_active)
    assert sync.timings["dispatch_ms"] >= 0


def _check_bridge_counts(st):
    assert st["submitted"] == st["admitted"] + st["shed"]["overflow"] \
        + st["shed"]["deadline"]
    assert st["served"] + st["shed"]["total"] == st["submitted"]


def test_route_spans_reproduce_the_served_latencies(routed):
    _, sync, res, sync_spans, bridge_spans = routed
    for r, spans in ((sync, sync_spans), (res, bridge_spans)):
        _check_spans(r, spans)
        names = {e["name"] for e in spans.events}
        assert {"route.decide", "route.dispatch", "dispatch.batch_build",
                "engine.generate", "engine.prefill", "engine.decode",
                "request.e2e", "slo.attainment"} <= names
    assert any(n.startswith("dispatch.drain.")
               for n in (e["name"] for e in sync_spans.events))
    assert any(n.startswith("bridge.batch.")
               for n in (e["name"] for e in bridge_spans.events))


def test_overloaded_bridge_sheds_with_cells():
    """A queue bound below the burst sheds on overflow; the identities
    hold and every shed record names its cell, user and action."""
    from repro_torch.fleet import scenarios
    from repro_torch.rng import Draws
    scen = scenarios.init_fleet(
        Draws(1, "cpu"), scenarios.FleetConfig(cells=16, users=3,
                                               arrival_rate=None))
    n_active = int(scen.active.sum())
    eng = StubEngine(wall_s=0.02)
    eng.model = types.SimpleNamespace(cfg=types.SimpleNamespace(
        vocab_size=32))
    res = api.FleetOrchestrator(api.StaticPolicy(3, "device")).route(
        scen=scen, dispatch={"S": {"d0": eng}}, max_new_tokens=1,
        batch_size=4, bridge=_cfg(max_batch=4, max_queue=8,
                                  max_wait_ms=0.0))
    st = res.bridge
    assert st["shed"]["overflow"] > 0
    _check_bridge_counts(st)
    assert len(res.served) + st["shed"]["total"] == n_active
    assert all({"cell", "user", "action"} <= set(sr)
               for sr in st["shed_requests"])
    _check_identities(res, len(res.served))


# ----------------------------------------------- kernels under threads ----
def test_kernel_load_and_launch_count_are_thread_safe(monkeypatch):
    """Many threads reaching a stale kernel build it once, and every
    accepted launch is counted (a lost update or a second ``nvcc`` into
    the same temporary file is what the locks prevent)."""
    from repro_torch.kernels import _build

    kernel = _build.CudaKernel("fake", [])
    builds = []

    def fake_build(kernels):
        builds.append([k.name for k in kernels])
        time.sleep(0.05)                  # widen the race window

    def launch(*args):
        return 0

    def error_string(code):
        return b"no error"

    lib = types.SimpleNamespace(fake_launch=launch,
                                fake_error_string=error_string)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(kernel, "stale", lambda: True)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(_build.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    n_threads, n = 16, 400
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(n):
            kernel.launch()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert builds == [["fake"]]
    assert kernel.launches == n_threads * n
