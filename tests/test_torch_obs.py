"""The port's telemetry (``repro_torch.obs``) against the JAX package's
(``repro.obs``), on the CPU.

* ``MetricsAccumulator``: the same values (a numpy seed, plus values
  exactly at the bin edges, at ``lo``, at ``hi`` and outside the range)
  through both packages, with and without windows, one and three samples
  a lane, and a chunked ``merge``. count, hist, underflow, overflow, mn,
  mx and the windowed count/min/max are bit-exact, as is every float sum
  of one sample a lane; sums of three samples a lane within rtol 1e-6
  (another summation order); ``summary()`` and ``quantiles()`` equal,
  float fields within rtol 1e-6.
* Both port agents train bit-identically with metrics on and off.
* ``FleetQLearning``'s recorded metrics on ``tests/data/trace_small.npz``
  equal the JAX agent's under its own draws: integer leaves equal,
  float leaves within 1e-5 (the float32 latency model summed in another
  order).
* ``SpanRecorder`` and ``validate_chrome_trace``: the cases of
  ``tests/test_obs.py``; ``flatten``, ``rel_diff``, ``config_hash`` and
  the manifest's keys.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import api as japi
from repro.fleet import population as jpop
from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro.obs import spans as jspans
from repro_torch.fleet import api, policy, population, scenarios
from repro_torch.obs import (MetricDef, MetricsAccumulator, SpanRecorder,
                             attach_manifest, config_hash, flatten, rel_diff,
                             run_manifest, span, validate_chrome_trace)
from repro_torch.rng import Draws

TRACE = os.path.join(os.path.dirname(__file__), "data", "trace_small.npz")

INT_LEAVES = ("count", "hist", "underflow", "overflow", "wcount")
EXACT_FLOAT_LEAVES = ("mn", "mx", "wmn", "wmx")


class Recorded(Draws):
    """Draws that replay recorded values site by site, in order."""

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


def _defs(windows):
    w = dict(n_windows=3, window_len=2) if windows else {}
    return {
        "r": dict(lo=-2.0, hi=0.0, bins=8, lanes=4, **w),
        # a range whose bin scale is not exact in float32
        "ms": dict(lo=0.0, hi=2500.0, bins=32, lanes=4, **w),
        "eps": dict(lo=0.0, hi=1.0, bins=4, lanes=1, **w),
    }


def _pair(windows):
    defs = _defs(windows)
    ja = jmetrics.MetricsAccumulator.create(
        {k: jmetrics.MetricDef(**v) for k, v in defs.items()})
    pa = MetricsAccumulator.create(
        {k: MetricDef(**v) for k, v in defs.items()}, device="cpu")
    return ja, pa


def _stream(k, n=9, seed=0):
    """n observations per metric: uniform draws over and beyond each
    range, with the first lane pinned to a bin edge, ``lo``, ``hi`` and
    points outside in turn."""
    rng = np.random.default_rng(seed)
    r_edges = np.linspace(-2.0, 0.0, 9).astype(np.float32)
    ms_edges = np.linspace(0.0, 2500.0, 33).astype(np.float32)
    out = []
    for i in range(n):
        shape = (4, k) if k > 1 else (4,)
        r = rng.uniform(-2.5, 0.5, shape).astype(np.float32)
        ms = rng.uniform(-100.0, 2700.0, shape).astype(np.float32)
        r.reshape(4, -1)[0, 0] = r_edges[i % 9]
        r.reshape(4, -1)[1, 0] = (-2.0, 0.0, -3.0, 1.0)[i % 4]
        ms.reshape(4, -1)[0, 0] = ms_edges[(5 * i) % 33]
        ms.reshape(4, -1)[1, 0] = (0.0, 2500.0, -1.0, 1e4)[i % 4]
        eps = np.float32((0.0, 1.0, 0.25, -0.5, 1.5, 0.3)[i % 6])
        out.append({"r": r, "ms": ms, "eps": eps})
    return out


def _assert_leaves(ja, pa, k):
    assert set(ja.data) == set(pa.data)
    for name, leaves in ja.data.items():
        assert set(leaves) == set(pa.data[name])
        for key, v in leaves.items():
            want, got = np.asarray(v), pa.data[name][key].numpy()
            assert got.dtype == want.dtype, (name, key)
            if key in INT_LEAVES or key in EXACT_FLOAT_LEAVES or k == 1:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name}.{key}")
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           err_msg=f"{name}.{key}")


def _assert_same(a, b, path=""):
    """Equal JSON-like trees: ints, bools, None and strings exactly,
    floats within rtol 1e-6."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert b == pytest.approx(a, rel=1e-6, nan_ok=True), path
    else:
        assert a == b and type(a) is type(b), (path, a, b)


@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_accumulator_matches_the_reference(windows, k):
    ja, pa = _pair(windows)
    for obs in _stream(k):
        ja = ja.update({n: jnp.asarray(v) for n, v in obs.items()})
        assert pa.update({n: torch.tensor(v) for n, v in obs.items()}) \
            is pa
    assert pa.step == int(ja.step) == 9
    _assert_leaves(ja, pa, k)
    _assert_same(ja.summary(), pa.summary())
    for name in ("r", "ms", "eps"):
        _assert_same(ja.quantiles(name, warn=False),
                     pa.quantiles(name, warn=False))
        np.testing.assert_array_equal(pa.lane_means(name),
                                      ja.lane_means(name))


@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_non_finite_values_match_the_reference(windows, k):
    """NaN and +-inf (a diverged loss, say) are recorded as the reference
    records them: NaN in bin 0, infinities in the edge bins and the
    under/overflow counts, moments NaN or infinite; nothing raises."""
    ja, pa = _pair(windows)
    for i, obs in enumerate(_stream(k, n=6, seed=3)):
        for name in ("r", "ms"):
            flat = obs[name].reshape(-1)
            flat[i % flat.size] = np.nan
            flat[(i + 2) % flat.size] = (np.inf, -np.inf)[i % 2]
        if i % 3 == 0:
            obs["eps"] = np.float32((np.nan, np.inf, -np.inf)[i // 3 % 3])
        ja = ja.update({n: jnp.asarray(v) for n, v in obs.items()})
        pa.update({n: torch.tensor(v) for n, v in obs.items()})
    _assert_leaves(ja, pa, k)        # NaN equals NaN in both asserts
    assert int(pa.data["r"]["hist"][0]) > 0
    _assert_same(ja.summary(), pa.summary())
    for name in ("r", "ms", "eps"):
        _assert_same(ja.quantiles(name, warn=False),
                     pa.quantiles(name, warn=False))


@pytest.mark.parametrize("windows", [False, True])
def test_chunked_merge_matches_the_reference(windows):
    stream = _stream(3, n=8, seed=1)
    halves = []
    for part in (stream[:4], stream[4:]):
        ja, pa = _pair(windows)
        for obs in part:
            ja = ja.update({n: jnp.asarray(v) for n, v in obs.items()})
            pa.update({n: torch.tensor(v) for n, v in obs.items()})
        halves.append((ja, pa))
    jm = halves[0][0].merge(halves[1][0])
    pm = halves[0][1].merge(halves[1][1])
    _assert_leaves(jm, pm, 3)
    assert pm.step == int(jm.step)
    _assert_same(jm.summary(), pm.summary())
    # merging leaves both operands as they were
    assert halves[0][1].step == 4 and int(halves[0][1].data["r"]["count"]
                                          .sum()) == 4 * 4 * 3


def test_python_scalars_and_empty_summary():
    """A Python or numpy scalar folds like a float32 tensor, and an empty
    stream summarizes with None moments, as in the reference."""
    ja, pa = _pair(False)
    ja = ja.update({"eps": 0.1})
    pa.update({"eps": 0.1})
    _assert_leaves(ja, pa, 1)
    _assert_same(ja.summary(), pa.summary())
    assert pa.summary()["r"]["mean"] is None
    np.testing.assert_array_equal(pa.lane_means("r"), ja.lane_means("r"))


def test_accumulator_errors():
    pa = MetricsAccumulator.create({"a": MetricDef(lanes=4)}, device="cpu")
    with pytest.raises(KeyError, match="unknown metric"):
        pa.update({"b": torch.zeros(4)})
    with pytest.raises(ValueError, match="lanes"):
        pa.update({"a": torch.zeros(6)})
    with pytest.raises(ValueError, match="hi > lo"):
        MetricDef(lo=1.0, hi=1.0)
    with pytest.raises(ValueError, match="bins"):
        MetricDef(bins=0)
    with pytest.raises(ValueError, match="n_windows"):
        MetricDef(n_windows=-1)
    other = MetricsAccumulator.create({"a": MetricDef(lanes=2)},
                                      device="cpu")
    with pytest.raises(ValueError, match="different specs"):
        pa.merge(other)


def test_fleet_metrics_factory_matches_the_reference():
    for kind in ("tabular", "dqn"):
        got = population.fleet_metrics(16, kind, n_windows=4, window_len=5,
                                       device="cpu")
        want = jpop.fleet_metrics(16, kind, n_windows=4, window_len=5)
        assert {k: vars(v) for k, v in got.defs.items()} == \
            {k: vars(v) for k, v in want.defs.items()}
    with pytest.raises(ValueError, match="kind"):
        population.fleet_metrics(16, "nope", device="cpu")


# ------------------------------------------------------------- agents ----
def _small_fleet(cells=16, users=3, seed=2):
    scen = scenarios.mixed_table5_fleet(Draws(seed, "cpu"), cells, users,
                                        min_users=1, max_users=users)
    return scen, scenarios.FleetConfig(cells=cells, users=users)


def test_tabular_metrics_on_and_off_train_identically():
    out = []
    for metrics in (True, False):
        scen, fcfg = _small_fleet()
        agent = population.FleetQLearning(scen, fcfg, seed=3, device="cpu",
                                          metrics=metrics, n_windows=2,
                                          window_len=10)
        agent.run(20)
        agent.step()
        out.append(agent)
    on, off = out
    assert torch.equal(on.q, off.q) and torch.equal(on.counts, off.counts)
    assert on.eps == off.eps and off.metrics_summary() is None
    s = on.metrics_summary()
    assert s["reward"]["count"] == 21 * 16 and s["epsilon"]["count"] == 21
    # slot (step // 10) % 2: the 21st update wraps into slot 0
    assert s["td_abs"]["windows"]["count"] == [11 * 16, 10 * 16]


def test_dqn_metrics_on_and_off_train_identically():
    out = []
    for metrics in (True, False):
        scen, fcfg = _small_fleet(cells=12)
        agent = policy.FleetDQN(
            scen, fcfg, cfg=policy.FleetDQNConfig(hidden=16, batch_size=32,
                                                  replay_capacity=64),
            seed=5, device="cpu", metrics=metrics)
        agent.run(6)
        agent.step()
        out.append(agent)
    on, off = out
    for p, q in zip(on.params, off.params):
        for key in ("w", "b"):
            assert torch.equal(p[key], q[key])
    assert torch.equal(on.buffer.s, off.buffer.s)
    s = on.metrics_summary()
    assert s["mean_ms"]["count"] == 7 * 12 and s["loss"]["count"] == 7
    # occupancy: 12 rows a step into a 64-row ring, full from step 6
    assert s["replay_fill"]["min"] == pytest.approx(12 / 64)
    assert s["replay_fill"]["max"] == 1.0


def _tabular_draws(seed, cells, n, noise):
    """The explore uniforms and noise normals the JAX agent's ``run(n)``
    consumes (its key chain, as in ``tests/test_torch_fleet.py``)."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    u, z = [], []
    for _ in range(n):
        key, k = jax.random.split(key)
        k_exp, k_noise, _ = jax.random.split(k, 3)
        u.append(jax.random.uniform(k_exp, (cells,)))
        if noise:
            z.append(jax.random.normal(k_noise, (cells,)))
    return Recorded(explore=u, noise=z)


@pytest.mark.parametrize("windows", [False, True])
def test_tabular_metrics_on_the_trace_match_the_reference(windows):
    n = 30
    w = dict(n_windows=4, window_len=8) if windows else {}
    jagent = jpop.FleetQLearning(japi.TraceSource.load(TRACE),
                                 cfg=jpop.FleetQConfig(), seed=4, **w)
    jagent.run(n)
    cells = jagent.scen.cells
    pagent = population.FleetQLearning(
        api.TraceSource.load(TRACE, device="cpu"),
        cfg=population.FleetQConfig(), device="cpu",
        draws=_tabular_draws(4, cells, n, 0.02), **w)
    pagent.run(n)
    for name, leaves in jagent.metrics.data.items():
        for key, v in leaves.items():
            want, got = np.asarray(v), pagent.metrics.data[name][key].numpy()
            if key in INT_LEAVES:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name}.{key}")
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name}.{key}")
    js, ps = jagent.metrics_summary(), pagent.metrics_summary()
    for name in js:
        for key in ("count", "hist", "underflow", "overflow"):
            assert ps[name][key] == js[name][key], (name, key)
        assert ps[name]["mean"] == pytest.approx(js[name]["mean"],
                                                 rel=1e-5, abs=1e-5)


def test_train_against_oracle_attaches_the_manifest():
    scen, fcfg = _small_fleet()
    agent = population.FleetQLearning(scen, fcfg, seed=0, device="cpu")
    res = population.train_against_oracle(agent, max_steps=20,
                                          check_every=10)
    m = res.manifest
    assert m["schema"] == "repro.obs/manifest-v1"
    assert m["torch_version"] == torch.__version__
    assert m["steps"] == agent.steps > 0
    assert m["wall_seconds"] == pytest.approx(res.wall_seconds)
    assert m["config_hash"] == config_hash(agent.cfg)


# -------------------------------------------------------------- spans -----
def test_span_recorder_nesting_and_durations():
    rec = SpanRecorder()
    with rec.span("outer", kind="test"):
        with rec.span("inner"):
            pass
    rec.instant("marker", note="hi")
    rec.counter("queue", depth=3)
    names = [e["name"] for e in rec.events]
    assert names == ["inner", "outer", "marker", "queue"]  # close order
    outer = next(e for e in rec.events if e["name"] == "outer")
    inner = next(e for e in rec.events if e["name"] == "inner")
    assert outer["ts"] <= inner["ts"]
    assert outer["dur"] >= inner["dur"]
    assert outer["args"] == {"kind": "test"}
    assert rec.durations_ms("outer") and rec.durations_ms("nope") == []
    # the reference records the same event fields
    jrec = jspans.SpanRecorder()
    with jrec.span("outer", kind="test"):
        pass
    assert set(jrec.events[0]) == set(outer)


def test_span_helper_none_recorder_is_noop():
    with span(None, "anything", x=1):
        pass
    rec = SpanRecorder()
    with span(rec, "real"):
        pass
    assert [e["name"] for e in rec.events] == ["real"]


def test_spans_nest_under_the_torch_profiler():
    rec = SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("engine.generate"):
            torch.ones(4).sum()
    assert "engine.generate" in {e.key for e in prof.key_averages()}


def test_chrome_trace_save_validate_roundtrip(tmp_path):
    rec = SpanRecorder()
    with rec.span("a", obj=object()):                # non-json arg -> str
        pass
    rec.complete("request.e2e", rec._t0 - 1.0, 0.5)   # predates: ts clamps
    path = rec.save(str(tmp_path / "t.json"), manifest=run_manifest())
    with open(path) as f:
        trace = json.load(f)
    validate_chrome_trace(trace)
    jspans.validate_chrome_trace(trace)
    assert trace["displayTimeUnit"] == "ms"
    assert trace["otherData"]["schema"] == "repro.obs/manifest-v1"
    e = next(e for e in trace["traceEvents"] if e["name"] == "a")
    assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
    assert isinstance(e["args"]["obj"], str)
    e2e = next(e for e in trace["traceEvents"] if e["name"] == "request.e2e")
    assert e2e["ts"] == 0.0 and e2e["dur"] == pytest.approx(5e5)


_TRACES = [
    ({"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0, "dur": 1.0,
                       "pid": 1, "tid": 1}]}, None),
    ([], "must be a dict"),
    ({"traceEvents": {}}, "must be a list"),
    ({"traceEvents": [{"ph": "X", "ts": 0.0}]}, "name"),
    ({"traceEvents": [{"name": "x", "ph": "Z", "ts": 0.0, "pid": 1,
                       "tid": 1}]}, "bad phase"),
    ({"traceEvents": [{"name": "x", "ph": "X", "ts": -1.0, "dur": 1.0,
                       "pid": 1, "tid": 1}]}, "ts"),
    ({"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0, "pid": 1,
                       "tid": 1}]}, "dur"),
    ({"traceEvents": [{"name": "x", "ph": "i", "ts": 0.0, "pid": "1",
                       "tid": 1}]}, "pid"),
    ({"traceEvents": [{"name": "x", "ph": "i", "ts": 0.0, "pid": 1,
                       "tid": 1, "args": []}]}, "args"),
    ({"traceEvents": [{"name": "x", "ph": "i", "ts": 0.0, "pid": 1,
                       "tid": 1, "args": {"o": object()}}]},
     "JSON-serialisable"),
]


@pytest.mark.parametrize("trace,match", _TRACES,
                         ids=[m or "ok" for _, m in _TRACES])
def test_validate_chrome_trace_accepts_and_rejects_as_the_reference(
        trace, match):
    if match is None:
        assert validate_chrome_trace(trace) is trace
        jspans.validate_chrome_trace(trace)
        return
    with pytest.raises(ValueError, match=match) as got:
        validate_chrome_trace(trace)
    with pytest.raises(ValueError) as want:
        jspans.validate_chrome_trace(trace)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- manifest -----
_RUNS = [
    {"a": 1, "b": {"c": 2.5, "d": [1, {"e": None}]}, "manifest": {"x": 1}},
    {"rps": [3.0, 4.0], "nested": {"deep": {"ok": True}}},
]


@pytest.mark.parametrize("run", _RUNS)
def test_flatten_rel_diff_and_hash_equal_the_reference(run):
    assert flatten(run) == jreport.flatten(run)
    assert config_hash(run) == jreport.config_hash(run)
    for a, b in ((2.0, 3.0), (0.0, 0.5), (-4.0, -2.0)):
        assert rel_diff(a, b) == jreport.rel_diff(a, b)


def test_run_manifest_keys():
    m = run_manifest(config=scenarios.FleetConfig(cells=4, users=2),
                     extra_key=7)
    want = set(jreport.run_manifest()) - {"jax_version", "jaxlib_version"}
    assert set(m) == want | {"torch_version", "cuda_version", "extra_key"}
    assert m["schema"] == jreport.MANIFEST_SCHEMA
    assert m["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert m["device_count"] >= 1 and m["device_kinds"]
    assert m["mesh_shape"] is None and m["extra_key"] == 7
    assert len(m["config_hash"]) == 16
    payload = {"rps": 1.0}
    out = attach_manifest(payload, config={"a": 1})
    assert "manifest" not in payload and out["rps"] == 1.0
    assert out["manifest"]["config_hash"] == config_hash({"a": 1})
