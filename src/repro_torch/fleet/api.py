"""The fleet front door — the port of ``repro/fleet/api.py``.

* ``ScenarioSource``: ``reset(draws) -> (FleetScenario, state)`` /
  ``step(draws, state) -> (FleetScenario, state)``. ``SyntheticSource``
  wraps the ``FleetConfig`` generators; ``TraceSource`` replays a
  recorded ``FleetTrace`` (the same ``.npz`` format as the reference's
  ``save_trace``).
* ``FleetPolicy``: ``decisions(counts, scen)`` / ``expected(scen,
  counts)``, the one surface over both fleet agents, the brute-force
  oracle (``OraclePolicy``) and the paper's fixed strategies
  (``StaticPolicy``).
* ``FleetOrchestrator.route``: one greedy pass routes every cell; with
  ``dispatch={tier: {variant: ServingEngine}}`` (``launch.serve.
  build_engines``) the routed requests of every active user are batched
  into real engines and the measured latencies come back next to the
  latency model's predictions (``RouteResult``, the paper's Table-8
  predicted-vs-measured methodology at fleet scale).

Not ported yet: the asynchronous serving bridge (``bridge=``), spans
(``spans=``) and the device-side latency accumulator (``lat_acc``, so
``RouteResult.slo()`` has no ``hist_ms``); see ROADMAP queue 1.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Callable, List, Optional, Protocol, Tuple, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.spaces import SpaceSpec
from repro_torch.fleet import dynamics, topology
from repro_torch.fleet.population import (check_pad_width, default_actions,
                                          fleet_bruteforce,
                                          nominal_expected_response)
from repro_torch.fleet.scenarios import (FleetConfig, FleetScenario,
                                         arrivals_from_timestamps,
                                         init_fleet, step_fleet)
from repro_torch.obs import timeline

# ---------------------------------------------------------------------------
# ScenarioSource — the scenario seam
# ---------------------------------------------------------------------------


@runtime_checkable
class ScenarioSource(Protocol):
    """Anything that can produce a stream of ``FleetScenario``s. The
    built-in sources set ``state_is_scenario = True`` (their state IS
    the scenario), which the agents' training loops require."""

    cells: int
    users: int
    state_is_scenario: bool

    @property
    def dynamic(self) -> bool:
        """Does the scenario stream move between steps?"""
        ...

    def reset(self, draws) -> Tuple[FleetScenario, object]: ...

    def step(self, draws, state) -> Tuple[FleetScenario, object]: ...


def is_source(obj) -> bool:
    """Duck-typed ScenarioSource check (a ``FleetScenario`` is not one)."""
    return callable(getattr(obj, "reset", None)) and \
        callable(getattr(obj, "step", None))


def require_scenario_state(source) -> None:
    """The training loops carry only the scenario; reject sources whose
    step state is something richer, up front and clearly."""
    if not getattr(source, "state_is_scenario", False):
        raise TypeError(
            f"{type(source).__name__} must set state_is_scenario=True "
            "(its step state must BE the scenario) to drive a fleet "
            "training loop; both built-in sources qualify")


class SyntheticSource:
    """`ScenarioSource` over the ``FleetConfig`` generators: ``reset``
    is ``init_fleet`` and ``step`` is ``step_fleet``. Pass ``scen`` to
    pin an explicitly built initial fleet, which ``reset`` returns as
    is."""

    state_is_scenario = True

    def __init__(self, cfg: FleetConfig,
                 scen: Optional[FleetScenario] = None):
        self.cfg = cfg
        self._scen0 = scen

    @property
    def cells(self) -> int:
        return self.cfg.cells if self._scen0 is None else self._scen0.cells

    @property
    def users(self) -> int:
        return self.cfg.users if self._scen0 is None else self._scen0.users

    @property
    def dynamic(self) -> bool:
        c = self.cfg
        return bool(c.p_r2w or c.p_w2r or c.p_join or c.p_leave
                    or c.p_edge_fail)

    def reset(self, draws):
        scen = self._scen0 if self._scen0 is not None \
            else init_fleet(draws, self.cfg)
        return scen, scen

    def step(self, draws, state):
        scen = step_fleet(draws, state, self.cfg)
        return scen, scen


# ---------------------------------------------------------------------------
# recorded traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetTrace:
    """A recorded fleet workload: link-quality series + arrival events.

    end_b        : (T, cells, N) int   per-user end-link series (0 R, 1 W)
    edge_b       : (T, cells)    int   edge backhaul series
    arrival_time : (E,) float  request timestamps (seconds)
    arrival_cell : (E,) int    issuing cell of each request
    arrival_user : (E,) int    issuing user (slot in the cell's pad)
    step_duration: float       seconds binned into one fleet step
    member       : optional (T, cells, N) or (cells, N) bool membership
    cell_edge    : optional (cells,) deployment map (``Topology.cell_edge``)
    edge_capacity: optional (n_edges,) capacity tiers for the PoPs
    cloud_servers: float       M/M/c cloud queue size (inf = off)
    """
    end_b: np.ndarray
    edge_b: np.ndarray
    arrival_time: np.ndarray
    arrival_cell: np.ndarray
    arrival_user: np.ndarray
    step_duration: float = 1.0
    member: Optional[np.ndarray] = None
    cell_edge: Optional[np.ndarray] = None
    edge_capacity: Optional[np.ndarray] = None
    cloud_servers: float = float("inf")

    @property
    def horizon(self) -> int:
        return self.end_b.shape[0]

    @property
    def cells(self) -> int:
        return self.end_b.shape[1]

    @property
    def users(self) -> int:
        return self.end_b.shape[2]

    def member_frames(self) -> np.ndarray:
        """(T, cells, N) membership mask (broadcast if recorded static)."""
        if self.member is None:
            return np.ones(self.end_b.shape, bool)
        m = np.asarray(self.member, bool)
        if m.ndim == 2:
            m = np.broadcast_to(m[None], self.end_b.shape)
        return m

    def active_frames(self) -> np.ndarray:
        """(T, cells, N) request mask: membership AND >= 1 arrival event
        binned into that step."""
        arr = arrivals_from_timestamps(
            self.arrival_time, self.arrival_cell, self.arrival_user,
            self.horizon, self.cells, self.users, self.step_duration)
        return self.member_frames() & arr

    def topology(self, device=None) -> Optional[topology.Topology]:
        """The recorded deployment map as a ``Topology`` (None if the
        trace has no ``cell_edge``)."""
        if self.cell_edge is None:
            return None
        cap = self.edge_capacity if self.edge_capacity is not None else \
            np.ones(int(np.max(self.cell_edge)) + 1, np.float32)
        return topology.Topology(
            torch.tensor(np.asarray(self.cell_edge), dtype=torch.int32,
                         device=device),
            torch.tensor(np.asarray(cap), dtype=torch.float32,
                         device=device),
            float(self.cloud_servers))

    def validate(self) -> "FleetTrace":
        T, cells, users = self.end_b.shape
        if self.edge_b.shape != (T, cells):
            raise ValueError(f"edge_b shape {self.edge_b.shape} != "
                             f"{(T, cells)}")
        e = len(self.arrival_time)
        if len(self.arrival_cell) != e or len(self.arrival_user) != e:
            raise ValueError("arrival_time/cell/user lengths differ")
        if e:
            ac = np.asarray(self.arrival_cell)
            au = np.asarray(self.arrival_user)
            if ac.min() < 0 or ac.max() >= cells:
                raise ValueError(
                    f"arrival_cell out of range [0, {cells}): "
                    f"[{ac.min()}, {ac.max()}] — a negative index would "
                    "silently attribute events to the wrong cell")
            if au.min() < 0 or au.max() >= users:
                raise ValueError(f"arrival_user out of range [0, {users}): "
                                 f"[{au.min()}, {au.max()}]")
        if self.member is not None and \
                np.asarray(self.member).shape not in ((T, cells, users),
                                                      (cells, users)):
            raise ValueError(f"member shape {np.asarray(self.member).shape}"
                             f" fits neither {(T, cells, users)} nor "
                             f"{(cells, users)}")
        if self.cell_edge is not None:
            ce = np.asarray(self.cell_edge)
            if ce.shape != (cells,):
                raise ValueError(f"cell_edge shape {ce.shape} != {(cells,)}")
            n_edges = int(ce.max()) + 1 if len(ce) else 0
            if self.edge_capacity is not None and \
                    len(self.edge_capacity) < n_edges:
                raise ValueError("edge_capacity shorter than the deployment "
                                 "map's edge count")
        return self


_TRACE_OPTIONAL = ("member", "cell_edge", "edge_capacity")


def save_trace(path, trace: FleetTrace) -> None:
    """Write a ``FleetTrace`` as an ``.npz`` (the format ``load_trace``
    and the reference's ``load_trace`` read)."""
    trace.validate()
    arrays = dict(end_b=trace.end_b, edge_b=trace.edge_b,
                  arrival_time=trace.arrival_time,
                  arrival_cell=trace.arrival_cell,
                  arrival_user=trace.arrival_user,
                  step_duration=np.float64(trace.step_duration),
                  cloud_servers=np.float64(trace.cloud_servers))
    for name in _TRACE_OPTIONAL:
        v = getattr(trace, name)
        if v is not None:
            arrays[name] = np.asarray(v)
    np.savez(path, **arrays)


def load_trace(path) -> FleetTrace:
    """Read a trace ``.npz`` written by ``save_trace``."""
    with np.load(path) as z:
        kw = {name: z[name] for name in _TRACE_OPTIONAL if name in z.files}
        return FleetTrace(end_b=z["end_b"], edge_b=z["edge_b"],
                          arrival_time=z["arrival_time"],
                          arrival_cell=z["arrival_cell"],
                          arrival_user=z["arrival_user"],
                          step_duration=float(z["step_duration"]),
                          cloud_servers=float(z["cloud_servers"]),
                          **kw).validate()


class TraceSource:
    """`ScenarioSource` that replays a recorded `FleetTrace`. Frames live
    on ``device``; ``step`` picks frame ``(t + 1) % horizon`` (the trace
    wraps) and consumes no draws. The recorded deployment map rides on
    ``FleetScenario.topo``."""

    state_is_scenario = True

    def __init__(self, trace: FleetTrace, device=None):
        trace.validate()
        self.trace = trace
        self.device = resolve_device(device)
        dev = self.device
        self._end_b = torch.tensor(trace.end_b, dtype=torch.int32,
                                   device=dev)
        self._edge_b = torch.tensor(trace.edge_b, dtype=torch.int32,
                                    device=dev)
        self._member = torch.tensor(trace.member_frames(), device=dev)
        self._active = torch.tensor(trace.active_frames(), device=dev)
        self._topo = trace.topology(dev)

    @classmethod
    def load(cls, path, device=None) -> "TraceSource":
        return cls(load_trace(path), device=device)

    @property
    def cells(self) -> int:
        return self.trace.cells

    @property
    def users(self) -> int:
        return self.trace.users

    @property
    def horizon(self) -> int:
        return self.trace.horizon

    @property
    def dynamic(self) -> bool:
        return self.trace.horizon > 1

    def _frame(self, t: int) -> FleetScenario:
        i = t % self.horizon
        return FleetScenario(self._end_b[i], self._edge_b[i],
                             self._member[i], self._active[i], t,
                             self._topo)

    def reset(self, draws):
        scen = self._frame(0)
        return scen, scen

    def step(self, draws, state):
        scen = self._frame(state.t + 1)
        return scen, scen


def make_env_step(source, threshold: float = 0.0, noise: float = 0.02):
    """Per-step fleet environment transition over any `ScenarioSource`:
    ``env_step(draws, scen, per_user) -> (scen2, counts, mean_ms,
    mean_acc, reward)``."""
    from repro_torch.fleet.population import simulate_responses
    require_scenario_state(source)

    def env_step(draws, scen, per_user):
        mean_ms, acc, counts = simulate_responses(draws, scen, per_user,
                                                  noise)
        r = dynamics.reward(mean_ms, acc, threshold)
        scen2, _ = source.step(draws, scen)
        return scen2, counts, mean_ms, acc, r

    return env_step


# ---------------------------------------------------------------------------
# FleetPolicy — one policy surface
# ---------------------------------------------------------------------------


@runtime_checkable
class FleetPolicy(Protocol):
    """One decision surface over both fleet agents. ``decisions``
    returns ``((cells, N) per-user action ids, (cells,) joint ids)``;
    ``expected`` the noise-free ``((cells,) mean ms, mean acc)`` of the
    greedy decision under nominal load."""

    @property
    def accuracy_threshold(self) -> float: ...

    def decisions(self, counts, scen: FleetScenario): ...

    def expected(self, scen: Optional[FleetScenario] = None, counts=None): ...


class StatelessPolicy:
    """Shared base of the policies that carry no learned state: the
    candidate action table (which doubles as the oracle set), the QoS
    threshold, the protocol pad-width guard, and the ``decisions``-derived
    half of the `FleetPolicy` surface. Subclasses implement
    ``decisions``."""

    def __init__(self, users: int, actions: Optional[np.ndarray] = None,
                 threshold: float = 0.0):
        self.spec = SpaceSpec(users)
        acts = np.asarray(actions) if actions is not None else \
            default_actions(self.spec)
        #: (K, N) per-user ids of the candidates, on the CPU; each call
        #: moves it to the routed scenario's device
        self.pu_table = torch.tensor(self.spec.decode_actions_batch(acts))
        self._threshold = float(threshold)

    @property
    def accuracy_threshold(self) -> float:
        return self._threshold

    def _check(self, scen: FleetScenario) -> None:
        check_pad_width(self.spec.n_users, scen, type(self).__name__)

    def _ids(self, dec) -> torch.Tensor:
        ids = self.spec.encode_actions_batch(dec.cpu().numpy())
        return torch.tensor(ids, device=dec.device)

    def decisions(self, counts, scen: FleetScenario):
        raise NotImplementedError

    def expected(self, scen: Optional[FleetScenario] = None, counts=None):
        if scen is None:
            raise ValueError(f"{type(self).__name__} has no attached "
                             "scenario; pass scen=")
        per_user = self.decisions(counts, scen)[0]
        ms, acc = nominal_expected_response(scen, per_user)
        return ms.cpu().numpy(), acc.cpu().numpy()


class OraclePolicy(StatelessPolicy):
    """The per-cell brute force behind the `FleetPolicy` protocol.
    Stateless w.r.t. job counts (it optimizes the nominal-load expected
    response over the candidate set), so ``counts`` is ignored. A
    scenario with a topology needs the coupled best-response oracle,
    which ``fleet_bruteforce`` does not port yet (it raises)."""

    def decisions(self, counts, scen: FleetScenario):
        self._check(scen)
        pu = self.pu_table.to(scen.device)
        _, idx = fleet_bruteforce(scen, pu, self._threshold)
        dec = pu[idx.long()]
        return dec, self._ids(dec)


class StaticPolicy(StatelessPolicy):
    """The paper's fixed strategies (§6.1) as a `FleetPolicy`: every
    user runs ``'device'`` (local d0), ``'edge'``, or ``'cloud'`` — or
    any explicit per-user action id."""

    STRATEGIES = {"device": 0, "edge": dynamics.A_EDGE,
                  "cloud": dynamics.A_CLOUD}

    def __init__(self, users: int, strategy: Union[str, int] = "edge",
                 threshold: float = 0.0):
        super().__init__(users, threshold=threshold)
        self.action = (self.STRATEGIES[strategy]
                       if isinstance(strategy, str) else int(strategy))

    def decisions(self, counts, scen: FleetScenario):
        self._check(scen)
        dec = torch.full((scen.cells, scen.users), self.action,
                         dtype=torch.int32, device=scen.device)
        return dec, self._ids(dec)


# ---------------------------------------------------------------------------
# route-to-serving
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServedRequest:
    """One request dispatched to a serving engine."""
    cell: int
    user: int
    action: int                 # routed per-user action id (0..9)
    tier: str                   # 'S' | 'E' | 'C'
    variant: str                # model variant actually served (e.g. 'd4')
    predicted_ms: float         # latency model's per-user prediction
    measured_ms: float          # engine batch wall-clock (ms, emulated)
    queue_ms: float = 0.0       # submit -> batch-drain wait (ms)
    deadline_ms: float = float("inf")   # SLO stamped at submit
    deadline_met: Optional[bool] = None  # scored at drain: e2e <= deadline

    @property
    def e2e_ms(self) -> float:
        """Measured end-to-end latency: queueing + engine compute — what
        the SLO deadline is scored against."""
        return self.queue_ms + self.measured_ms


@dataclasses.dataclass
class RouteResult:
    """A routing decision plus, with a dispatch, its real-serving outcome
    (paper Table 8: predicted vs measured response, at fleet scale)."""
    decisions: torch.Tensor     # (cells, N) per-user action ids
    ids: torch.Tensor           # (cells,) joint action ids
    served: List[ServedRequest] = dataclasses.field(default_factory=list)
    batches: int = 0            # engine batches drained
    edge_util: Optional[torch.Tensor] = None   # (n_edges,) jobs/capacity
    #: dispatch wall-time decomposition from ``FleetOrchestrator.
    #: _dispatch`` (None when nothing was dispatched)
    timings: Optional[dict] = None
    #: utilization fraction above which an edge counts as hot
    hot_edge_util: float = 1.0
    #: the device-side latency accumulator (``obs.metrics`` is not
    #: ported yet, so always None and ``slo()`` has no ``hist_ms``)
    lat_acc: Optional[object] = None

    @property
    def predicted_ms(self) -> np.ndarray:
        return np.asarray([r.predicted_ms for r in self.served])

    @property
    def measured_ms(self) -> np.ndarray:
        return np.asarray([r.measured_ms for r in self.served])

    @property
    def gap_x(self) -> float:
        """measured / predicted mean-latency ratio (1.0 = the latency
        model predicts real serving perfectly; the paper's Table-8 gap)."""
        p = self.predicted_ms
        return float(self.measured_ms.mean() / max(p.mean(), 1e-9)) \
            if len(p) else float("nan")

    @property
    def hot_edges(self) -> Optional[List[int]]:
        """Edges whose utilization is at or above ``hot_edge_util``.
        None without edge_util."""
        if self.edge_util is None:
            return None
        util = self.edge_util.cpu().numpy()
        return [int(i) for i in np.nonzero(util >= self.hot_edge_util)[0]]

    def gap_breakdown(self) -> Optional[dict]:
        """Decompose ``gap_x`` (None without a dispatch). Two exact
        decompositions: per request ``queueing + compute == e2e``, and
        of the dispatch wall ``batching + compute + dispatch == total``
        (``batching`` the prompt-build/submit loop, ``compute`` the raw
        host wall of the engine calls, ``dispatch`` the residual). Per
        (tier, variant): request/batch counts, queueing delay, raw vs
        emulated engine wall, and the tier's own gap_x."""
        if self.timings is None or not self.served:
            return None
        t = self.timings
        p = float(self.predicted_ms.mean())
        m = float(self.measured_ms.mean())
        q = float(np.mean([r.queue_ms for r in self.served]))
        denom = max(p, 1e-9)
        per = {}
        for key, tv in t["per_tier_variant"].items():
            rs = [r for r in self.served
                  if f"{r.tier}/{r.variant}" == key]
            pm = float(np.mean([r.predicted_ms for r in rs]))
            mm = float(np.mean([r.measured_ms for r in rs]))
            per[key] = dict(tv, predicted_mean_ms=pm, measured_mean_ms=mm,
                            gap_x=mm / max(pm, 1e-9))
        return {
            "gap_x": self.gap_x,
            "per_request_ms": {"predicted": p, "queueing": q,
                               "compute": m, "e2e": q + m},
            "gap_components_x": {"queueing": q / denom,
                                 "compute": m / denom,
                                 "e2e": (q + m) / denom},
            "wall_ms": {"total": t["wall_ms"],
                        "batching": t["batching_ms"],
                        "compute": t["compute_ms"],
                        "dispatch": t["dispatch_ms"]},
            "per_tier_variant": per,
        }

    def slo(self) -> Optional[dict]:
        """Deadline attainment + latency quantiles (None w/o dispatch).

        Measured vs predicted attainment, overall and per (tier,
        variant), each an exact complement split (``attained + violated
        == dispatched`` at every granularity); ``attainment_gap`` =
        predicted - measured. Quantiles are the exact order statistics
        of the measured e2e and of the predicted latencies (the
        histogram source ``hist_ms`` waits for the accumulator)."""
        if not self.served:
            return None
        deadline = float(max(r.deadline_ms for r in self.served))
        e2e = np.asarray([r.e2e_ms for r in self.served])
        meas_att = sum(bool(r.deadline_met) for r in self.served)
        pred_att, pred_vio = timeline.attainment(
            [r.predicted_ms for r in self.served], deadline)
        n = len(self.served)
        per = {}
        for r in self.served:
            tv = per.setdefault(f"{r.tier}/{r.variant}", {
                "dispatched": 0, "measured_attained": 0,
                "measured_violated": 0, "predicted_attained": 0,
                "predicted_violated": 0})
            tv["dispatched"] += 1
            tv["measured_attained" if r.deadline_met
               else "measured_violated"] += 1
            tv["predicted_attained" if r.predicted_ms <= r.deadline_ms
               else "predicted_violated"] += 1
        for tv in per.values():
            tv["attainment_measured"] = \
                tv["measured_attained"] / tv["dispatched"]
            tv["attainment_predicted"] = \
                tv["predicted_attained"] / tv["dispatched"]
        meas_frac = meas_att / n
        pred_frac = pred_att / n
        return {
            "deadline_ms": deadline,
            "requests": n,
            "measured": {"attained": meas_att, "violated": n - meas_att,
                         "attainment": meas_frac},
            "predicted": {"attained": pred_att, "violated": pred_vio,
                          "attainment": pred_frac},
            "attainment_gap": pred_frac - meas_frac,
            "per_tier_variant": per,
            "quantiles": {
                "exact_ms": timeline.exact_quantiles(e2e),
                "predicted_exact_ms": timeline.exact_quantiles(
                    self.predicted_ms)},
        }

    def summary(self) -> dict:
        s = {"requests": len(self.served), "batches": self.batches,
             "predicted_mean_ms": float(self.predicted_ms.mean())
             if self.served else None,
             "measured_mean_ms": float(self.measured_ms.mean())
             if self.served else None,
             "gap_x": self.gap_x}
        if self.edge_util is not None:
            s["hot_edges"] = self.hot_edges
            s["hot_edge_util"] = self.hot_edge_util
        breakdown = self.gap_breakdown()
        if breakdown is not None:
            s["gap_breakdown"] = breakdown
        slo = self.slo()
        if slo is not None:
            s["slo"] = slo
        return s


def _tier_variant(a: int, local_variants) -> Tuple[str, str]:
    """Map a per-user action id to the serving (tier, variant): 0..7 run
    locally on the nearest available device-tier variant (ladder gaps
    snap), 8/9 offload to the edge/cloud d0 (the paper's setting)."""
    if a == dynamics.A_EDGE:
        return "E", "d0"
    if a == dynamics.A_CLOUD:
        return "C", "d0"
    if not local_variants:
        raise KeyError("no device-tier ('S') engines were provided for a "
                       f"local decision d{a}")
    v = min(local_variants, key=lambda x: abs(x - a))
    return "S", f"d{v}"


class FleetOrchestrator:
    """Runtime front door for a fleet: one vectorized greedy pass routes
    every cell, and — given serving engines — dispatches the routed
    requests to real batched inference. Accepts any `FleetPolicy`."""

    def __init__(self, policy):
        self.policy = policy

    # ------------------------------------------------------------------
    def _predicted_per_user_ms(self, dec, scen: FleetScenario):
        """(cells, N) latency-model predictions for a routed decision
        under the current request mask (inactive users predict 0)."""
        if scen.topo is None:
            return dynamics.response_times(dec, scen.end_b, scen.edge_b,
                                           active=scen.active,
                                           calib=scen.calib)
        return topology.topology_response_times(dec, scen.end_b, scen.edge_b,
                                                scen.topo, active=scen.active,
                                                calib=scen.calib)

    def _dispatch(self, dec, scen: FleetScenario, engines,
                  prompts: Optional[Callable], max_new_tokens: int,
                  batch_size: int, prompt_len: int, seed: int,
                  deadline_ms: float = float("inf")):
        """Drain every active user's routed request through per-(tier,
        variant) ``RequestBatcher``s into ``engines``, one engine at a
        time. Returns (served sorted by (cell, user), batches,
        timings)."""
        from repro_torch.serving import Request, RequestBatcher
        t0 = time.perf_counter()
        dec_np = dec.cpu().numpy()
        active = scen.active.cpu().numpy()
        pred = self._predicted_per_user_ms(dec, scen).cpu().numpy()
        local = sorted(int(v[1:]) for v in engines.get("S", {}))
        any_tier = next(iter(engines.values()), {})
        any_eng = next(iter(any_tier.values()), None)
        if any_eng is None:
            raise ValueError("dispatch= needs a non-empty "
                             "{tier: {variant: ServingEngine}} dict "
                             "(see repro_torch.launch.serve.build_engines)")
        vocab = int(any_eng.model.cfg.vocab_size)
        rng = np.random.default_rng(seed)
        batchers, meta = {}, {}
        for rid, (c, u) in enumerate(zip(*np.nonzero(active))):
            a = int(dec_np[c, u])
            tier, variant = _tier_variant(a, local)
            if tier not in engines or variant not in engines[tier]:
                raise KeyError(
                    f"no engine for tier {tier!r} variant {variant!r}; "
                    "build_engines(...) must cover the routed decisions")
            p = (np.asarray(prompts(int(c), int(u)), np.int32)
                 if prompts is not None
                 else rng.integers(0, vocab, prompt_len).astype(np.int32))
            meta[rid] = (int(c), int(u), a, tier, variant)
            batchers.setdefault((tier, variant),
                                RequestBatcher(batch_size)).submit(
                Request(rid, p, max_new_tokens=max_new_tokens,
                        user=int(u), deadline_ms=deadline_ms))
        t_build = time.perf_counter()
        served, batches, compute_s = [], 0, 0.0
        per_tv = {}
        for (tier, variant), batcher in batchers.items():
            eng = engines[tier][variant]
            tv = per_tv.setdefault(f"{tier}/{variant}", {
                "requests": 0, "batches": 0, "compute_ms": 0.0,
                "emulated_ms": 0.0, "queue_ms": []})
            while True:
                done = eng.serve(batcher)
                if not done:
                    break
                batches += 1
                tv["batches"] += 1
                # serve_time is per BATCH (every request in `done`
                # carries the same stamp): count it once
                compute_s += done[0].serve_time
                tv["compute_ms"] += done[0].serve_time * 1e3
                tv["emulated_ms"] += done[0].response_time * 1e3
                for r in done:
                    c, u, a, t_, v_ = meta[r.rid]
                    q_ms = float(r.queue_time * 1e3)
                    tv["requests"] += 1
                    tv["queue_ms"].append(q_ms)
                    served.append(ServedRequest(
                        c, u, a, t_, v_, float(pred[c, u]),
                        float(r.response_time * 1e3), queue_ms=q_ms,
                        deadline_ms=r.deadline_ms,
                        deadline_met=r.deadline_met))
        wall_ms = (time.perf_counter() - t0) * 1e3
        batching_ms = (t_build - t0) * 1e3
        compute_ms = compute_s * 1e3
        for tv in per_tv.values():
            q = tv.pop("queue_ms")
            tv["queue_ms_mean"] = float(np.mean(q)) if q else 0.0
        # batching and compute are disjoint sub-intervals of the dispatch
        # wall on one monotonic clock, so the residual is >= 0 and the
        # three components sum to wall_ms exactly
        timings = {"wall_ms": wall_ms, "batching_ms": batching_ms,
                   "compute_ms": compute_ms,
                   "dispatch_ms": wall_ms - batching_ms - compute_ms,
                   "per_tier_variant": per_tv}
        served.sort(key=lambda s: (s.cell, s.user))
        return served, batches, timings

    # ------------------------------------------------------------------
    def route(self, scen: Optional[FleetScenario] = None, counts=None,
              with_edge_util: bool = False, dispatch=None,
              prompts: Optional[Callable] = None, max_new_tokens: int = 4,
              batch_size: int = 8, prompt_len: int = 12, seed: int = 0,
              hot_edge_util: float = 1.0, as_result: bool = False,
              deadline_ms: Optional[float] = None):
        """Route the whole fleet in one greedy pass.

        Without ``dispatch``: ``(decisions, ids)``, plus ``(n_edges,)``
        utilization with ``with_edge_util=True``, or a `RouteResult`
        with ``as_result=True``. A held-out ``scen`` without ``counts``
        is routed cold (zero job counts); pad-width / cell-count
        mismatches raise the policies' shared protocol errors.

        ``dispatch={tier: {variant: ServingEngine}}`` drains the routed
        decisions of every ACTIVE user into the engines through
        per-(tier, variant) ``RequestBatcher``s of ``batch_size`` and
        returns a `RouteResult`: measured batch wall-times next to the
        latency model's per-user predictions. Prompts are ``prompt_len``
        random tokens from ``seed`` (or ``prompts(cell, user) -> int32
        tokens``), each request generating ``max_new_tokens``.
        ``deadline_ms`` is the SLO budget stamped on every request
        (default: the scenario QoS target ``dynamics.MAX_RESPONSE_MS``);
        ``hot_edge_util`` the utilization at or above which an edge
        lands in ``RouteResult.hot_edges``."""
        policy = self.policy
        if scen is None:
            scen = getattr(policy, "scen", None)
            if scen is None:
                raise ValueError(
                    f"{type(policy).__name__} has no attached scenario; "
                    "pass scen=")
            if counts is None:
                counts = getattr(policy, "counts", None)
        if counts is None:
            counts = torch.zeros((scen.cells, 2), dtype=torch.int32,
                                 device=scen.device)
        decide = getattr(policy, "decisions", None) or policy.policy_decisions
        dec, ids = decide(counts, scen)
        util = None
        if with_edge_util:
            topo = (scen.topo if scen.topo is not None
                    else topology.identity_topology(scen.cells,
                                                    device=scen.device))
            util = topology.edge_utilization(dec, topo, active=scen.active)
        if dispatch is not None:
            slo_ms = dynamics.MAX_RESPONSE_MS if deadline_ms is None \
                else float(deadline_ms)
            served, batches, timings = self._dispatch(
                dec, scen, dispatch, prompts, max_new_tokens, batch_size,
                prompt_len, seed, deadline_ms=slo_ms)
            return RouteResult(decisions=dec, ids=ids, served=served,
                               batches=batches, edge_util=util,
                               timings=timings, hot_edge_util=hot_edge_util)
        if as_result:
            return RouteResult(decisions=dec, ids=ids, edge_util=util,
                               hot_edge_util=hot_edge_util)
        if with_edge_util:
            return dec, ids, util
        return dec, ids
