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
  predicted-vs-measured methodology at fleet scale). ``bridge=`` drains
  them through the asynchronous ``serving.bridge.ServingBridge`` instead,
  the tiers' engines overlapped; ``spans=`` records the route as
  Chrome-trace spans; ``RouteResult.lat_acc`` is the latency accumulator
  behind ``slo()["quantiles"]["hist_ms"]``.
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
                                          fleet_bruteforce, gather_cells,
                                          nominal_expected_response)
from repro_torch.fleet.scenarios import (FleetConfig, FleetScenario,
                                         arrivals_from_timestamps,
                                         init_fleet, step_fleet)
from repro_torch.obs import timeline
from repro_torch.obs.metrics import MetricDef, MetricsAccumulator
from repro_torch.obs.spans import span as _span
from repro_torch.rng import as_draws

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
    is.

    With a ``mesh`` (``fleet.shard.fleet_mesh``) ``reset`` draws the
    whole fleet and keeps this rank's block of cells, and ``step``
    advances the block (every per-cell draw taken for the whole fleet
    and cut to the block), so the stream's values are the unsharded
    ones."""

    state_is_scenario = True

    def __init__(self, cfg: FleetConfig,
                 scen: Optional[FleetScenario] = None, mesh=None):
        self.cfg = cfg
        self._scen0 = scen
        self.mesh = mesh

    def attach_mesh(self, mesh) -> None:
        """Adopt the agent's fleet mesh (no-op when None)."""
        if mesh is not None:
            self.mesh = mesh

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
        if self.mesh is not None:
            from repro_torch.fleet import shard
            scen = shard.shard_scenario(scen, self.mesh)
        return scen, scen

    def step(self, draws, state):
        scen = step_fleet(draws, state, self.cfg)
        if self.mesh is not None:
            from repro_torch.fleet import shard
            scen = shard.constrain_scenario(scen, self.mesh)
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
    ``FleetScenario.topo``. With a ``mesh`` each rank keeps its block of
    cells of every frame (axis 1 of the ``(T, cells, ...)`` stacks)."""

    state_is_scenario = True

    def __init__(self, trace: FleetTrace, device=None, mesh=None):
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
        self.mesh = None
        self._placed = None
        self.attach_mesh(mesh)

    def attach_mesh(self, mesh) -> None:
        """Keep this rank's block of cells of the frames (no-op when
        ``mesh`` is None or the cells do not split over its ranks)."""
        if mesh is None:
            return
        from repro_torch.fleet import shard
        self.mesh = mesh
        if self._placed is not None or not mesh.splits(self.cells):
            return
        self._placed = mesh
        self._end_b, self._edge_b, self._member, self._active = (
            shard.shard_array(x, mesh, axis=1) for x in
            (self._end_b, self._edge_b, self._member, self._active))
        self._topo = shard.shard_topology(self._topo, mesh)

    @classmethod
    def load(cls, path, device=None, mesh=None) -> "TraceSource":
        return cls(load_trace(path), device=device, mesh=mesh)

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
                             self._topo, mesh=self._placed)

    def reset(self, draws):
        scen = self._frame(0)
        return scen, scen

    def step(self, draws, state):
        scen = self._frame(state.t + 1)
        return scen, scen


def record_trace(source, draws, steps: int,
                 step_duration: float = 1.0) -> FleetTrace:
    """Run any `ScenarioSource` for ``steps`` steps and record the stream
    as a `FleetTrace` (``draws``: a ``Draws``, or an int seed for one on
    the default device), so ``TraceSource(record_trace(src, draws, n))``
    replays the exact scenario frames. Arrivals are stamped mid-bin
    (``(t + 0.5) * step_duration``) so the timestamp binning round-trips
    exactly; the first frame's topology is recorded as the deployment map
    (a mid-trace edge failure is not representable in the static map)."""
    draws = as_draws(draws)
    end_b, edge_b, member, active = [], [], [], []
    scen, state = source.reset(draws)
    topo = scen.topo
    for _ in range(steps):
        for frames, x in ((end_b, scen.end_b), (edge_b, scen.edge_b),
                          (member, scen.member), (active, scen.active)):
            frames.append(x.cpu().numpy())
        scen, state = source.step(draws, state)
    t_idx, c_idx, u_idx = np.nonzero(np.stack(active))
    return FleetTrace(
        end_b=np.stack(end_b).astype(np.int32),
        edge_b=np.stack(edge_b).astype(np.int32),
        arrival_time=(t_idx + 0.5) * step_duration,
        arrival_cell=c_idx.astype(np.int32),
        arrival_user=u_idx.astype(np.int32),
        step_duration=step_duration,
        member=np.stack(member),
        **_deployment_fields(topo),
    )


def _deployment_fields(topo) -> dict:
    if topo is None:
        return {}
    return dict(cell_edge=topo.cell_edge.cpu().numpy().astype(np.int32),
                edge_capacity=topo.edge_capacity.cpu().numpy().astype(
                    np.float32),
                cloud_servers=float(topo.cloud_servers))


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

    def policy_decisions(self, counts, scen: FleetScenario):
        """FleetOrchestrator's legacy entry point, same contract."""
        return self.decisions(counts, scen)

    def expected(self, scen: Optional[FleetScenario] = None, counts=None):
        if scen is None:
            raise ValueError(f"{type(self).__name__} has no attached "
                             "scenario; pass scen=")
        per_user = self.decisions(counts, scen)[0]
        ms, acc = nominal_expected_response(scen, per_user)
        return ms.cpu().numpy(), acc.cpu().numpy()


class OraclePolicy(StatelessPolicy):
    """The per-cell brute force — or, with an attached topology, the
    coupled best-response oracle — behind the `FleetPolicy` protocol.
    Stateless w.r.t. job counts (it optimizes the nominal-load expected
    response over the candidate set), so ``counts`` is ignored."""

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
    #: the generated tokens (port-only: the reference keeps none)
    tokens: Optional[tuple] = None

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
    #: latency accumulator fed the measured per-request e2e stream
    #: during dispatch (histogram source of ``slo()``'s quantiles; None
    #: when nothing was dispatched)
    lat_acc: Optional[MetricsAccumulator] = None
    #: async-bridge outcome (``ServingBridge.stats()`` + per-shed request
    #: detail); None on the synchronous dispatch path
    bridge: Optional[dict] = None

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
        predicted - measured. Quantiles from two sources that must
        agree: ``exact_ms``, the exact order statistics of the measured
        e2e (the values of the ``request.e2e`` spans), and ``hist_ms``,
        from the ``lat_acc`` histogram, within one ``bin_width`` unless
        ``clipped`` flags out-of-range tails."""
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
        quantiles = {
            "exact_ms": timeline.exact_quantiles(e2e),
            "predicted_exact_ms": timeline.exact_quantiles(
                self.predicted_ms),
        }
        if self.lat_acc is not None:
            quantiles["hist_ms"] = self.lat_acc.quantiles("e2e_ms",
                                                          warn=False)
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
            "quantiles": quantiles,
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
        if self.bridge is not None:
            s["bridge"] = self.bridge
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
    requests to real batched inference. Accepts any `FleetPolicy`.

    ``mesh`` (default: the policy's own fleet mesh, if any) places a
    whole routed scenario and its job counts on the mesh before the
    greedy pass, so a sharded fleet is routed where its cells live; the
    decisions come back assembled whole on every rank, equal to the
    unsharded route's."""

    def __init__(self, policy, mesh=None):
        self.policy = policy
        self.mesh = mesh if mesh is not None else getattr(policy, "mesh",
                                                          None)

    @property
    def agent(self):
        """Pre-redesign attribute name for the routed policy."""
        return self.policy

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

    @staticmethod
    def _requests(dec, active, engines, prompts: Optional[Callable],
                  prompt_len: int, seed: int):
        """Every active user's routed request, in (cell, user) order:
        ``(cell, user, action, tier, variant, prompt tokens)``, from the
        whole fleet's decisions ``dec`` and request mask ``active``.
        Prompts are ``prompt_len`` random tokens from ``seed`` unless
        ``prompts(cell, user)`` gives them."""
        local = sorted(int(v[1:]) for v in engines.get("S", {}))
        any_tier = next(iter(engines.values()), {})
        any_eng = next(iter(any_tier.values()), None)
        if any_eng is None:
            raise ValueError("dispatch= needs a non-empty "
                             "{tier: {variant: ServingEngine}} dict "
                             "(see repro_torch.launch.serve.build_engines)")
        vocab = int(any_eng.model.cfg.vocab_size)
        rng = np.random.default_rng(seed)
        dec_np = dec.cpu().numpy()
        out = []
        for c, u in zip(*np.nonzero(active.cpu().numpy())):
            a = int(dec_np[c, u])
            tier, variant = _tier_variant(a, local)
            if tier not in engines or variant not in engines[tier]:
                raise KeyError(
                    f"no engine for tier {tier!r} variant {variant!r}; "
                    "build_engines(...) must cover the routed decisions")
            p = (np.asarray(prompts(int(c), int(u)), np.int32)
                 if prompts is not None
                 else rng.integers(0, vocab, prompt_len).astype(np.int32))
            out.append((int(c), int(u), a, tier, variant, p))
        return out

    def _whole(self, dec, scen: FleetScenario, whole):
        """(predictions (cells, N) as numpy, request mask) of the whole
        fleet: ``whole``, the sharded route's assembled pair, or computed
        from the unsharded ``scen``."""
        if whole is not None:
            return whole[0].cpu().numpy(), whole[1]
        return self._predicted_per_user_ms(dec, scen).cpu().numpy(), \
            scen.active

    def _dispatch(self, dec, scen: FleetScenario, engines,
                  prompts: Optional[Callable], max_new_tokens: int,
                  batch_size: int, prompt_len: int, seed: int, spans=None,
                  deadline_ms: float = float("inf"), whole=None):
        """Drain every active user's routed request through per-(tier,
        variant) ``RequestBatcher``s into ``engines``, one engine at a
        time. ``whole`` is a sharded route's (predictions, request mask),
        each assembled whole. Returns (served sorted by (cell, user),
        batches, timings, latency accumulator)."""
        from repro_torch.serving import Request, RequestBatcher
        t0 = time.perf_counter()
        pred, active = self._whole(dec, scen, whole)
        batchers, meta = {}, {}
        with _span(spans, "dispatch.batch_build"):
            reqs = self._requests(dec, active, engines, prompts, prompt_len,
                                  seed)
            for rid, (c, u, a, tier, variant, p) in enumerate(reqs):
                meta[rid] = (c, u, a, tier, variant)
                batchers.setdefault((tier, variant),
                                    RequestBatcher(batch_size)).submit(
                    Request(rid, p, max_new_tokens=max_new_tokens,
                            user=u, deadline_ms=deadline_ms))
        t_build = time.perf_counter()
        served, batches, compute_s = [], 0, 0.0
        slo_attained = slo_violated = 0
        per_tv = {}
        for (tier, variant), batcher in batchers.items():
            eng = engines[tier][variant]
            key = f"{tier}/{variant}"
            tv = _tier_entry(per_tv, key)
            with _span(spans, f"dispatch.drain.{key}",
                       queued=len(batcher.queue)):
                while True:
                    done = eng.serve(batcher, spans=spans)
                    if not done:
                        break
                    batches += 1
                    # serve_time is per BATCH (every request in `done`
                    # carries the same stamp): count it once
                    compute_s += done[0].serve_time
                    _add_batch(tv, done[0].serve_time,
                               done[0].response_time)
                    for r in done:
                        met = _collect(served, per_tv, r, tier, variant,
                                       meta[r.rid][:3], pred, spans)
                        slo_attained += met
                        slo_violated += not met
                    # running per-batch SLO attainment counter track
                    _slo_counter(spans, slo_attained, slo_violated)
        wall_ms = (time.perf_counter() - t0) * 1e3
        # batching and compute are disjoint sub-intervals of the dispatch
        # wall on one monotonic clock, so the residual is >= 0 and the
        # three components sum to wall_ms exactly
        timings = _timings(wall_ms, (t_build - t0) * 1e3, compute_s * 1e3,
                           per_tv)
        served.sort(key=lambda s: (s.cell, s.user))
        return served, batches, timings, _latency_acc(served, deadline_ms,
                                                      scen.device)

    def _dispatch_bridge(self, dec, scen: FleetScenario, engines, bridge,
                         prompts: Optional[Callable], max_new_tokens: int,
                         batch_size: int, prompt_len: int, seed: int,
                         spans=None, deadline_ms: float = float("inf"),
                         whole=None):
        """Async twin of ``_dispatch``: submit every active request into
        a ``ServingBridge`` (per-(tier, variant) worker queues, see
        ``repro_torch.serving.bridge``) and drain the fleet with the
        S/E/C engines overlapped.

        Identities preserved: per request ``queueing + compute == e2e``
        and the wall decomposition ``batching + compute + dispatch ==
        total`` still hold exactly — but ``compute_ms`` sums engine
        walls that ran CONCURRENTLY, so the residual ``dispatch_ms``
        may be negative (overlap won back). Requests the bridge shed
        are NOT in ``served``; they surface with reasons (and their
        cell, user and action) in the returned bridge stats, and the
        SLO identity attained + violated == dispatched holds over the
        served set.
        """
        from repro_torch.serving import Request
        from repro_torch.serving.bridge import BridgeConfig, ServingBridge
        t0 = time.perf_counter()
        pred, active = self._whole(dec, scen, whole)
        if isinstance(bridge, ServingBridge):
            br, own = bridge, False
        else:
            cfg = bridge if isinstance(bridge, BridgeConfig) \
                else BridgeConfig(max_batch=batch_size)
            br, own = ServingBridge(engines, cfg, spans=spans), True
        # reused bridges accumulate across calls: slice this call's
        # results/batches off the tail for per-call accounting, and
        # offset rids so the bridge's terminal-once set (keyed by rid)
        # never mistakes this call's requests for a prior call's
        n0, b0 = len(br.results), len(br.batch_log)
        rid0 = br.submitted
        meta = {}
        try:
            with _span(spans, "dispatch.batch_build"):
                reqs = self._requests(dec, active, engines, prompts,
                                      prompt_len, seed)
                for i, (c, u, a, tier, variant, p) in enumerate(reqs):
                    rid = rid0 + i
                    meta[rid] = (c, u, a, tier, variant)
                    br.submit(Request(rid, p, max_new_tokens=max_new_tokens,
                                      user=u, deadline_ms=deadline_ms),
                              tier, variant)
            t_build = time.perf_counter()
            br.drain()
        finally:
            if own:
                br.stop()
        stats = br.stats()
        served = []
        slo_attained = slo_violated = 0
        per_tv = {}
        compute_s = 0.0
        batch_log = br.batch_log[b0:]
        for b in batch_log:
            compute_s += b["serve_time"]
            _add_batch(_tier_entry(per_tv, b["key"]), b["serve_time"],
                       b["response_time"])
        # a rerouted request is counted under the tier that served it
        for r, tier, variant in br.results[n0:]:
            met = _collect(served, per_tv, r, tier, variant,
                           meta[r.rid][:3], pred, spans)
            slo_attained += met
            slo_violated += not met
        if slo_attained or slo_violated:
            _slo_counter(spans, slo_attained, slo_violated)
        wall_ms = (time.perf_counter() - t0) * 1e3
        batching_ms = (t_build - t0) * 1e3
        compute_ms = compute_s * 1e3
        # the three components still sum to wall_ms exactly, but
        # compute_ms adds up engine walls that OVERLAPPED across the
        # bridge's worker threads, so the residual can be negative
        timings = _timings(wall_ms, batching_ms, compute_ms, per_tv)
        served.sort(key=lambda s: (s.cell, s.user))
        lat = _latency_acc(served, deadline_ms, scen.device)
        # enrich shed reports with the routed (cell, user) so summary()
        # accounts for every submitted request
        for sr in stats["shed_requests"]:
            if sr["rid"] in meta:
                c, u, a, _t, _v = meta[sr["rid"]]
                sr["cell"], sr["user"], sr["action"] = c, u, a
        stats["overlap_x"] = compute_ms / max(wall_ms - batching_ms, 1e-9)
        return served, len(batch_log), timings, lat, stats

    # ------------------------------------------------------------------
    def route(self, scen: Optional[FleetScenario] = None, counts=None,
              with_edge_util: bool = False, dispatch=None,
              prompts: Optional[Callable] = None, max_new_tokens: int = 4,
              batch_size: int = 8, prompt_len: int = 12, seed: int = 0,
              spans=None, hot_edge_util: float = 1.0,
              as_result: bool = False,
              deadline_ms: Optional[float] = None, bridge=None):
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
        lands in ``RouteResult.hot_edges``.

        ``spans`` (a ``repro_torch.obs.spans.SpanRecorder``) records
        route.decide / route.edge_util / route.dispatch / dispatch.* /
        engine.* spans — plus, when dispatching, per-request
        ``request.e2e`` intervals and a running ``slo.attainment``
        counter. With spans, route.decide waits for the decision on the
        current stream so that its span covers the device work.

        ``bridge`` switches the dispatch to the async serving bridge
        (``repro_torch.serving.bridge``): ``True`` builds a per-call
        ``ServingBridge`` with ``max_batch=batch_size``; a
        ``BridgeConfig`` customizes admission/overflow/timeout
        behaviour; an existing ``ServingBridge`` reuses its queues.
        ``RouteResult.bridge`` then carries the shed/reroute accounting
        and ``overlap_x`` (engine compute over the post-submit wall).

        On a sharded fleet the decisions, the predictions and the
        request mask are assembled whole on every rank, and the first
        rank alone dispatches them, as the reference's one controller
        does: the engines (and any ``ServingBridge``) passed on the other
        ranks are not called. Every rank returns the first rank's
        served requests, batches, timings and bridge stats, so the
        served requests, their batches and their tokens equal an
        unsharded route's on the same engines; only the walls differ."""
        policy = self.policy
        if scen is None:
            scen = getattr(policy, "scen", None)
            if scen is None:
                raise ValueError(
                    f"{type(policy).__name__} has no attached scenario; "
                    "pass scen=")
            if counts is None:
                counts = getattr(policy, "counts", None)
        if self.mesh is not None and scen.mesh is None:
            from repro_torch.fleet import shard
            placed = shard.shard_scenario(scen, self.mesh)
            if counts is not None and placed is not scen:
                counts = shard.shard_array(counts, self.mesh)
            scen = placed
        if counts is None:
            counts = torch.zeros((scen.cells, 2), dtype=torch.int32,
                                 device=scen.device)
        decide = getattr(policy, "decisions", None) or policy.policy_decisions
        with _span(spans, "route.decide", cells=int(scen.cells)):
            dec, ids = decide(counts, scen)
            if spans is not None and dec.is_cuda:
                torch.cuda.current_stream(dec.device).synchronize()
        util = None
        if with_edge_util:
            with _span(spans, "route.edge_util"):
                topo = (scen.topo if scen.topo is not None
                        else topology.identity_topology(scen.cells,
                                                        device=scen.device))
                util = topology.edge_utilization(dec, topo,
                                                 active=scen.active)
                if scen.topo is None and scen.mesh is not None:
                    util = gather_cells(util, scen)
        whole = None
        if dispatch is not None and scen.mesh is not None:
            # the prediction on this rank's block, then both it and the
            # request mask assembled whole, as the decisions are below
            whole = (gather_cells(self._predicted_per_user_ms(dec, scen),
                                  scen),
                     gather_cells(scen.active, scen))
        dec, ids = gather_cells(dec, scen), gather_cells(ids, scen)
        if dispatch is not None:
            slo_ms = dynamics.MAX_RESPONSE_MS if deadline_ms is None \
                else float(deadline_ms)
            brinfo = None
            with _span(spans, "route.dispatch"):
                run = None
                if scen.mesh is None or scen.mesh.rank == 0:
                    if bridge is not None and bridge is not False:
                        run = lambda: self._dispatch_bridge(  # noqa: E731
                            dec, scen, dispatch, bridge, prompts,
                            max_new_tokens, batch_size, prompt_len, seed,
                            spans=spans, deadline_ms=slo_ms, whole=whole)
                    else:
                        run = lambda: self._dispatch(  # noqa: E731
                            dec, scen, dispatch, prompts, max_new_tokens,
                            batch_size, prompt_len, seed, spans=spans,
                            deadline_ms=slo_ms, whole=whole) + (None,)
                served, batches, timings, lat, brinfo = _first_rank(
                    run, scen.mesh)
                if lat is None:
                    lat = _latency_acc(served, slo_ms, scen.device)
            return RouteResult(decisions=dec, ids=ids, served=served,
                               batches=batches, edge_util=util,
                               timings=timings, hot_edge_util=hot_edge_util,
                               lat_acc=lat, bridge=brinfo)
        if as_result:
            return RouteResult(decisions=dec, ids=ids, edge_util=util,
                               hot_edge_util=hot_edge_util)
        if with_edge_util:
            return dec, ids, util
        return dec, ids


def _first_rank(run, mesh):
    """``run()`` on the mesh's first rank (or without a mesh), as (served,
    batches, timings, latency accumulator, bridge stats); every other
    rank receives the first four but the accumulator, which it rebuilds
    from the served list (None in its place). An exception on the first
    rank is raised on every rank."""
    if mesh is None or mesh.size == 1:
        return run()
    import torch.distributed as dist
    box = [None]
    if mesh.rank == 0:
        try:
            out = run()
            box[0] = ("ok", out[:3] + (out[4],))
        except Exception as e:  # noqa: BLE001 - raised on every rank
            box[0] = ("error", e)
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast_object_list(box, src=src, group=mesh.group)
    kind, got = box[0]
    if kind == "error":
        raise got
    if mesh.rank == 0:
        return out
    served, batches, timings, brinfo = got
    return served, batches, timings, None, brinfo


def _tier_entry(per_tv: dict, key: str) -> dict:
    """The running per-(tier, variant) dispatch accounting of ``key``."""
    return per_tv.setdefault(key, {"requests": 0, "batches": 0,
                                   "compute_ms": 0.0, "emulated_ms": 0.0,
                                   "queue_ms": []})


def _add_batch(tv: dict, serve_s: float, response_s: float) -> None:
    """Count one served batch in its (tier, variant)'s accounting."""
    tv["batches"] += 1
    tv["compute_ms"] += serve_s * 1e3
    tv["emulated_ms"] += response_s * 1e3


def _collect(served: list, per_tv: dict, r, tier: str, variant: str,
             cua, pred, spans) -> bool:
    """Record one served request ``r`` of routed ``cua`` = (cell, user,
    action), served by ``tier``/``variant``: its ``ServedRequest``, its
    queueing in that queue's accounting and, with spans, its
    retrospective ``request.e2e`` interval (submit -> drain + emulated
    compute), whose duration reproduces ``ServedRequest.e2e_ms``.
    Returns whether it met its deadline."""
    c, u, a = cua
    tv = _tier_entry(per_tv, f"{tier}/{variant}")
    q_ms = float(r.queue_time * 1e3)
    tv["requests"] += 1
    tv["queue_ms"].append(q_ms)
    served.append(ServedRequest(
        c, u, a, tier, variant, float(pred[c, u]),
        float(r.response_time * 1e3), queue_ms=q_ms,
        deadline_ms=r.deadline_ms, deadline_met=r.deadline_met,
        tokens=None if r.output is None else
        tuple(int(t) for t in np.asarray(r.output).reshape(-1))))
    if spans is not None:
        spans.complete("request.e2e", r.arrival_time,
                       r.queue_time + r.response_time, rid=r.rid,
                       tier=tier, variant=variant,
                       deadline_met=bool(r.deadline_met))
    return bool(r.deadline_met)


def _slo_counter(spans, attained: int, violated: int) -> None:
    """The running ``slo.attainment`` counter track (with spans only)."""
    if spans is not None:
        spans.counter("slo.attainment", attained=attained,
                      violated=violated,
                      attainment=attained / max(attained + violated, 1))


def _timings(wall_ms: float, batching_ms: float, compute_ms: float,
             per_tv: dict) -> dict:
    """The dispatch wall decomposition ``batching + compute + dispatch
    == wall`` (``dispatch`` the residual), with each (tier, variant)'s
    mean queueing delay in place of its list."""
    for tv in per_tv.values():
        q = tv.pop("queue_ms")
        tv["queue_ms_mean"] = float(np.mean(q)) if q else 0.0
    return {"wall_ms": wall_ms, "batching_ms": batching_ms,
            "compute_ms": compute_ms,
            "dispatch_ms": wall_ms - batching_ms - compute_ms,
            "per_tier_variant": per_tv}


def _latency_acc(served, deadline_ms: float, device) -> MetricsAccumulator:
    """The route's e2e latency accumulator: 64 bins over ``[0, max(4 x
    deadline, 1)]`` ms, fed the served requests' measured e2e. Built
    after the timed wall so that it cannot perturb the wall
    decomposition."""
    hi = 4.0 * deadline_ms if np.isfinite(deadline_ms) \
        else 4.0 * dynamics.MAX_RESPONSE_MS
    lat = MetricsAccumulator.create(
        {"e2e_ms": MetricDef(lo=0.0, hi=max(hi, 1.0), bins=64)},
        device=device)
    if served:
        lat.update({"e2e_ms": np.asarray([r.e2e_ms for r in served],
                                         np.float32)})
    return lat
