"""The fleet front door — the port of ``repro/fleet/api.py`` without the
serving half.

* ``ScenarioSource``: ``reset(draws) -> (FleetScenario, state)`` /
  ``step(draws, state) -> (FleetScenario, state)``. ``SyntheticSource``
  wraps the ``FleetConfig`` generators; ``TraceSource`` replays a
  recorded ``FleetTrace`` (the same ``.npz`` format as the reference's
  ``save_trace``).
* ``FleetPolicy``: ``decisions(counts, scen)`` / ``expected(scen,
  counts)``, the one surface over both fleet agents.
* ``FleetOrchestrator.route``: one greedy pass routes every cell and
  returns the decisions (``RouteResult`` carries the predicted side
  only; dispatch into serving engines is not ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fleet import dynamics, topology
from repro_torch.fleet.scenarios import (FleetConfig, FleetScenario,
                                         arrivals_from_timestamps,
                                         init_fleet, step_fleet)

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


@dataclasses.dataclass
class RouteResult:
    """A routing decision — the predicted side of the reference's
    ``RouteResult`` (no serving dispatch in the port yet)."""
    decisions: torch.Tensor     # (cells, N) per-user action ids
    ids: torch.Tensor           # (cells,) joint action ids
    edge_util: Optional[torch.Tensor] = None   # (n_edges,) jobs/capacity


class FleetOrchestrator:
    """Runtime front door for a fleet: one vectorized greedy pass routes
    every cell. Accepts any `FleetPolicy` (either fleet agent)."""

    def __init__(self, policy):
        self.policy = policy

    def route(self, scen: Optional[FleetScenario] = None, counts=None,
              with_edge_util: bool = False, as_result: bool = False):
        """Route the whole fleet in one greedy pass: ``(decisions,
        ids)``, plus ``(n_edges,)`` utilization with
        ``with_edge_util=True``, or a `RouteResult` with
        ``as_result=True``. A held-out ``scen`` without ``counts`` is
        routed cold (zero job counts); pad-width / cell-count
        mismatches raise the policies' shared protocol errors."""
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
        if as_result:
            return RouteResult(decisions=dec, ids=ids, edge_util=util)
        if with_edge_util:
            return dec, ids, util
        return dec, ids
