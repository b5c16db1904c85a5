"""Scenario generation for fleets of end-edge-cloud cells — the port of
``repro/fleet/scenarios.py``.

Markov-modulated links, Poisson arrivals with a diurnal curve, user
churn, heterogeneous cell sizes and multi-edge topologies, composed
behind ``init_fleet`` / ``step_fleet``; ``table5_fleet`` and
``mixed_table5_fleet`` build fleets from the paper's Table-5 patterns.
Every random draw goes through a ``repro_torch.rng.Draws`` at a named
``"scenario.*"`` site. A scenario placed on a fleet mesh
(``fleet.shard.shard_scenario``) holds its rank's block of cells and
carries the mesh; ``step_fleet`` then draws through ``cell_draws``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fleet.dynamics import EXPERIMENTS, Calibration
from repro_torch.fleet.topology import (Topology, hot_edge_topology,
                                        random_topology, skewed_topology,
                                        step_edge_failures)
from repro_torch.rng import BlockDraws, as_draws


def init_links(draws, shape, p_weak: float = 0.3, site="scenario.links"):
    """Initial link states: 1 (Weak) w.p. ``p_weak``, else 0 (Regular)."""
    return draws.bernoulli(site, p_weak, shape).to(torch.int32)


def step_links(draws, b, p_r2w: float = 0.05, p_w2r: float = 0.15,
               site="scenario.links"):
    """One Markov transition per link: Regular->Weak w.p. ``p_r2w``,
    Weak->Regular w.p. ``p_w2r``."""
    p = torch.where(b == 0, p_r2w, p_w2r)
    flip = draws.bernoulli(site, p, b.shape)
    return torch.where(flip, 1 - b, b).to(torch.int32)


def diurnal_rate(t, period: int = 1440, base: float = 1.0,
                 amplitude: float = 0.4, phase: float = 0.0) -> torch.Tensor:
    """Request-rate multiplier following a day-night sinusoid (``t`` is
    the step index), clamped at 0: a float32 0-dim tensor, computed in
    float32 as the reference computes it (its step index is an int32)."""
    t = torch.tensor(t, dtype=torch.int32)
    m = base + amplitude * torch.sin(2 * math.pi * (t / period + phase))
    return torch.clamp(m, min=0.0)


def poisson_active(draws, shape, rate):
    """Per-user request indicator for one step: True iff the user issued
    >= 1 request, i.e. w.p. ``1 - exp(-rate)``, computed in float32 (a
    float rate becomes a float32 tensor first, as in the reference)."""
    rate = torch.as_tensor(rate, dtype=torch.float32, device=draws.device)
    return draws.bernoulli("scenario.arrivals", 1.0 - torch.exp(-rate),
                           shape)


def arrivals_from_timestamps(times, cells_idx, users_idx, horizon: int,
                             cells: int, users: int,
                             step_duration: float = 1.0) -> np.ndarray:
    """Bin recorded request timestamps into per-step activity masks:
    event ``e`` lands in step ``floor(times[e] / step_duration)``;
    events outside ``[0, horizon)`` are dropped. Returns a
    ``(horizon, cells, users)`` bool array."""
    out = np.zeros((horizon, cells, users), bool)
    if len(np.asarray(times)) == 0:
        return out
    t = np.floor(np.asarray(times, np.float64)
                 / float(step_duration)).astype(np.int64)
    keep = (t >= 0) & (t < horizon)
    out[t[keep], np.asarray(cells_idx)[keep], np.asarray(users_idx)[keep]] \
        = True
    return out


def step_churn(draws, member, p_join: float = 0.02, p_leave: float = 0.02):
    """Users join/leave the cell as a two-state Markov chain."""
    p = torch.where(member, p_leave, p_join)
    flip = draws.bernoulli("scenario.churn", p, member.shape)
    return torch.where(flip, ~member, member)


def heterogeneous_sizes(draws, cells: int, max_users: int, min_users: int = 1,
                        width: Optional[int] = None):
    """Per-cell user counts in [min_users, max_users] and the matching
    padded (cells, width) membership mask."""
    sizes = draws.randint("scenario.sizes", (cells,), max_users + 1,
                          low=min_users)
    cols = torch.arange(width or max_users, device=sizes.device)
    return sizes, cols[None, :] < sizes[:, None]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for a generated fleet (see ``repro.fleet.scenarios``). All
    dynamics are optional: zero link rates keep links static,
    ``arrival_rate=None`` keeps every member active, zero churn keeps
    membership fixed and ``min_users == max_users`` keeps cells
    homogeneous."""
    cells: int
    users: int = 5
    p_weak0: float = 0.3
    p_r2w: float = 0.0
    p_w2r: float = 0.0
    arrival_rate: Optional[float] = None
    diurnal_period: int = 0
    diurnal_amplitude: float = 0.4
    p_join: float = 0.0
    p_leave: float = 0.0
    min_users: int = 5
    max_users: int = 5
    n_edges: Optional[int] = None
    assignment: str = "random"            # 'random' | 'skewed' | 'hot'
    skew: float = 1.5
    hot_fraction: float = 0.5
    capacity_tiers: Tuple[float, ...] = (1.0,)
    cloud_servers: float = float("inf")
    p_edge_fail: float = 0.0
    # cap the random assignment's locality to the blocks of an
    # n_shards-way fleet mesh (repro_torch.fleet.shard) so the per-edge
    # totals never cross ranks; None = the ranks of the initialized group
    shard_local: bool = False
    n_shards: Optional[int] = None


@dataclasses.dataclass
class FleetScenario:
    """Array-of-structs network/workload state for a whole fleet.

    end_b  : (cells, users) int32   per-end-node link state (0 R, 1 W)
    edge_b : (cells,)       int32   edge backhaul link state
    member : (cells, users) bool    user belongs to the cell
    active : (cells, users) bool    member AND issued a request this step
    t      : int                    step counter (drives diurnal curve)
    topo   : Topology | None        shared edge/cloud infrastructure
    calib  : Calibration | None     sim-to-real latency corrections
    mesh   : FleetMesh | None       the fleet mesh whose ranks each hold
                                    a block of the cells (None: the
                                    whole fleet is here)
    """
    end_b: torch.Tensor
    edge_b: torch.Tensor
    member: torch.Tensor
    active: torch.Tensor
    t: int
    topo: Optional[Topology] = None
    calib: Optional[Calibration] = None
    mesh: Optional[object] = None

    @property
    def cells(self) -> int:
        return self.end_b.shape[0]

    @property
    def users(self) -> int:
        return self.end_b.shape[1]

    @property
    def device(self) -> torch.device:
        return self.end_b.device


def make_topology(draws, cfg: FleetConfig) -> Optional[Topology]:
    """The ``Topology`` a ``FleetConfig`` describes (None when
    ``n_edges`` is unset — isolated cells)."""
    if cfg.n_edges is None:
        return None
    kw = dict(capacity_tiers=tuple(cfg.capacity_tiers),
              cloud_servers=cfg.cloud_servers)
    if cfg.shard_local and cfg.assignment != "random":
        raise ValueError(
            f"shard_local topologies are generated by the 'random' "
            f"assignment, not {cfg.assignment!r} (skewed/hot edges "
            "deliberately concentrate cells across blocks)")
    if cfg.shard_local and cfg.p_edge_fail:
        raise ValueError(
            "shard_local=True cannot be combined with p_edge_fail: "
            "step_edge_failures reroutes a failed edge's cells to ANY "
            "other edge, which breaks the shard-locality invariant "
            "local_contention relies on — use the all-to-all path for "
            "fleets with edge failures")
    if cfg.assignment == "random":
        return random_topology(draws, cfg.cells, cfg.n_edges,
                               shard_local=cfg.shard_local,
                               n_shards=cfg.n_shards, **kw)
    if cfg.assignment == "skewed":
        return skewed_topology(draws, cfg.cells, cfg.n_edges, skew=cfg.skew,
                               **kw)
    if cfg.assignment == "hot":
        return hot_edge_topology(cfg.cells, cfg.n_edges,
                                 hot_fraction=cfg.hot_fraction,
                                 device=draws.device, **kw)
    raise ValueError(f"unknown assignment {cfg.assignment!r} "
                     "(expected 'random', 'skewed', or 'hot')")


def with_topology(s: FleetScenario, topo: Optional[Topology]) -> \
        FleetScenario:
    """A copy of ``s`` with ``topo`` attached (or detached with None)."""
    return dataclasses.replace(s, topo=topo)


def _arrivals(draws, cfg: FleetConfig, shape, t: int):
    if cfg.arrival_rate is None:
        return torch.ones(shape, dtype=torch.bool, device=draws.device)
    rate = cfg.arrival_rate
    if cfg.diurnal_period:
        rate = rate * diurnal_rate(t, cfg.diurnal_period,
                                   amplitude=cfg.diurnal_amplitude)
    return poisson_active(draws, shape, rate)


def init_fleet(draws, cfg: FleetConfig) -> FleetScenario:
    """Seedable initial fleet state for ``cfg`` (``draws`` is a
    ``Draws`` or an int seed for one on the default device)."""
    draws = as_draws(draws)
    topo = make_topology(draws, cfg)
    end_b = init_links(draws, (cfg.cells, cfg.users), cfg.p_weak0)
    edge_b = init_links(draws, (cfg.cells,), cfg.p_weak0)
    hi = min(cfg.max_users, cfg.users)
    lo = min(cfg.min_users, hi)          # a cap below min_users wins
    if lo >= cfg.users:
        member = torch.ones((cfg.cells, cfg.users), dtype=torch.bool,
                            device=draws.device)
    else:
        _, member = heterogeneous_sizes(draws, cfg.cells, hi, min_users=lo,
                                        width=cfg.users)
    active = member & _arrivals(draws, cfg, member.shape, 0)
    return FleetScenario(end_b, edge_b, member, active, 0, topo)


def cell_draws(draws, scen: FleetScenario):
    """The draws for a step of ``scen``: on a sharded scenario, a
    ``BlockDraws`` that draws every per-cell site for the whole fleet and
    keeps this rank's block (``draws`` as given otherwise, or when it is
    one already)."""
    if scen.mesh is None or isinstance(draws, BlockDraws):
        return draws
    return BlockDraws(draws, scen.mesh.rank, scen.mesh.size, scen.cells)


def step_fleet(draws, s: FleetScenario, cfg: FleetConfig) -> FleetScenario:
    """Advance every cell's exogenous state by one step. With
    ``cfg.p_edge_fail`` and an attached topology, each step may fail one
    edge and reroute its cells."""
    draws = cell_draws(draws, s)
    topo = s.topo
    if cfg.p_edge_fail and topo is not None:
        topo = step_edge_failures(draws, topo, cfg.p_edge_fail)
    end_b, edge_b = s.end_b, s.edge_b
    if cfg.p_r2w or cfg.p_w2r:
        end_b = step_links(draws, end_b, cfg.p_r2w, cfg.p_w2r)
        edge_b = step_links(draws, edge_b, cfg.p_r2w, cfg.p_w2r)
    member = s.member
    if cfg.p_join or cfg.p_leave:
        member = step_churn(draws, member, cfg.p_join, cfg.p_leave)
    t = s.t + 1
    active = member & _arrivals(draws, cfg, member.shape, t)
    return FleetScenario(end_b, edge_b, member, active, t, topo, s.calib,
                         s.mesh)


def table5_fleet(name: str, cells: int, users: int = 5,
                 device=None) -> FleetScenario:
    """Replicate a paper Table-5 scenario (EXP-A..D) across ``cells``
    identical cells."""
    device = resolve_device(device)
    sc = EXPERIMENTS[name]
    if users > len(sc.end_b):
        raise ValueError("scenario must cover all users")
    end_b = torch.tensor(sc.end_b[:users], dtype=torch.int32,
                         device=device)[None, :].repeat(cells, 1)
    edge_b = torch.full((cells,), sc.edge_b, dtype=torch.int32,
                        device=device)
    member = torch.ones((cells, users), dtype=torch.bool, device=device)
    return FleetScenario(end_b, edge_b, member, member, 0)


def mixed_table5_fleet(draws, cells: int, users: int = 5,
                       min_users: Optional[int] = None,
                       max_users: Optional[int] = None) -> FleetScenario:
    """A fleet whose cells are drawn uniformly from the four Table-5
    scenarios (site ``"scenario.pick"``); ``min_users``/``max_users``
    also draw per-cell sizes in that range, padded to ``users``."""
    draws = as_draws(draws)
    names = list(EXPERIMENTS)
    if users > min(len(EXPERIMENTS[n].end_b) for n in names):
        raise ValueError("scenario must cover all users")
    pick = draws.randint("scenario.pick", (cells,), len(names))
    ends = torch.tensor([EXPERIMENTS[n].end_b[:users] for n in names],
                        dtype=torch.int32, device=draws.device)
    edges = torch.tensor([EXPERIMENTS[n].edge_b for n in names],
                         dtype=torch.int32, device=draws.device)
    if min_users is None and max_users is None:
        member = torch.ones((cells, users), dtype=torch.bool,
                            device=draws.device)
    else:
        hi = min(max_users if max_users is not None else users, users)
        lo = min(min_users if min_users is not None else 1, hi)
        _, member = heterogeneous_sizes(draws, cells, hi, min_users=lo,
                                        width=users)
    return FleetScenario(ends[pick], edges[pick], member, member, 0)
