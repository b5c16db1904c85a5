"""Multi-edge-cell topologies: shared edge servers, cross-cell contention
and cloud queueing over the fleet batch — the port of
``repro/fleet/topology.py``.

A ``Topology`` holds the cell->edge assignment, per-edge capacity tiers
and an M/M/c-style cloud queue size. ``shared_contention`` sums edge
jobs over every cell sharing an edge (``index_add_`` in place of the
reference's segment sum) and feeds the ``counts`` / ``cloud_mult`` seam
of ``dynamics.response_times``. Under ``identity_topology`` the
effective counts equal the isolated per-cell counts and the multiplier
is exactly 1.0, so the topology path reduces to the isolated one.

A topology placed on a fleet mesh (``fleet.shard.shard_topology``)
holds its rank's block of ``cell_edge`` and carries the mesh: the
per-edge job totals and the fleet's cloud count, integer sums, are then
all-reduced over the ranks before each cell reads its own edge's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.spaces import A_CLOUD, A_EDGE
from repro_torch.fleet import dynamics

#: saturation ceiling of the M/M/c-style cloud queueing multiplier
CLOUD_QUEUE_MAX = 8.0


@dataclasses.dataclass
class Topology:
    """Edge/cloud infrastructure shared by the cells of a fleet.

    cell_edge     : (cells,)   int32  edge server serving each cell
    edge_capacity : (n_edges,) f32    capacity tier of each edge server
                                      (1.0 = the paper's a1.large edge)
    cloud_servers : float             cloud queue size; ``inf`` disables
                                      cross-cell cloud queueing
    mesh          : FleetMesh | None  the fleet mesh whose ranks each hold
                                      a block of ``cell_edge`` (None: the
                                      whole fleet is here)
    """
    cell_edge: torch.Tensor
    edge_capacity: torch.Tensor
    cloud_servers: float
    mesh: Optional[object] = None

    @property
    def cells(self) -> int:
        return self.cell_edge.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_capacity.shape[0]


def edge_capacities(n_edges: int, capacity_tiers=(1.0,),
                    device=None) -> torch.Tensor:
    """(n_edges,) capacities cycling through the tier tuple."""
    t = torch.tensor(capacity_tiers, dtype=torch.float32, device=device)
    return t[torch.arange(n_edges, device=device) % len(capacity_tiers)]


def identity_topology(cells: int, cloud_servers: float = math.inf,
                      device=None) -> Topology:
    """The 1:1 reduction: every cell owns a unit-capacity edge and the
    cloud queue is unbounded — exactly the isolated-cell model."""
    return Topology(torch.arange(cells, dtype=torch.int32, device=device),
                    torch.ones(cells, device=device), float(cloud_servers))


def shard_blocks(cells: int, n_edges: int, n_shards: int):
    """Validated block sizes ``(cells_per_shard, edges_per_shard)`` of a
    shard-local layout: the first ``cells_per_shard`` cells and the first
    ``edges_per_shard`` edges belong to shard 0, and so on — the
    contiguous blocks the ranks of a 1-D fleet mesh hold
    (``repro_torch.fleet.shard``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if cells % n_shards or n_edges % n_shards:
        raise ValueError(
            f"shard-local layout needs cells ({cells}) and n_edges "
            f"({n_edges}) divisible by n_shards ({n_shards}) so the "
            "contiguous device blocks line up")
    return cells // n_shards, n_edges // n_shards


def _world_size() -> int:
    """The ranks of the initialized ``torch.distributed`` group (1
    without one): the default shard count, as the reference defaults to
    its device count."""
    import torch.distributed as dist
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def random_topology(draws, cells: int, n_edges: int, capacity_tiers=(1.0,),
                    cloud_servers: float = math.inf,
                    shard_local: bool = False,
                    n_shards: Optional[int] = None) -> Topology:
    """Uniform cell->edge assignment (one ``randint`` draw at site
    ``"scenario.topology"``). ``shard_local=True`` splits cells and
    edges into ``n_shards`` (default: the ranks of the initialized
    group) contiguous equal blocks and draws each cell's edge within its
    own block, so no edge is shared across ranks
    (``fleet.shard.local_contention``)."""
    if not shard_local:
        ce = draws.randint("scenario.topology", (cells,), n_edges)
    else:
        n = _world_size() if n_shards is None else n_shards
        cpb, epb = shard_blocks(cells, n_edges, n)
        block = torch.arange(cells, device=draws.device) // cpb
        ce = block * epb + draws.randint("scenario.topology", (cells,), epb)
    return Topology(ce.to(torch.int32),
                    edge_capacities(n_edges, capacity_tiers, draws.device),
                    float(cloud_servers))


def is_shard_local(topo: Topology, n_shards: int) -> bool:
    """Host-side check of the shard-locality invariant on a whole
    topology: every cell's edge lies in the cell's own contiguous shard
    block."""
    cpb, epb = shard_blocks(topo.cells, topo.n_edges, n_shards)
    ce = topo.cell_edge.cpu().numpy()
    return bool(((np.arange(topo.cells) // cpb) == (ce // epb)).all())


def skewed_topology(draws, cells: int, n_edges: int, skew: float = 1.5,
                    capacity_tiers=(1.0,),
                    cloud_servers: float = math.inf) -> Topology:
    """Zipf-weighted assignment: edge j attracts cells with probability
    proportional to ``(j+1)^-skew`` (edge 0 is the hottest). The float32
    weights' cumulative sum is inverted at one uniform draw per cell (site
    ``"scenario.topology"``) as ``jax.random.choice`` inverts it: the
    first edge whose cumulative weight reaches ``cdf[-1] * (1 - u)``."""
    w = (1.0 / torch.arange(1, n_edges + 1, dtype=torch.float32,
                            device=draws.device)) ** skew
    cdf = torch.cumsum(w / w.sum(), 0)
    u = draws.uniform("scenario.topology", (cells,))
    ce = torch.searchsorted(cdf, cdf[-1] * (1 - u))
    return Topology(ce.to(torch.int32),
                    edge_capacities(n_edges, capacity_tiers, draws.device),
                    float(cloud_servers))


def hot_edge_topology(cells: int, n_edges: int, hot_fraction: float = 0.5,
                      capacity_tiers=(1.0,),
                      cloud_servers: float = math.inf,
                      device=None) -> Topology:
    """Deterministic hot edge: the first ``round(cells * hot_fraction)``
    cells share edge 0, the rest go round-robin over the other edges."""
    n_hot = int(round(cells * hot_fraction))
    rest = np.arange(cells - n_hot)
    cold = 1 + rest % (n_edges - 1) if n_edges > 1 else rest % n_edges
    ce = np.concatenate([np.zeros(n_hot, np.int32), cold.astype(np.int32)])
    return Topology(torch.tensor(ce, device=device),
                    edge_capacities(n_edges, capacity_tiers, device),
                    float(cloud_servers))


def step_edge_failures(draws, topo: Topology, p_fail: float) -> Topology:
    """One edge-failure event: with probability ``p_fail`` a uniformly
    drawn edge fails and each of its cells moves to a uniformly drawn
    other edge (permanently). A single-edge topology is unchanged."""
    if topo.n_edges <= 1:
        return topo
    fail = draws.bernoulli("scenario.edge_fail", p_fail, ())
    edge = draws.randint("scenario.edge_fail", (), topo.n_edges)
    new = draws.randint("scenario.edge_fail", topo.cell_edge.shape,
                        topo.n_edges - 1)
    new = (new + (new >= edge).to(new.dtype)).to(torch.int32)
    ce = torch.where(fail & (topo.cell_edge == edge), new, topo.cell_edge)
    return dataclasses.replace(topo, cell_edge=ce)


def fleet_total(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x``, an integer total over this rank's cells, summed over the
    ranks of ``mesh`` (as it is without one)."""
    return x if mesh is None else mesh.all_sum(x)


def _segment_totals(values, segments, n_segments: int,
                    mesh=None) -> torch.Tensor:
    """Per-segment sums (the reference's ``segment_sum``), over every
    rank's cells on a fleet mesh."""
    out = torch.zeros(n_segments, dtype=values.dtype, device=values.device)
    return fleet_total(out.index_add_(0, segments.long(), values), mesh)


def cloud_load_multiplier(n_cloud_total, cloud_servers):
    """M/M/c-style queueing inflation: ``rho = n_cloud_total /
    cloud_servers`` maps to ``1 / (1 - rho)`` clipped to ``[1,
    CLOUD_QUEUE_MAX]``; an infinite queue gives exactly 1.0. The queue
    size divides as a float32 tensor, so the card's quotient is the
    reference's (a Python divisor is multiplied by its reciprocal)."""
    n = torch.as_tensor(n_cloud_total).to(torch.float32)
    rho = n / torch.full_like(n, cloud_servers)
    m = 1.0 / torch.clamp(1.0 - rho, min=1.0 / CLOUD_QUEUE_MAX)
    return torch.clamp(m, 1.0, CLOUD_QUEUE_MAX)


def shared_contention(per_user, topo: Topology, active=None):
    """Topology-aware contention terms for a ``(cells, N)`` decision:
    ``(n_edge_eff (cells,), n_cloud (cells,), cloud_mult ())``."""
    at_edge = per_user == A_EDGE
    at_cloud = per_user == A_CLOUD
    if active is not None:
        at_edge = at_edge & active
        at_cloud = at_cloud & active
    e_cnt = at_edge.sum(-1)
    c_cnt = at_cloud.sum(-1)
    edge_tot = _segment_totals(e_cnt, topo.cell_edge, topo.n_edges,
                               topo.mesh)
    ce = topo.cell_edge.long()
    n_e_eff = edge_tot[ce] / topo.edge_capacity[ce]
    mult = cloud_load_multiplier(fleet_total(c_cnt.sum(), topo.mesh),
                                 topo.cloud_servers)
    return n_e_eff, c_cnt, mult


def topology_response_times(per_user, end_b, edge_b, topo: Topology,
                            active=None, calib=None):
    """Per-user response times (ms) under shared edge/cloud contention."""
    n_e, n_c, mult = shared_contention(per_user, topo, active=active)
    return dynamics.response_times(per_user, end_b, edge_b,
                                   counts=(n_e, n_c), active=active,
                                   cloud_mult=mult, calib=calib)


def topology_expected_response(per_user, end_b, edge_b, topo: Topology,
                               active=None, calib=None):
    """((cells,) mean ms, (cells,) mean accuracy) under shared
    contention."""
    n_e, n_c, mult = shared_contention(per_user, topo, active=active)
    return dynamics.expected_response(per_user, end_b, edge_b,
                                      active=active, counts=(n_e, n_c),
                                      cloud_mult=mult, calib=calib)


def fleet_topology_expected_response(per_user, end_b, edge_b,
                                     topo: Topology, active=None,
                                     calib=None):
    """Fleet entry point: every cell under shared contention."""
    return topology_expected_response(per_user, end_b, edge_b, topo,
                                      active=active, calib=calib)


def edge_utilization(per_user, topo: Topology, active=None):
    """(n_edges,) edge jobs per unit of capacity under ``per_user``."""
    at_edge = per_user == A_EDGE
    if active is not None:
        at_edge = at_edge & active
    edge_tot = _segment_totals(at_edge.sum(-1), topo.cell_edge,
                               topo.n_edges, topo.mesh)
    return edge_tot / topo.edge_capacity
