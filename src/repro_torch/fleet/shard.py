"""Sharded fleet execution: the cell population over a 1-D
``torch.distributed`` mesh — the port of ``repro/fleet/shard.py``.

The reference runs one controller over a ``jax.sharding.Mesh`` and lets
XLA's partitioner split each jitted step. The port runs the same data
parallelism as SPMD over processes: each rank of a ``torch.distributed``
group owns one contiguous block of cells, runs every per-cell step on
its own block (the fused K1 / K2 ops included), and every cross-cell
term is an explicit collective. The sharded fleet stays bit-identical
to the unsharded one because only two collectives are used, each
exactly:

* **integer totals** — the per-edge job counts and the fleet's cloud
  count (``topology.fleet_total``), and the metrics' histogram
  increments — are ``all_reduce(SUM)``-ed directly;
* **a float quantity that crosses shards** (the holdout ratio's sums,
  the per-step fleet means, a replay mini-batch, the coupled oracle's
  tables) is assembled whole first (``gather_array``: each rank writes
  its block into a zero-filled buffer and one ``all_reduce(SUM)`` over
  the bit patterns assembles it) and then reduced exactly as the
  unsharded code reduces it;
* **draws**: every rank draws the whole fleet's values at each per-cell
  site from the same seeded ``Draws`` and keeps its block
  (``rng.BlockDraws``, through ``scenarios.cell_draws``).

Placement follows the reference's: ``shard_scenario`` / ``shard_array``
/ ``shard_replay`` keep this rank's block of every per-cell leaf (the
spec from ``distributed.sharding``'s ``cells`` / ``edges`` rules, so a
dimension the mesh does not divide stays whole — replicated — on every
rank); ``t``, the edge capacities, the cloud queue size and any
calibration are replicated. A placed ``FleetScenario`` / ``Topology``
carries its mesh, which is how the topology path, the metrics and the
agents know to reduce. A one-rank mesh places nothing and behaves
exactly as ``mesh=None``.

Cross-shard topologies, as in the reference: (a) the locality-capped
generator (``topology.random_topology(..., shard_local=True)``) keeps
every edge's cells inside one rank's block, so ``local_contention``
aggregates on the rank (one scalar all-reduce for the cloud queue);
(b) any assignment goes through ``topology.shared_contention``, whose
per-edge totals are all-reduced.

The mesh lives on the card unless the caller passes ``device="cpu"``
(a ``gloo`` group). NCCL across cards; two ``gloo`` ranks may share one
card (NCCL refuses that).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake

from repro_torch import resolve_device
from repro_torch.distributed import sharding
from repro_torch.fleet import dynamics, topology
from repro_torch.fleet.replay import FleetReplay
from repro_torch.fleet.scenarios import FleetScenario
from repro_torch.fleet.topology import Topology, shard_blocks

__all__ = [
    "FLEET_AXIS", "FleetMesh", "fleet_mesh", "fleet_spec", "shard_array",
    "constrain_array", "replicate", "gather_array", "shard_topology",
    "shard_scenario", "constrain_scenario", "shard_replay",
    "local_contention", "local_expected_response", "check_shard_local",
]

#: the one mesh axis of fleet data parallelism (see
#: ``distributed.sharding.RULES['cells'/'edges']``)
FLEET_AXIS = "fleet"

#: the integer type of each element width, for sums over bit patterns
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class FleetMesh:
    """A 1-D ``('fleet',)`` mesh: the ranks of a ``torch.distributed``
    group (default: the whole initialized group), each with its tensors
    on ``device``. ``shape`` and ``axis_names`` are what the sharding
    rules read."""

    axis_names = (FLEET_AXIS,)

    def __init__(self, group=None, device=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a fleet mesh spans the ranks of a torch.distributed "
                "group: call torch.distributed.init_process_group first")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        backend = dist.get_backend(group)
        if self.device.type == "cpu" and backend != "gloo":
            raise ValueError(f"a CPU fleet mesh needs a gloo group, not "
                             f"{backend!r}")

    @property
    def shape(self) -> dict:
        return {FLEET_AXIS: self.size}

    def __repr__(self):
        return (f"FleetMesh(size={self.size}, rank={self.rank}, "
                f"device={self.device})")

    def splits(self, n: int) -> bool:
        """Does an axis of ``n`` split into blocks over the ranks?"""
        return self.size > 1 and n % self.size == 0

    def block(self, n: int):
        """``(start, length)`` of this rank's block of an ``n`` axis."""
        k = n // self.size
        return self.rank * k, k

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """THE collective of the fleet mesh: ``x`` summed over the ranks,
        in place. Both NCCL and gloo run it on CUDA tensors."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (an integer total) summed over the ranks, in place."""
        if self.size == 1 or is_fake(x):
            return x
        return self._all_reduce(x)

    def sum_bits(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks by its bit patterns, where at most one
        rank holds a nonzero pattern at each position: the values (signed
        zeros and NaNs too) come back exactly. Bool tensors are summed as
        bytes."""
        if self.size == 1 or is_fake(x):
            return x
        if x.dtype == torch.bool:
            return self._all_reduce(x.to(torch.uint8)).bool()
        bits = _BITS[x.element_size()]
        if x.dtype == bits:
            return self._all_reduce(x.contiguous())
        return self._all_reduce(x.contiguous().view(bits)).view(x.dtype)

    def gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The whole array from each rank's block of ``x`` along
        ``axis``: every rank writes its block into a zero-filled buffer
        and one all-reduce over the bit patterns assembles it, exactly."""
        if self.size == 1:
            return x
        shape = list(x.shape)
        lo, k = shape[axis] * self.rank, shape[axis]
        shape[axis] *= self.size
        buf = x.new_zeros(shape)
        buf.narrow(axis, lo, k).copy_(x)
        return self.sum_bits(buf)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of the group's first rank, in place on every rank."""
        src = 0 if self.group is None else dist.get_global_rank(self.group,
                                                                0)
        dist.broadcast(x, src=src, group=self.group)
        return x


def fleet_mesh(group=None, device=None) -> FleetMesh:
    """A 1-D ``('fleet',)`` mesh over the initialized group (or
    ``group``), its tensors on ``device`` (``cuda`` unless the caller
    asks for the CPU)."""
    return FleetMesh(group, device)


def fleet_spec(mesh, shape, axis: int = 0, logical: str = "cells"):
    """``PartitionSpec`` sharding dimension ``axis`` of ``shape`` along
    the fleet axis, through the logical-axis rule table (a dimension the
    mesh does not divide stays replicated)."""
    axes = (None,) * axis + (logical,) + (None,) * (len(shape) - axis - 1)
    return sharding.spec_for(shape, axes, mesh)


def _splits(x: torch.Tensor, mesh, axis: int, logical: str) -> bool:
    return (mesh is not None and mesh.size > 1
            and fleet_spec(mesh, x.shape, axis, logical)[axis] is not None)


def shard_array(x, mesh, axis: int = 0, logical: str = "cells"):
    """This rank's block of ``x`` along ``axis`` (a copy of its own);
    ``x`` itself when ``mesh`` is None or the axis stays replicated."""
    if not _splits(x, mesh, axis, logical):
        return x
    lo, k = mesh.block(x.shape[axis])
    return x.narrow(axis, lo, k).clone(memory_format=torch.contiguous_format)


def constrain_array(x, mesh, axis: int = 0, logical: str = "cells"):
    """The reference's in-jit layout constraint. SPMD ranks already hold
    their blocks, so a placed array is returned as it is."""
    return x


def gather_array(x: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """The whole array from each rank's block of ``x`` along ``axis``
    (``FleetMesh.gather``); ``x`` itself without a mesh."""
    return x if mesh is None else mesh.gather(x, axis)


def _tensors(tree):
    """The tensor leaves of nested dicts, lists, tuples and
    dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(tree, mesh):
    """Replicated placement: every rank holds the same values. The
    tensors of ``tree`` are checked against the first rank's and a
    ValueError is raised on every rank if any differs (identity when
    ``mesh`` is None)."""
    if mesh is None or mesh.size == 1:
        return tree
    bad = 0
    for t in _tensors(tree):
        first = mesh.broadcast(t.detach().clone())
        bad += not torch.equal(_as_bits(first), _as_bits(t))
    flag = mesh.all_sum(torch.tensor(bad, device=mesh.device))
    if int(flag):
        raise ValueError(
            "replicated state differs across the fleet mesh's ranks: "
            "build it from the same seed on every rank")
    return tree


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool or t.dtype == _BITS[t.element_size()]:
        return t
    return t.contiguous().view(_BITS[t.element_size()])


def shard_topology(topo: Optional[Topology], mesh) -> Optional[Topology]:
    """``cell_edge`` rides with its cells; capacities and the cloud queue
    size replicate."""
    if topo is None or topo.mesh is not None:
        return topo
    ce = shard_array(topo.cell_edge, mesh)
    if ce is topo.cell_edge:
        return topo
    return Topology(ce, topo.edge_capacity, topo.cloud_servers, mesh)


def shard_scenario(s: FleetScenario, mesh) -> FleetScenario:
    """Keep this rank's block of every per-cell leaf of ``s`` (``t``,
    the topology's capacities and any calibration replicated); ``s``
    itself without a mesh, when it is placed already, or when its cells
    do not split over the ranks."""
    if mesh is None or s.mesh is not None or not mesh.splits(s.cells):
        return s
    return FleetScenario(
        shard_array(s.end_b, mesh), shard_array(s.edge_b, mesh),
        shard_array(s.member, mesh), shard_array(s.active, mesh), s.t,
        shard_topology(s.topo, mesh), s.calib, mesh)


def constrain_scenario(s: FleetScenario, mesh) -> FleetScenario:
    """What the sources apply to every emitted scenario: a whole
    scenario is placed, a placed one returned as it is."""
    return shard_scenario(s, mesh)


def shard_replay(buf: FleetReplay, mesh) -> FleetReplay:
    """Split an empty ``FleetReplay``'s rows evenly over the ranks.

    The split keeps each push on its rank: a ring whose capacity is a
    multiple of the fleet's cells takes every step's push in one window
    of ``cells`` consecutive slots, cell ``c`` at offset ``c``, so the
    rank owning cell ``c`` holds those slots (``replay.replay_push``
    requires that multiple). ``replay.replay_sample`` draws the same
    global slot indices as the unsharded ring and assembles the
    mini-batch whole on every rank, bit-equal to the unsharded ring's.
    """
    if mesh is None or buf.mesh is not None or not mesh.splits(buf.capacity):
        return buf
    if buf.ptr or buf.full:
        raise ValueError("shard_replay places an empty ring; this one "
                         "holds transitions")
    rows = buf.capacity // mesh.size
    return FleetReplay(s=buf.s[:rows].clone(), a=buf.a[:rows].clone(),
                       r=buf.r[:rows].clone(), s2=buf.s2[:rows].clone(),
                       mesh=mesh)


# ---------------------------------------------------------------------------
# shard-local topology aggregation
# ---------------------------------------------------------------------------


def check_shard_local(topo: Topology, mesh) -> None:
    """Raise (on every rank) unless ``topo`` satisfies the
    shard-locality invariant for ``mesh``: every cell's edge lies in the
    cell's own rank's block of edges. Skipped on FakeTensors, whose
    values are abstract."""
    if is_fake(topo.cell_edge):
        return
    n = mesh.size
    if topo.mesh is None:
        ok = topology.is_shard_local(topo, n)
    else:
        _, epb = shard_blocks(topo.cells * n, topo.n_edges, n)
        bad = ((topo.cell_edge.long() // epb) != mesh.rank).sum()
        ok = int(mesh.all_sum(bad)) == 0
    if not ok:
        raise ValueError(
            f"topology is not shard-local over {n} devices: at least one "
            "edge's cells span device blocks — generate it with "
            "random_topology(..., shard_local=True) or use the all-to-all "
            "path (topology.shared_contention) instead")


def local_contention(per_user, topo: Topology, mesh, active=None):
    """Shard-local twin of ``topology.shared_contention``: each rank
    sums its own cells' edge jobs into its own block of edges (local
    edge ids), with no cross-rank edge total; the one collective is the
    fleet's cloud count. Returns the same ``(n_edge_eff, n_cloud,
    cloud_mult)`` for this rank's cells, bit-identical to the global
    path (integer totals)."""
    check_shard_local(topo, mesh)
    n = mesh.size
    cells = topo.cells * n if topo.mesh is not None else topo.cells
    _, epb = shard_blocks(cells, topo.n_edges, n)
    lo = mesh.rank * epb if topo.mesh is not None else 0
    cap = topo.edge_capacity[lo:lo + epb] if topo.mesh is not None \
        else topo.edge_capacity
    at_edge = per_user == dynamics.A_EDGE
    at_cloud = per_user == dynamics.A_CLOUD
    if active is not None:
        at_edge = at_edge & active
        at_cloud = at_cloud & active
    e_cnt = at_edge.sum(-1)
    c_cnt = at_cloud.sum(-1)
    local = (topo.cell_edge.long() - lo) if topo.mesh is not None \
        else topo.cell_edge.long()
    edge_tot = torch.zeros(cap.shape[0], dtype=e_cnt.dtype,
                           device=e_cnt.device).index_add_(0, local, e_cnt)
    n_e_eff = edge_tot[local] / cap[local]
    tot_cloud = c_cnt.sum()
    if topo.mesh is not None:
        tot_cloud = mesh.all_sum(tot_cloud)
    mult = topology.cloud_load_multiplier(tot_cloud, topo.cloud_servers)
    return n_e_eff, c_cnt, mult


def local_expected_response(per_user, end_b, edge_b, topo: Topology, mesh,
                            active=None):
    """Shard-local twin of ``topology.topology_expected_response``: the
    same ``counts`` / ``cloud_mult`` seam into
    ``dynamics.expected_response``, with the edge totals kept on the
    rank by ``local_contention``."""
    n_e, n_c, mult = local_contention(per_user, topo, mesh, active=active)
    return dynamics.expected_response(per_user, end_b, edge_b,
                                      active=active, counts=(n_e, n_c),
                                      cloud_mult=mult)
