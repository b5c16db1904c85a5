"""The calibrated end-edge-cloud latency/accuracy model (paper §3, §5) as
pure functions of tensors — the port of ``repro/fleet/dynamics.py``
without its ``xp=`` seam: the port is torch-only, with numpy for the
constants.

  response_times(per_user, end_b, edge_b)    (..., N) -> (..., N) ms
  accuracies(per_user)                       (..., N) -> (..., N) top-5 %
  expected_response(per_user, end_b, edge_b) (..., N) -> ((...,), (...,))

Every function broadcasts over leading batch dimensions and computes with
the reference's operation order: in float32 by default, so it agrees with
the jnp path to the last few ulp, or in float64 (``dtype=torch.float64``),
the type the reference's single-cell environment computes in with numpy,
so that it agrees with that path bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.edge_ladder import MOBILENET_TABLE4

# Per-user action ids of ``core.spaces``, kept as literals so that this
# module never imports ``repro_torch.core`` (``core.env`` wraps this
# model, and a core import from here would close an import cycle).
A_EDGE, A_CLOUD = 8, 9

# ---- model ladder metadata (paper Table 4) --------------------------------
MACS = np.array([m for _, m, _, _, _ in MOBILENET_TABLE4], np.float64)
IS_INT8 = np.array([dt == "int8" for _, _, dt, _, _ in MOBILENET_TABLE4])
TOP5 = np.array([t5 for _, _, _, _, t5 in MOBILENET_TABLE4], np.float64)
TOP1 = np.array([t1 for _, _, _, t1, _ in MOBILENET_TABLE4], np.float64)

# ---- calibrated constants (ms) --------------------------------------------
A_FP32, B_FP32 = 50.8, 0.7175          # ms, ms/MMAC
A_INT8, B_INT8 = 37.3, 0.326
TIER_SPEED = {"S": 1.0, "E": 2.0, "C": 4.0}   # vCPUs 1/2/4 (Table 6)
TIER_CORES = {"E": 2.0, "C": 4.0}
T_ORCH = {0: 21.4, 1: 141.0}           # B regular/weak (Table 12 totals)
T_UP_EDGE = {0: 120.0, 1: 280.0}       # image upload device->edge
T_HOP_CLOUD = {0: 108.0, 1: 230.0}     # edge->cloud hop
EDGE_LINK_CAP = 1.3
CLOUD_LINK_CAP = 2.4
MEM_BUSY_PENALTY = 1.15
EDGE_MEM_BUSY_AT = 2                   # > jobs at edge -> memory pressure
CLOUD_MEM_BUSY_AT = 3
MAX_RESPONSE_MS = 2500.0               # reward floor (constraint violation)

# array forms of the B-indexed constants, for vectorized indexing
T_ORCH_MS = np.array([T_ORCH[0], T_ORCH[1]], np.float64)
T_UP_EDGE_MS = np.array([T_UP_EDGE[0], T_UP_EDGE[1]], np.float64)
T_HOP_CLOUD_MS = np.array([T_HOP_CLOUD[0], T_HOP_CLOUD[1]], np.float64)


@dataclasses.dataclass
class Scenario:
    """Network-condition scenario (paper Table 5): 0=Regular, 1=Weak."""
    name: str
    end_b: Tuple[int, ...]
    edge_b: int

    @staticmethod
    def from_string(name: str, pattern: str):
        """pattern like 'RWRWR|W' (5 end-nodes | edge)."""
        ends, edge = pattern.split("|")
        conv = {"R": 0, "W": 1}
        return Scenario(name, tuple(conv[c] for c in ends), conv[edge])


# paper Table 5
EXPERIMENTS = {
    "EXP-A": Scenario.from_string("EXP-A", "RRRRR|R"),
    "EXP-B": Scenario.from_string("EXP-B", "RWRWR|W"),
    "EXP-C": Scenario.from_string("EXP-C", "WWWRR|R"),
    "EXP-D": Scenario.from_string("EXP-D", "WWWWW|W"),
}


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype = torch.float32) -> dict:
    """The constant tables in ``dtype`` on ``device``, built once per
    (device, dtype) (a host-to-device copy inside the loop would stall the
    stream)."""
    typed = functools.partial(torch.tensor, dtype=dtype)
    macs = typed(MACS)
    t_comp = torch.where(torch.tensor(IS_INT8), A_INT8 + B_INT8 * macs,
                         A_FP32 + B_FP32 * macs)
    tabs = {"t_orch": typed(T_ORCH_MS), "t_up_edge": typed(T_UP_EDGE_MS),
            "t_hop_cloud": typed(T_HOP_CLOUD_MS), "top5": typed(TOP5),
            "t_comp": t_comp, "mem_penalty": typed(MEM_BUSY_PENALTY)}
    tabs = {k: v.to(device) for k, v in tabs.items()}
    # The link capacities divide the job counts. PyTorch's CUDA division
    # by a Python number multiplies by its reciprocal, which 1.3 and 2.4
    # lack exactly; in float64 they divide as device tensors, so the card
    # gives numpy's quotient. Float32 keeps the fleet path's division.
    caps = {"edge_link_cap": EDGE_LINK_CAP, "cloud_link_cap": CLOUD_LINK_CAP}
    if dtype == torch.float64:
        caps = {k: typed(v).to(device) for k, v in caps.items()}
    return {**tabs, **caps}


def t_comp_device(model_id, dtype=torch.float32) -> torch.Tensor:
    """Compute time (ms) of model d_i on the end device (affine in MACs)."""
    m = torch.as_tensor(model_id)
    return _tables(m.device, dtype)["t_comp"][m.long()]


#: Tier order used by Calibration arrays: index 0=S (end device), 1=E, 2=C.
CALIB_TIERS = ("S", "E", "C")


class Calibration(NamedTuple):
    """Per-tier sim-to-real corrections to the latency model: ``(3,)``
    float32 compute multipliers and additive communication offsets
    (ms), in S/E/C order. ``identity()`` is a no-op calibration."""
    compute_scale: torch.Tensor
    hop_offset_ms: torch.Tensor

    @staticmethod
    def identity(device=None):
        return Calibration(torch.ones(3, device=device),
                           torch.zeros(3, device=device))


def user_tier(per_user) -> torch.Tensor:
    """(..., N) action ids -> (..., N) tier index (0=S, 1=E, 2=C)."""
    return torch.where(per_user == A_EDGE, 1,
                       torch.where(per_user == A_CLOUD, 2, 0))


def _masks(per_user, active):
    local = per_user < A_EDGE
    at_edge = per_user == A_EDGE
    at_cloud = per_user == A_CLOUD
    if active is not None:
        at_edge = at_edge & active
        at_cloud = at_cloud & active
        local = local & active
    return local, at_edge, at_cloud


def _counts(at_edge, at_cloud, counts):
    if counts is None:
        return at_edge.sum(-1)[..., None], at_cloud.sum(-1)[..., None]
    dev = at_edge.device
    return (torch.as_tensor(counts[0], device=dev)[..., None],
            torch.as_tensor(counts[1], device=dev)[..., None])


#: per tier: the table key of its link capacity, and the job count above
#: which its memory is busy
_TIER_LIMITS = {"E": ("edge_link_cap", EDGE_MEM_BUSY_AT),
                "C": ("cloud_link_cap", CLOUD_MEM_BUSY_AT)}


def _factors(n, tier, tab):
    """(processor sharing, link sharing, memory penalty) at ``n`` jobs on
    ``tier`` ("E" or "C"), in the type of the tables ``tab``."""
    cap, busy_at = _TIER_LIMITS[tier]
    n = n.to(tab["t_comp"].dtype)
    cpu = torch.clamp(n / TIER_CORES[tier], min=1.0)
    link = torch.clamp(n / tab[cap], min=1.0)
    mem = torch.where(n > busy_at, tab["mem_penalty"], 1.0)
    return cpu, link, mem


def response_times(per_user, end_b, edge_b, *, counts=None, active=None,
                   cloud_mult=None, calib=None,
                   dtype=torch.float32) -> torch.Tensor:
    """Per-user response time (ms), noise-free.

    per_user : (..., N) int  per-user action ids (0..7 local, 8 edge, 9 cloud)
    end_b    : (..., N) int  per-end-node link state (0 Regular, 1 Weak)
    edge_b   : (...,)   int  edge backhaul link state
    counts   : optional (n_edge, n_cloud) override of contention counts
               (the seam ``fleet.topology`` feeds shared contention
               through; may be fractional)
    active   : optional (..., N) bool; inactive users produce 0 ms and do
               not contribute to contention
    cloud_mult : optional queueing multiplier on the cloud-side terms
    calib    : optional ``Calibration`` (the calibrated component path)
    dtype    : the floating type of the result and of every step
    """
    if calib is not None:
        return calibrated_response_times(
            per_user, end_b, edge_b, calib, counts=counts, active=active,
            cloud_mult=cloud_mult, dtype=dtype)
    tab = _tables(per_user.device, dtype)
    end_b, edge_b = end_b.long(), edge_b.long()
    local, at_edge, at_cloud = _masks(per_user, active)
    n_e, n_c = _counts(at_edge, at_cloud, counts)

    t = tab["t_orch"][end_b]
    # local compute: chosen model at device speed
    t = t + torch.where(local, tab["t_comp"][
        torch.where(local, per_user, 0).long()], 0.0)
    # edge: upload (shared link) + d0 at edge speed (processor sharing),
    # memory-busy penalty on the compute term
    up_e = tab["t_up_edge"][end_b]
    comp_e = tab["t_comp"][0] / TIER_SPEED["E"]
    cpu_e, link_e, mem_e = _factors(n_e, "E", tab)
    t_e = up_e * link_e + comp_e * cpu_e * mem_e
    t = t + torch.where(at_edge, t_e, 0.0)
    # cloud: upload + edge->cloud hop (shared) + d0 at cloud speed
    comp_c = tab["t_comp"][0] / TIER_SPEED["C"]
    cpu_c, link_c, mem_c = _factors(n_c, "C", tab)
    hop_c = tab["t_hop_cloud"][edge_b][..., None] * link_c
    comp_term = comp_c * cpu_c * mem_c
    if cloud_mult is not None:
        hop_c = hop_c * cloud_mult
        comp_term = comp_term * cloud_mult
    t_c = up_e * link_c + hop_c + comp_term
    t = t + torch.where(at_cloud, t_c, 0.0)
    if active is not None:
        t = torch.where(active, t, 0.0)
    return t


def accuracies(per_user, dtype=torch.float32) -> torch.Tensor:
    """Per-user top-5 accuracy (%): offloaded users run d0."""
    per_user = torch.as_tensor(per_user)
    top5 = _tables(per_user.device, dtype)["top5"]
    return top5[torch.where(per_user < A_EDGE, per_user, 0).long()]


def response_components(per_user, end_b, edge_b, *, counts=None,
                        active=None, cloud_mult=None, dtype=torch.float32):
    """Split ``response_times`` into (communication, compute) components,
    ``comm + comp ≈ response_times`` (allclose: the split re-associates
    the sums)."""
    tab = _tables(per_user.device, dtype)
    end_b, edge_b = end_b.long(), edge_b.long()
    local, at_edge, at_cloud = _masks(per_user, active)
    n_e, n_c = _counts(at_edge, at_cloud, counts)

    comm = tab["t_orch"][end_b]
    comp = torch.where(local, tab["t_comp"][
        torch.where(local, per_user, 0).long()], 0.0)
    up_e = tab["t_up_edge"][end_b]
    comp_e = tab["t_comp"][0] / TIER_SPEED["E"]
    cpu_e, link_e, mem_e = _factors(n_e, "E", tab)
    comm = comm + torch.where(at_edge, up_e * link_e, 0.0)
    comp = comp + torch.where(at_edge, comp_e * cpu_e * mem_e, 0.0)
    comp_c = tab["t_comp"][0] / TIER_SPEED["C"]
    cpu_c, link_c, mem_c = _factors(n_c, "C", tab)
    hop_c = tab["t_hop_cloud"][edge_b][..., None] * link_c
    comp_term = comp_c * cpu_c * mem_c
    if cloud_mult is not None:
        hop_c = hop_c * cloud_mult
        comp_term = comp_term * cloud_mult
    comm = comm + torch.where(at_cloud, up_e * link_c + hop_c, 0.0)
    comp = comp + torch.where(at_cloud, comp_term, 0.0)
    if active is not None:
        comm = torch.where(active, comm, 0.0)
        comp = torch.where(active, comp, 0.0)
    return comm, comp


def calibrated_response_times(per_user, end_b, edge_b, calib, *,
                              counts=None, active=None, cloud_mult=None,
                              dtype=torch.float32):
    """``max(comm + hop_offset[tier] + compute_scale[tier] * comp, 0)``,
    inactive users masked to 0 as in ``response_times``."""
    comm, comp = response_components(per_user, end_b, edge_b, counts=counts,
                                     active=active, cloud_mult=cloud_mult,
                                     dtype=dtype)
    tier = user_tier(per_user).long()
    scale = calib.compute_scale.to(comm.device)[tier]
    off = calib.hop_offset_ms.to(comm.device)[tier]
    t = torch.clamp(comm + off + scale * comp, min=0.0)
    if active is not None:
        t = torch.where(active, t, 0.0)
    return t


def expected_response(per_user, end_b, edge_b, *, active=None, counts=None,
                      cloud_mult=None, calib=None):
    """(mean response ms, mean top-5 accuracy) over the last (user) axis.

    With an ``active`` mask, means are over active users only; a cell
    with no active user reports 0 ms and a vacuous 100% accuracy."""
    t = response_times(per_user, end_b, edge_b, active=active, counts=counts,
                       cloud_mult=cloud_mult, calib=calib)
    acc = accuracies(per_user)
    if active is None:
        return t.mean(-1), acc.mean(-1)
    n = torch.clamp(active.sum(-1), min=1)
    mean_acc = torch.where(active, acc, 0.0).sum(-1) / n
    mean_acc = torch.where(active.any(-1), mean_acc, 100.0)
    return t.sum(-1) / n, mean_acc


def feasible(mean_acc, threshold):
    """THE accuracy-constraint predicate (paper Eq. 4) with the
    reference's absolute 1e-9 slack; takes a tensor or a numpy array."""
    if isinstance(mean_acc, torch.Tensor):
        return mean_acc >= threshold - 1e-9
    return np.asarray(mean_acc) >= threshold - 1e-9


def reward(mean_ms, mean_acc, threshold):
    """Paper Eq. 4: -mean response if the accuracy constraint holds,
    else the -MAX_RESPONSE_MS floor; scaled to ~[-2.5, 0]. Takes tensors
    or, as the single-cell environment passes them, numpy values."""
    if isinstance(mean_ms, torch.Tensor):
        return torch.where(feasible(mean_acc, threshold), -mean_ms,
                           -MAX_RESPONSE_MS) / 1000.0
    return np.where(feasible(mean_acc, threshold), -np.asarray(mean_ms),
                    -MAX_RESPONSE_MS) / 1000.0


def cell_response_times(per_user, end_b, edge_b, dtype=torch.float32):
    """(cells, N) actions, (cells, N) link states and (cells,) edge states
    -> (cells, N) response ms: every cell of the fleet in one call."""
    return response_times(per_user, end_b, edge_b, dtype=dtype)


def fleet_expected_response(per_user, end_b, edge_b, active=None,
                            calib=None):
    """(cells, N) batch -> ((cells,) mean ms, (cells,) mean accuracy)."""
    return expected_response(per_user, end_b, edge_b, active=active,
                             calib=calib)


def fleet_actions_expected_response(per_user_k, end_b, edge_b, member=None,
                                    calib=None):
    """Evaluate K candidate joint actions for every cell at once.

    per_user_k : (K, N) decoded candidate actions (shared across cells)
    end_b      : (cells, N), edge_b: (cells,)
    member     : optional (cells, N) membership mask
    Returns ((cells, K) mean ms, mean accuracy): accuracy is (1, K)
    without ``member``, (cells, K) with it.
    """
    active = None if member is None else member[:, None, :]
    return expected_response(per_user_k[None, :, :], end_b[:, None, :],
                             edge_b[:, None], active=active, calib=calib)
