"""One best-response round of the coupled-fleet oracle: the CUDA kernel
``csrc/best_response.cu`` and its plain PyTorch version.

Port-only: the reference runs this round as a jitted ``fori_loop``
(``repro/fleet/population.py`` ``_best_response_round``) and has no
Pallas kernel for it. The plain version is that loop's body as a Python
loop over cells, a few dozen small ops a cell; the kernel walks the
cells in one thread block and splits each cell's K candidates over its
threads, so a round is one launch.

Bound on the H100: the chain of cells. Every cell reads the edge and
cloud totals the previous cell wrote, so the round cannot beat one
block reduction and two barriers a cell (``chip_smoke.py`` measures
that floor as the kernel's time at K = 1). The work beside it is the
``(cells, K)`` tables read once and ~``10 + 12 N`` FP32 operations per
entry (``cost``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels._build import F, I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("best_response", [P] * 16 + [I] * 4 + [F])

#: minimum per-cell improvement (ms) for a best-response switch — a
#: strict-improvement margin so equal-cost candidates can't cycle
BEST_RESPONSE_TOL = 1e-6
#: the most users a cell may have (a candidate's actions pack 4 bits a
#: user into one int32)
MAX_USERS = 8


def plain(idx, pu_table, end_b, edge_b, member, feas, cand_e, cand_c,
          cell_edge, edge_capacity, cloud_servers: float, calib=None):
    """One Gauss-Seidel sweep: each cell in turn picks its best feasible
    candidate given every other cell's current decision, the running
    per-edge and cloud totals updated as it goes. ``feas`` / ``cand_e``
    / ``cand_c`` are the (cells, K) round-invariant tables. Returns
    ``(new_idx, changed)``, ``changed`` a bool tensor on idx's device."""
    from repro_torch.fleet import dynamics, topology
    cells = idx.shape[0]
    rows = torch.arange(cells, device=idx.device)
    new = idx.clone()
    e_cnt = cand_e[rows, idx.long()]
    c_cnt = cand_c[rows, idx.long()]
    edge_tot = topology._segment_totals(e_cnt, cell_edge,
                                        edge_capacity.shape[0])
    cloud_tot = c_cnt.sum()
    for i, e_i in enumerate(cell_edge.tolist()):
        n_e_k = (edge_tot[e_i] - e_cnt[i] + cand_e[i]) / edge_capacity[e_i]
        tot_c_k = cloud_tot - c_cnt[i] + cand_c[i]
        mult_k = topology.cloud_load_multiplier(tot_c_k, cloud_servers)
        ms_k, _ = dynamics.expected_response(
            pu_table, end_b[i][None, :], edge_b[i],
            active=member[i][None, :], counts=(n_e_k, cand_c[i]),
            cloud_mult=mult_k[:, None], calib=calib)          # (K,)
        score = torch.where(feas[i], ms_k, torch.inf)
        j = score.argmin()                       # the first index on ties
        cur = new[i].long()
        nxt = torch.where(score[j] < score[cur] - BEST_RESPONSE_TOL, j, cur)
        edge_tot[e_i] += cand_e[i, nxt] - e_cnt[i]
        cloud_tot = cloud_tot + cand_c[i, nxt] - c_cnt[i]
        new[i] = nxt
    return new, (new != idx).any()


def pack_actions(pu_table: torch.Tensor) -> torch.Tensor:
    """(K, N) per-user ids -> (K,) int32, 4 bits a user (user u in bits
    4u..4u+3), the kernel's form of the candidate table."""
    shifts = 4 * torch.arange(pu_table.shape[1], device=pu_table.device)
    return (pu_table.long() << shifts).sum(-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def consts() -> np.ndarray:
    """The latency model's float32 constants in the kernel's ``Consts``
    order: t_orch[2], t_up_edge[2], t_hop_cloud[2], t_comp[8], t_comp0,
    mem_penalty and the link capacities' float32 reciprocals — the values
    of the plain version's tables (built on the host, then copied to the
    card) and of ``dynamics.div_const``. Built once; read-only."""
    from repro_torch.fleet import dynamics
    tab = dynamics._tables(torch.device("cpu"))
    recip = [np.float32(1.0) / np.float32(c)
             for c in (dynamics.EDGE_LINK_CAP, dynamics.CLOUD_LINK_CAP)]
    out = np.concatenate([tab[k].numpy().reshape(-1) for k in (
        "t_orch", "t_up_edge", "t_hop_cloud", "t_comp", "t_comp0",
        "mem_penalty")] + [np.array(recip, np.float32)]).astype(np.float32)
    out.setflags(write=False)
    return out


def best_response_cuda(idx, pu_packed, end_b, edge_b, member, feas, cand_e,
                       cand_c, cell_edge, edge_capacity,
                       cloud_servers: float, calib=None):
    """Launch the CUDA kernel: one round over every cell. ``pu_packed``
    is ``pack_actions`` of the (K, N) table; ``member``/``feas`` bool;
    the rest int32 / float32 as ``plain``. Returns ``(new_idx, changed)``
    with ``changed`` a (1,) int32 flag on the card."""
    cells, users = end_b.shape
    k = pu_packed.shape[0]
    n_edges = edge_capacity.shape[0]
    i32 = torch.int32
    check_cuda("idx", idx, i32, (cells,))
    check_cuda("pu_packed", pu_packed, i32, (k,))
    check_cuda("end_b", end_b, i32, (cells, users))
    check_cuda("edge_b", edge_b, i32, (cells,))
    check_cuda("member", member, torch.bool, (cells, users))
    check_cuda("feas", feas, torch.bool, (cells, k))
    check_cuda("cand_e", cand_e, i32, (cells, k))
    check_cuda("cand_c", cand_c, i32, (cells, k))
    check_cuda("cell_edge", cell_edge, i32, (cells,))
    check_cuda("edge_capacity", edge_capacity, torch.float32, (n_edges,))
    if not 1 <= users <= MAX_USERS:
        raise ValueError(f"the kernel takes 1..{MAX_USERS} users, got "
                         f"{users}")
    scale = off = None
    if calib is not None:
        scale, off = calib.compute_scale, calib.hop_offset_ms
        check_cuda("compute_scale", scale, torch.float32, (3,))
        check_cuda("hop_offset_ms", off, torch.float32, (3,))
    c = consts()
    dev = idx.device
    new = torch.empty_like(idx)
    changed = torch.empty(1, dtype=i32, device=dev)
    edge_tot = torch.empty(n_edges, dtype=i32, device=dev)
    KERNEL.launch(idx.data_ptr(), new.data_ptr(), changed.data_ptr(),
                  pu_packed.data_ptr(), end_b.data_ptr(), edge_b.data_ptr(),
                  member.data_ptr(), feas.data_ptr(), cand_e.data_ptr(),
                  cand_c.data_ptr(), cell_edge.data_ptr(),
                  edge_capacity.data_ptr(), edge_tot.data_ptr(),
                  None if scale is None else scale.data_ptr(),
                  None if off is None else off.data_ptr(), c.ctypes.data,
                  cells, k, users, n_edges, float(cloud_servers))
    return new, changed


def cost(cells: int, k: int, users: int, n_edges: int):
    """(FP32 operations, bytes) of one round: the (cells, K) tables read
    once (bool feas, int32 cand_e / cand_c), the packed candidates, each
    cell's row and decision in and out, the edge totals; ~10 operations
    per (cell, candidate) for the counts and the queue multiplier and
    ~12 per member user for the latency model and the sum."""
    ops = cells * k * (10 + 12 * users)
    nbytes = (cells * k * 9 + k * 4 + cells * (users * 5 + 16)
              + n_edges * 8)
    return ops, nbytes
