"""Fused featurize + constraint-aware greedy head: the CUDA kernel
``csrc/dqn_head.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/dqn_head.py``
(``dqn_head_kernel``, body ``_kernel``): per-user 11-wide features, the
shared 11->H->H->10 ReLU MLP, the allowed-action mask, the plain
first-index argmax and — with a QoS threshold — the stable top-k and
the scoring of the ``topk^N`` combinations against the accuracy ladder.

Bound on the H100: operations on the CUDA cores — ~2·(11H + H² + 10H)
FLOP per user row (38.1 kFLOP at H=128) plus two adds per combination
searched, against ~60 bytes per user row in and out. The kernel keeps
one copy of the weights in shared memory per SM and computes in plain
FP32 FMA, not TF32, so its decisions can be held exactly against the
plain version; half its warps run the MLP of one tile while the other
half search the previous tile's cells over the valid top-k digits only
(see the source note in the ``.cu`` file).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("dqn_head", [P] * 15 + [I] * 7)

#: the most users a cell may have (a cell's members fit one 32-bit mask)
MAX_USERS = 32
#: the widest per-user action space (held in registers per row)
MAX_ACTIONS = 16

#: the plain version (a CPU tensor takes it)
plain = ref.dqn_head_ref


def threshold32(threshold: float) -> np.float32:
    """The reference compares float32 mean accuracies with the threshold
    less 1e-9, i.e. with that bound rounded to float32."""
    return np.float32(threshold - 1e-9)


def _key(x: np.ndarray) -> np.ndarray:
    """float32 -> int64 keys in the floats' order (-0.0 just below +0.0)."""
    b = x.astype(np.float32).view(np.uint32).astype(np.int64)
    return np.where(b >= 2 ** 31, 2 ** 32 - 1 - b, b + 2 ** 31)


def _from_key(k: np.ndarray) -> np.ndarray:
    b = np.where(k >= 2 ** 31, k - 2 ** 31, 2 ** 32 - 1 - k)
    return b.astype(np.uint32).view(np.float32)


@functools.lru_cache(maxsize=64)
def x_min_table(threshold: float, users: int) -> np.ndarray:
    """(users + 1,) float32: entry m >= 1 is the least float32 x with
    ``float32(x) / float32(m) >= threshold32(threshold)`` in float32, the
    reference's test of a combo's mean member accuracy; entry 0 is unused.
    Rounded division by m > 0 never decreases as x grows, so the test is
    ``x >= x_min[m]``: a search over the float32 bit patterns."""
    thr = threshold32(threshold)
    m = np.arange(1, users + 1, dtype=np.float32)
    lo = np.full(users, _key(np.float32(-np.inf)))
    hi = np.full(users, _key(np.float32(np.inf)))
    with np.errstate(over="ignore", invalid="ignore"):
        while (lo < hi).any():
            mid = (lo + hi) // 2
            ok = _from_key(mid) / m >= thr
            hi = np.where(ok, mid, hi)
            lo = np.where(ok, lo, mid + 1)
    out = np.empty(users + 1, np.float32)
    out[0] = np.inf
    out[1:] = _from_key(lo)
    out.setflags(write=False)
    return out


def outputs(active, n_act: int):
    """What a launch allocates: the decisions (cells, users) int32 and q
    (cells, users, actions) float32."""
    cells, users = active.shape
    return (torch.empty((cells, users), dtype=torch.int32,
                        device=active.device),
            torch.empty((cells, users, n_act), dtype=torch.float32,
                        device=active.device))


def dqn_head_cuda(active, member, end_b, agg, w1, b1, w2, b2, w3, b3,
                  allowed, acc_table, *, threshold: float, topk: int):
    """Launch the CUDA kernel; arguments and result as
    ``ref.dqn_head_ref`` (biases are 1-D)."""
    cells, users = active.shape
    n_agg = agg.shape[1]
    hidden, n_act = w2.shape[0], w3.shape[1]
    f32 = torch.float32
    for name, t in (("active", active), ("member", member),
                    ("end_b", end_b)):
        check_cuda(name, t, f32, (cells, users))
    check_cuda("agg", agg, f32, (cells, n_agg))
    check_cuda("w1", w1, f32, (3 + n_agg, hidden))
    check_cuda("b1", b1, f32, (hidden,))
    check_cuda("w2", w2, f32, (hidden, hidden))
    check_cuda("b2", b2, f32, (hidden,))
    check_cuda("w3", w3, f32, (hidden, n_act))
    check_cuda("b3", b3, f32, (n_act,))
    check_cuda("allowed", allowed, f32, (users, n_act))
    check_cuda("acc_table", acc_table, f32, (n_act,))
    if not (1 <= users <= MAX_USERS and 1 <= n_act <= MAX_ACTIONS
            and 1 <= topk <= n_act):
        raise ValueError(f"the kernel takes 1..{MAX_USERS} users, "
                         f"1..{MAX_ACTIONS} actions and 1 <= topk <= "
                         f"actions; got {users}, {n_act}, {topk}")
    n_combo = topk ** users if threshold else 1
    if n_combo >= 2 ** 31:
        raise ValueError(f"topk^N = {n_combo} combinations overflow int32")
    x_min = x_min_table(float(threshold), users) if threshold else None
    dec, q = outputs(active, n_act)
    KERNEL.launch(*(t.data_ptr() for t in (
        active, member, end_b, agg, w1, b1, w2, b2, w3, b3, allowed,
        acc_table, dec, q)), None if x_min is None else x_min.ctypes.data,
        cells, users, n_agg, hidden, n_act, int(bool(threshold)), int(topk))
    return dec, q


def cost(cells: int, users: int, n_agg: int, hidden: int, n_act: int,
         threshold: float, topk: int):
    """(FP32 operations, bytes) of one call — the arithmetic of the bound
    in ``PERF.md`` §6: per user row the (3 + n_agg) -> H -> H -> A MLP;
    with a goal two operations per user of each of the ``topk^N``
    combinations of every cell (the search over all of them; the kernel
    skips digits a mask excludes). Bytes: the per-user and cell inputs,
    the weights, mask and ladder read once, decisions and values out."""
    rows = cells * users
    n_feat = 3 + n_agg
    ops = rows * 2 * (n_feat * hidden + hidden * hidden + hidden * n_act)
    if threshold:
        ops += cells * topk ** users * users * 2
    n_params = (n_feat * hidden + hidden + hidden * hidden + hidden
                + hidden * n_act + n_act)
    nbytes = (rows * 3 * 4 + cells * n_agg * 4 + 4 * n_params
              + 4 * n_act * (users + 1) + rows * 4 + rows * n_act * 4)
    return ops, nbytes
