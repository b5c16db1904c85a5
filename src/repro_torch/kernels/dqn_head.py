"""Fused featurize + constraint-aware greedy head: the CUDA kernel
``csrc/dqn_head.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/dqn_head.py``
(``dqn_head_kernel``, body ``_kernel``): per-user 11-wide features, the
shared 11->H->H->10 ReLU MLP, the allowed-action mask, the plain
first-index argmax and — with a QoS threshold — the stable top-k and
the scoring of the ``topk^N`` combinations against the accuracy ladder.

Bound on the H100: operations on the CUDA cores — ~2·(11H + H² + 10H)
FLOP per user row (38.1 kFLOP at H=128) plus ~N adds per combination,
against ~60 bytes per user row in and out. The kernel keeps the weights
in shared memory across a persistent block and computes in plain FP32
FMA, not TF32, so its decisions can be held exactly against the plain
version (see the source note in the ``.cu`` file).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import F, I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("dqn_head", [P] * 14 + [I] * 6 + [F, I])

#: the plain version (a CPU tensor takes it)
plain = ref.dqn_head_ref


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
    n_combo = topk ** users if threshold else 1
    if n_combo >= 2 ** 31:
        raise ValueError(f"topk^N = {n_combo} combinations overflow int32")
    # the reference compares float32 accuracies with the threshold less
    # 1e-9, i.e. with that bound rounded to float32
    thr = float(np.float32(threshold - 1e-9))
    dec = torch.empty((cells, users), dtype=torch.int32, device=active.device)
    q = torch.empty((cells, users, n_act), dtype=f32, device=active.device)
    KERNEL.launch(*(t.data_ptr() for t in (
        active, member, end_b, agg, w1, b1, w2, b2, w3, b3, allowed,
        acc_table, dec, q)), cells, users, n_agg, hidden, n_act,
        int(bool(threshold)), thr, int(topk))
    return dec, q
