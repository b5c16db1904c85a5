"""Fused tabular-RL act+update: the CUDA kernel ``csrc/tabular_rl.cu`` and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/tabular_rl.py``
(``tabular_rl_kernel``, body ``_kernel``). Per cell: the TD error
against the pre-update row ``s2``, the in-place update of ``q[c, s,
a]`` and the next greedy action from the post-update row ``s2``.

Bound on the H100: memory. Per cell the function must read one K-wide
row and a few scalars and write three scalars, about ``4K + 32`` bytes
— at 32,768 cells, K=243 about 33 MB, ~10 µs at 3.35 TB/s. One warp per
cell reads the row coalesced and reduces with shuffles (see the source
note in the ``.cu`` file).

The table is updated IN PLACE on both paths, as the reference's
``input_output_aliases`` did: the returned ``q`` is the argument.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import F, I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("tabular_rl", [P, P, P, P, P, P, P, I, I, I, F, F])

#: the plain version (a CPU tensor takes it)
plain = ref.fused_tabular_ref


def tabular_rl_cuda(q, s, a, r, s2, *, alpha: float, gamma: float):
    """Launch the CUDA kernel. ``q``: (cells, S, K) f32 contiguous,
    updated in place; ``s``/``a``/``s2``: (cells,) int32; ``r``: (cells,)
    f32. Returns ``(q, greedy2 int32, td f32)``."""
    cells, n_states, n_actions = q.shape
    check_cuda("q", q, torch.float32)
    for name, t, dt in (("s", s, torch.int32), ("a", a, torch.int32),
                        ("r", r, torch.float32), ("s2", s2, torch.int32)):
        check_cuda(name, t, dt, (cells,))
    greedy2 = torch.empty(cells, dtype=torch.int32, device=q.device)
    td = torch.empty(cells, dtype=torch.float32, device=q.device)
    KERNEL.launch(q.data_ptr(), s.data_ptr(), a.data_ptr(), r.data_ptr(),
                  s2.data_ptr(), greedy2.data_ptr(), td.data_ptr(), cells,
                  n_states, n_actions, float(alpha), float(gamma))
    return q, greedy2, td


def cost(cells: int, n_states: int, k: int):
    """(FP32 operations, bytes) of one call — the arithmetic of the bound
    in ``PERF.md`` §6: row s2 and q[s, a] read, q[s, a] written, s, a, r,
    s2 in and greedy2, td out; ~2 compares per row entry. ``n_states``
    moves nothing: one row of each cell's table is read."""
    return cells * 2 * k, cells * (4 * k + 32)
