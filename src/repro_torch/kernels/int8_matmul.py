"""Int8 x int8 -> int32 matmul with a dequantizing epilogue: the CUDA
kernel ``csrc/int8_matmul.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul.py``
(``int8_matmul_kernel``, body ``_kernel``): ``(float(x_q @ w_q) * sx) *
sw`` with per-row activation scales ``sx`` and per-column weight scales
``sw``, the projection of every int8 variant of the served ladder.

Bound on the H100: bytes by the card's peaks (at most ~128 operations
per byte on the path's shapes, under the int8 tensor cores' ridge of
~590); the first kernel computes with ``__dp4a`` on the CUDA cores (see
the source note in the ``.cu`` file). Its epilogue rounds exactly as the
plain version, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("int8_matmul", [P, P, P, P, P, I, I, I])

#: the plain version (a CPU tensor takes it)
plain = ref.int8_matmul_ref


def int8_matmul_cuda(x_q, sx, w_q, sw):
    """Launch the CUDA kernel. ``x_q``: (M, K) int8; ``sx``: (M, 1) f32;
    ``w_q``: (K, N) int8; ``sw``: (1, N) f32; all contiguous. Returns the
    (M, N) float32 product."""
    m, k = x_q.shape
    n = w_q.shape[1]
    if k < 1:
        raise ValueError("int8_matmul needs K >= 1")
    check_cuda("x_q", x_q, torch.int8)
    check_cuda("sx", sx, torch.float32, (m, 1))
    check_cuda("w_q", w_q, torch.int8, (k, n))
    check_cuda("sw", sw, torch.float32, (1, n))
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    KERNEL.launch(x_q.data_ptr(), sx.data_ptr(), w_q.data_ptr(),
                  sw.data_ptr(), out.data_ptr(), m, n, k)
    return out
