"""Int8 x int8 -> int32 matmul with a dequantizing epilogue: the CUDA
kernel ``csrc/int8_matmul.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul.py``
(``int8_matmul_kernel``, body ``_kernel``): ``(float(x_q @ w_q) * sx) *
sw`` with per-row activation scales ``sx`` and per-column weight scales
``sw``, rounded once to ``out_dtype``; the projection of every int8
variant of the served models.

The port holds the int8 weight K-major: ``w_q`` is the reference's
logical (K, N) array as a view of (N, K) row-major storage, strides (1,
K) (``k_major``, which ``layers.init_linear`` and
``convert.model_params`` call). The tensor cores' ``wgmma`` takes
8-bit operands only K-major, so the kernel reads that storage as it is;
on a CUDA tensor any other layout raises, nothing is copied quietly.

Bound on the H100: operations at prefill shapes (Falcon-Mamba d4's
projections do ~1,800 operations per byte, past the int8 ridge of ~590),
bytes at decode shapes (M <= 64 rows: the weight is a stream read once).
One kernel template serves both; ``plan`` picks the instance (see the
source note in the ``.cu`` file). The epilogue
rounds exactly as the plain version, so the two agree bit for bit in
float32 and in bfloat16.

Batched operands, ``(E, M, K)`` x ``(E, K, N)``, take one launch for all
E products (the int8 experts of ``models.moe``): the kernel's second grid
axis is the expert.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels._build import (I, P, CudaKernel, check_aligned,
                                        check_cuda)

KERNEL = CudaKernel("int8_matmul", [P] * 5 + [I] * 7)

#: K bytes per pipeline step of the kernel
BK = 128
#: rows that take the decode instance (one 64-row wgmma tile)
DECODE_ROWS = 64
#: output types the kernel writes, by its ``out_bf16`` code
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain(x_q, sx, w_q, sw, out_dtype=torch.float32):
    """The plain version (a CPU tensor takes it): ``ref.int8_matmul_ref``
    rounded once to ``out_dtype``; batched operands broadcast through its
    ``@``."""
    return ref.int8_matmul_ref(x_q, sx, w_q, sw).to(out_dtype)


def plan(m: int, n: int, k: int) -> tuple[int, int]:
    """``(bm, bn)``, the output tile of the instance that computes an
    (m, k) x (k, n) product: the decode instance (64 x 64) for ``m <=
    64`` rows, else the prefill instance (128 x 256). One block per tile
    sweeps the whole of K."""
    return (64, 64) if m <= DECODE_ROWS else (128, 256)


def k_major(w_q):
    """The (..., K, N) int8 weight ``w_q`` with the same values, held
    K-major as the kernel reads it: a view of (..., N, K) row-major
    storage, strides (..., 1, K)."""
    return w_q.transpose(-1, -2).contiguous().transpose(-1, -2)


def operands(x_q, w_q, out_dtype):
    """What a launch of (E, M, K) ``x_q`` and K-major (E, K, N) ``w_q``
    allocates: where K is no multiple of 16, both zero-padded along K to
    a multiple of 32 (``int8_matmul_cuda``); and the (E, M, N) output in
    ``out_dtype``. Returns (x_q, w_q, out)."""
    e, m, k = x_q.shape
    if k % 16:
        pad = -k % 32
        x_q = F.pad(x_q, (0, pad))
        w_q = F.pad(w_q.transpose(-1, -2), (0, pad)).transpose(-1, -2)
    return x_q, w_q, torch.empty((e, m, w_q.shape[-1]), dtype=out_dtype,
                                 device=x_q.device)


def int8_matmul_cuda(x_q, sx, w_q, sw, out_dtype=torch.float32):
    """Launch the CUDA kernel. ``x_q``: (M, K) int8 contiguous; ``sx``:
    (M, 1) f32; ``w_q``: (K, N) int8, K-major (strides (1, K)); ``sw``:
    (1, N) f32. Returns the (M, N) product in ``out_dtype`` (float32 or
    bfloat16). Batched: ``x_q`` (E, M, K), ``sx`` (E, M, 1), ``w_q`` (E,
    K, N) with each expert K-major (strides (N K, 1, K)), ``sw`` (E, 1, N)
    -> (E, M, N), one launch for the E products.

    Where K is no multiple of 16 the kernel's 16-byte loads cannot reach
    the rows, so x_q and w_q are zero-padded along K to a multiple of 32
    first: exact, since zeros add nothing to the int32 sum. It is the same
    kernel on the padded operands, not a fallback."""
    if x_q.dim() == 2:
        return int8_matmul_cuda(x_q[None], sx[None], w_q[None], sw[None],
                                out_dtype)[0]
    e, m, k = x_q.shape
    n = w_q.shape[-1]
    if k < 1:
        raise ValueError("int8_matmul needs K >= 1")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_matmul writes float32 or bfloat16, got "
                        f"{out_dtype}")
    check_cuda("x_q", x_q, torch.int8)
    check_cuda("sx", sx, torch.float32, (e, m, 1))
    w_t = w_q.transpose(-1, -2)
    if w_q.shape[:2] != (e, k) or not w_t.is_contiguous():
        raise ValueError(f"w_q must be a K-major ({k}, N) int8 weight for "
                         f"each of {e}: a view of (N, K) row-major storage, "
                         f"strides (1, K), as k_major(w_q) makes it; got "
                         f"shape {tuple(w_q.shape)}, strides {w_q.stride()}")
    check_cuda("w_q", w_t, torch.int8)
    check_cuda("sw", sw, torch.float32, (e, 1, n))
    x_q, w_q, out = operands(x_q, w_q, out_dtype)
    k = x_q.shape[-1]
    check_aligned(x_q=x_q, w_q=w_q)
    if not (e and m and n):
        return out
    bm, bn = plan(m, n, k)
    KERNEL.launch(x_q.data_ptr(), sx.data_ptr(), w_q.data_ptr(),
                  sw.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                  OUT_DTYPES[out_dtype], e)
    return out


def cost(m: int, k: int, n: int, out_elem: int, batch: int = 1):
    """(int8 operations, bytes) of one call of ``batch`` products — the
    arithmetic of the bound in ``PERF.md`` §6: x, w and both scales read
    once, the output written once at ``out_elem`` bytes a value."""
    return (batch * 2 * m * k * n,
            batch * (m * k + k * n + 4 * (m + n) + out_elem * m * n))
