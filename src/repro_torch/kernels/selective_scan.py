"""Mamba-1 selective scan: the CUDA kernel ``csrc/selective_scan.cu`` and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/selective_scan.py``
(``selective_scan_kernel``, body ``_kernel``): ``h_t = exp(dt_t A) h_{t-1}
+ (dt_t u_t) B_t`` from ``h_0 = 0`` and ``y_t = h_t . C_t + D u_t``,
parallel over (batch, channel) and sequential in time, returning ``y``
and the final state. Every prefill of a Mamba block goes through it.

Bound on the H100: bytes (``u``, ``dt`` and ``y`` once per batch, step
and channel) against the HBM rate and the FP32 peak. The one exponential
per (batch, step, channel, state) on the special function units is a
floor above that bound which this design, computing every exponential
there, cannot go under. ``plan`` splits each channel's states over 2 or 4
lanes of a warp, from the shape alone: four where the (batch, channel)
grid is too thin to fill the card. See the source note in the ``.cu``
file. ``di`` need not be a multiple of anything: the kernel
bounds-checks, where the Pallas wrapper padded to its block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("selective_scan", [P] * 8 + [I] * 6)

#: the largest state the kernel keeps in registers
MAX_STATE = 16
#: kernel dtype codes of ``u`` and ``y``
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: lanes of a warp one channel's states may be split over
LANES = (2, 4)
#: threads per block of the kernel: 128 // lanes channels of one batch row
THREADS = 128
#: streaming multiprocessors of the H100 SXM; the plan aims for four
#: blocks of four warps on each
SMS = 132
WANT_BLOCKS = 4 * SMS

#: the plain version (a CPU tensor takes it)
plain = ref.selective_scan_ref


def plan(bt: int, di: int, n: int) -> tuple[int, int]:
    """``(lanes, states per lane)`` of the kernel for ``bt`` batch rows of
    ``di`` channels of ``n`` states: the fewest lanes per channel that
    still give ``WANT_BLOCKS`` blocks of ``THREADS // lanes`` channels,
    else the most. Each lane keeps ``MAX_STATE // lanes`` states (those
    past ``n`` stay zero). Two lanes, not one, is the least: one lane
    is no faster where the grid is wide and slower where it is thin
    (``tools/scan_ablate.py`` times each lane count)."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan kernel has state sizes 1.."
                         f"{MAX_STATE}, got {n}")
    for lanes in LANES:
        if bt * -(-di // (THREADS // lanes)) >= WANT_BLOCKS:
            break
    return lanes, MAX_STATE // lanes


def selective_scan_cuda(u, dt, A, B, C, D):
    """Launch the CUDA kernel. ``u``: (Bt, S, di) float32 or bfloat16;
    ``dt``: (Bt, S, di) f32; ``A``: (di, N) f32 with N <= ``MAX_STATE``;
    ``B``/``C``: (Bt, S, N) f32; ``D``: (di,) f32; all contiguous.
    Returns ``(y (Bt, S, di) in u's dtype, h_last (Bt, di, N) f32)``."""
    bt, s, di = u.shape
    n = A.shape[-1]
    if u.dtype not in DTYPES:
        raise TypeError(f"selective_scan takes float32 or bfloat16 u, got "
                        f"{u.dtype}")
    lanes, _ = plan(bt, di, n)
    check_cuda("u", u, u.dtype)
    check_cuda("dt", dt, torch.float32, (bt, s, di))
    check_cuda("A", A, torch.float32, (di, n))
    check_cuda("B", B, torch.float32, (bt, s, n))
    check_cuda("C", C, torch.float32, (bt, s, n))
    check_cuda("D", D, torch.float32, (di,))
    y = torch.empty_like(u)
    h_last = torch.empty((bt, di, n), dtype=torch.float32, device=u.device)
    KERNEL.launch(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                  bt, s, di, n, DTYPES[u.dtype], lanes)
    return y, h_last


def cost(bt: int, s: int, di: int, n: int, u_elem: int):
    """(FP32 operations, bytes) of one call — the arithmetic of the bound
    in ``PERF.md`` §6: per state dt*A, the exponential, h*dA + du*B, the
    C product and its sum; per channel dt*u, u*D and its add. u, dt read
    and y written once a (batch, step, channel); A, D, B, C read and
    h_last written once."""
    ops = 7 * bt * s * di * n + 3 * bt * s * di
    nbytes = bt * s * di * (2 * u_elem + 4) \
        + 4 * (di * n + di + 2 * bt * s * n + bt * di * n)
    return ops, nbytes
