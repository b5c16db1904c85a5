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

Training (``ops.selective_scan`` under autograd): the forward's
``states=True`` instance (template flag ``kStates``) also writes the
state entering every 32-step chunk, and the backward, P3
(``csrc/selective_scan_backward.cu``, port-only: the reference
differentiates its jnp scans with ``jax.grad``), rebuilds each chunk's
states from there and walks it in reverse, writing du, ddt, dA, dB, dC
and dD (the sums over channels, batch rows and time as per-block
partials added in a fixed order by a second launch: no atomics). Its
plain version is ``plain_backward``, the explicit reverse recurrence.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("selective_scan", [P] * 9 + [I] * 6)
#: the backward, P3: u, dt, A, B, C, D, the chunk states, dy, dh_last; du,
#: ddt, dA, dB, dC, dD; the dB / dC / dA / dD partial sums
BACKWARD = CudaKernel("selective_scan_backward", [P] * 19 + [I] * 5)

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
#: steps between two states the ``kStates`` instance writes
CHUNK = 32
#: channels of one block of the backward (four lanes a channel), and the
#: blocks a streaming multiprocessor holds at once (its 72 KB of shared
#: memory allow three): ``kCh`` and ``kBlocksPerSM`` of
#: ``csrc/selective_scan_backward.cu``, which the walk is compiled for
#: (``tests/test_torch_scan_grad.py`` holds the two equal)
BWD_CHANNELS = 32
BWD_BLOCKS_PER_SM = 3

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


def plain_backward(u, dt, A, B, C, D, dy, dh_last=None):
    """The backward's plain version, the explicit reverse recurrence in
    float32: the forward's states rebuilt and kept, then with g the
    gradient of h_t, for t = S - 1 ... 0: ``g += C_t dy_t``; ``dC_t =
    sum_d h_t dy_t``; ``du_t = D dy_t + dt_t sum_n g B_t``; ``ddt_t =
    sum_n g (A a_t h_{t-1} + u_t B_t)``; ``dB_t = sum_d g dt_t u_t``;
    ``dA += g dt_t a_t h_{t-1}``; then ``g *= a_t`` (a_t = exp(dt_t A));
    and ``dD = sum dy u``. ``dy`` (Bt, S, di) in y's dtype (u's);
    ``dh_last`` (Bt, di, N) or None (zero). Returns (du in u's dtype,
    ddt, dA, dB, dC, dD in float32)."""
    uf, dtf, dyf = u.float(), dt.float(), dy.float()
    Af, Bf, Cf = A.float(), B.float(), C.float()
    bt, s, di = u.shape
    h = torch.zeros((bt, di, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    h_prev = []
    for t in range(s):
        h_prev.append(h)
        h = h * torch.exp(dtf[:, t, :, None] * Af) \
            + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
    g = torch.zeros_like(h) if dh_last is None else dh_last.float()
    du, ddt = torch.empty_like(uf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(s)):
        hp, dyt = h_prev[t], dyf[:, t, :, None]
        a = torch.exp(dtf[:, t, :, None] * Af)
        dut = (dtf[:, t] * uf[:, t])[..., None]
        g = g + Cf[:, t, None, :] * dyt
        dC[:, t] = ((hp * a + dut * Bf[:, t, None, :]) * dyt).sum(1)
        gb = (g * Bf[:, t, None, :]).sum(-1)
        du[:, t] = D.float() * dyf[:, t] + dtf[:, t] * gb
        p = g * a * hp
        ddt[:, t] = (p * Af).sum(-1) + uf[:, t] * gb
        dB[:, t] = (g * dut).sum(1)
        dA += (p * dtf[:, t, :, None]).sum(0)
        g = g * a
    return du.to(u.dtype), ddt, dA, dB, dC, (dyf * uf).sum((0, 1))


def _check_args(u, dt, A, B, C, D):
    """The checks both kernels make of the forward's inputs."""
    bt, s, di = u.shape
    n = A.shape[-1]
    if u.dtype not in DTYPES:
        raise TypeError(f"selective_scan takes float32 or bfloat16 u, got "
                        f"{u.dtype}")
    check_cuda("u", u, u.dtype)
    check_cuda("dt", dt, torch.float32, (bt, s, di))
    check_cuda("A", A, torch.float32, (di, n))
    check_cuda("B", B, torch.float32, (bt, s, n))
    check_cuda("C", C, torch.float32, (bt, s, n))
    check_cuda("D", D, torch.float32, (di,))


def outputs(u, n: int, states: bool = False):
    """What a forward launch allocates: y in u's shape and dtype, h_last
    (Bt, di, N) float32 and, for the ``kStates`` instance, the state
    entering each ``CHUNK``-step chunk (Bt, ceil(S / CHUNK), di, N)
    float32 (else None)."""
    bt, s, di = u.shape
    f32 = dict(dtype=torch.float32, device=u.device)
    return (torch.empty_like(u), torch.empty((bt, di, n), **f32),
            torch.empty((bt, -(-s // CHUNK), di, n), **f32) if states
            else None)


def backward_outputs(u, dt, A, B, C, D):
    """What a backward launch allocates: (du, ddt, dA, dB, dC, dD) in
    their inputs' shapes and dtypes, and the partial sums its second
    launch adds, (dB / dC per ``BWD_CHANNELS``-channel block (2, Bt,
    blocks, S, N), dA (Bt, di, N), dD (Bt, di)) float32."""
    bt, s, di = u.shape
    n = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=u.device)
    grads = (torch.empty_like(u), torch.empty_like(dt)) + tuple(
        torch.empty_like(t) for t in (A, B, C, D))
    return grads, (torch.empty((2, bt, -(-di // BWD_CHANNELS), s, n), **f32),
                   torch.empty((bt, di, n), **f32),
                   torch.empty((bt, di), **f32))


def selective_scan_cuda(u, dt, A, B, C, D, *, states: bool = False):
    """Launch the CUDA kernel. ``u``: (Bt, S, di) float32 or bfloat16;
    ``dt``: (Bt, S, di) f32; ``A``: (di, N) f32 with N <= ``MAX_STATE``;
    ``B``/``C``: (Bt, S, N) f32; ``D``: (di,) f32; all contiguous.
    Returns ``(y (Bt, S, di) in u's dtype, h_last (Bt, di, N) f32)``;
    with ``states``, also the state entering each ``CHUNK``-step chunk,
    (Bt, ceil(S / CHUNK), di, N) f32, from the ``kStates`` instance."""
    bt, s, di = u.shape
    n = A.shape[-1]
    lanes, _ = plan(bt, di, n)
    _check_args(u, dt, A, B, C, D)
    y, h_last, chunk_states = outputs(u, n, states)
    KERNEL.launch(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                  chunk_states.data_ptr() if states else None, bt, s, di, n,
                  DTYPES[u.dtype], lanes)
    return (y, h_last, chunk_states) if states else (y, h_last)


def selective_scan_backward_cuda(u, dt, A, B, C, D, states, dy,
                                 dh_last=None):
    """Launch the backward kernels (P3): the reverse walk, then the sums
    of its partials, one count. ``u``..``D`` as ``selective_scan_cuda``
    takes them; ``states`` its ``states=True`` output; ``dy`` (Bt, S, di)
    in u's dtype; ``dh_last`` (Bt, di, N) f32 or None (zero); all
    contiguous. Returns (du in u's dtype, ddt, dA, dB, dC, dD in f32)."""
    bt, s, di = u.shape
    n = A.shape[-1]
    plan(bt, di, n)             # raises on a state size no kernel takes
    _check_args(u, dt, A, B, C, D)
    check_cuda("states", states, torch.float32, (bt, -(-s // CHUNK), di, n))
    check_cuda("dy", dy, u.dtype, u.shape)
    if dh_last is not None:
        check_cuda("dh_last", dh_last, torch.float32, (bt, di, n))
    (du, ddt, dA, dB, dC, dD), (part_bc, part_a, part_d) = \
        backward_outputs(u, dt, A, B, C, D)
    BACKWARD.launch(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), D.data_ptr(), states.data_ptr(),
                    dy.data_ptr(),
                    dh_last.data_ptr() if dh_last is not None else None,
                    du.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                    dB.data_ptr(), dC.data_ptr(), dD.data_ptr(),
                    part_bc[0].data_ptr(), part_bc[1].data_ptr(),
                    part_a.data_ptr(), part_d.data_ptr(), bt, s, di, n,
                    DTYPES[u.dtype])
    return du, ddt, dA, dB, dC, dD


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


def backward_grid(bt: int, di: int) -> tuple[int, int]:
    """(blocks, waves) of the backward's walk: a block per (batch row,
    ``BWD_CHANNELS`` channels), ``BWD_BLOCKS_PER_SM`` of them on each of
    the ``SMS`` multiprocessors at once."""
    blocks = bt * -(-di // BWD_CHANNELS)
    return blocks, blocks / (SMS * BWD_BLOCKS_PER_SM)


def cost_backward(bt: int, s: int, di: int, n: int, u_elem: int):
    """(FP32 operations, bytes) of one backward call (P3) — the arithmetic
    of its bound in ``PERF.md`` §6: the work the gradient needs, whatever
    the design. Per (batch, step, channel, state): the
    rebuilt state (dt*A, the exponential, du*B, one FMA), g += C dy, and
    the terms and sums of dC, dB, sum_n g B, p = g a h_{t-1}, sum_n A p
    and dA, and g *= a: 20; per (batch, step, channel): dt*u and the FMAs
    of du, ddt and dD: 7. u, dy and du move at ``u_elem`` bytes a
    (batch, step, channel), dt and ddt at 4; B, C, dB, dC once a (batch,
    step, state); the chunk states and dh_last read once; A, D read and
    dA, dD written once. The partial sums the design adds are not
    counted (``partial_bytes``)."""
    ops = 20 * bt * s * di * n + 7 * bt * s * di
    nbytes = bt * s * di * (3 * u_elem + 8) \
        + 4 * (4 * bt * s * n + bt * -(-s // CHUNK) * di * n + bt * di * n
               + 2 * (di * n + di))
    return ops, nbytes


def partial_bytes(bt: int, s: int, di: int, n: int) -> int:
    """Bytes of the backward's partial sums, written once and read once by
    its second launch: dB and dC per (batch, step, state) for each
    ``BWD_CHANNELS``-channel block, dA and dD per batch row."""
    return 2 * 4 * (2 * bt * -(-di // BWD_CHANNELS) * s * n
                    + bt * di * (n + 1))
