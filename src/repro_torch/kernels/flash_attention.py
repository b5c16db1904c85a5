"""Blocked online-softmax (prefill) attention: the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_kernel``, body ``_kernel``): causal and sliding-window
masks with whole-tile skips, GQA by mapping q head ``h`` to kv head ``h
// G`` (no K/V repeated in device memory), q right-aligned against the
kv sequence, float32 softmax state and accumulator. Without a mask
(``causal=False``, no window: an encoder's self-attention, a decoder's
cross-attention onto its encoder's frames) Sq and Skv are free. A
logit soft-cap (``softcap > 0``, which the Pallas kernel lacks and the
reference's model layer applies in jnp) caps each scaled score as
``tanh(s / softcap) * softcap`` before the mask, in instances of their
own, so the instances without a cap are unchanged.

Bound on the H100: operations from ~128 tokens up, bytes below. The
bfloat16 instance (every served config) runs both products on the
tensor cores: one warpgroup per 64-row q tile, K/V tiles in a 2-stage
``cp.async`` ring in swizzled shared memory (at head_dim 128 and 256 as
64-column atoms, 81 and 161 KB a block), S = Q K^T and O += P V as
``wgmma`` with P in registers and V read MN-major. The float32
instance stays on the CUDA cores (no full-precision float32 on the
tensor cores, and TF32 stays off; eight lanes split a q row's dims at
every head_dim); the launcher picks by dtype. See the
source note in the ``.cu`` file. The wrapper takes the model's own
``(B, S, H, hd)`` layout, so nothing is transposed or padded around the
launch; it binds the plain C entry point ``flash_attention_launch``
through ``ctypes`` (``kernels/_build.py``).

Training (``ops.flash_attention`` under autograd): the forward's
``lse=True`` instances (template flag ``kLse``) also write each q row's
log-sum-exp, and the backward, P2 (``csrc/flash_attention_backward.cu``,
port-only: the reference differentiates its jnp mirrors with
``jax.grad``), recomputes P from it and writes dq, dk and dv (dk and dv
summed over the G q heads of each kv head, no atomics). Its bfloat16
instance runs its products on the tensor cores as K3's forward does: a
dK/dV kernel per 64 kv rows (S^T = K Q^T and dP^T = V dO^T by
``wgmma``, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
register operands, the Q and dO tiles through a 2-stage ``cp.async``
ring; two warpgroups at head_dim 128 and 256) and a dQ kernel per 64 q
rows; its float32 instance stays on the CUDA cores. Its plain version
is ``plain_backward``, the explicit formulas; ``plain_with_lse`` is the
forward's with the log-sum-exp.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (F, I, P, CudaKernel, check_aligned,
                                        check_cuda)

KERNEL = CudaKernel("flash_attention", [P] * 5 + [I] * 9 + [F, F, I])
#: the backward, P2: q, k, v, o, lse, dO, dq, dk, dv and the D scratch
BACKWARD = CudaKernel("flash_attention_backward",
                      [P] * 10 + [I] * 9 + [F, F, I])

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: kernel dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain(q, k, v, *, causal: bool = True, window: int = 0,
          softcap: float = 0.0):
    """The plain version (a CPU tensor takes it): exact attention,
    ``ref.attention_ref``."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)


def plain_with_lse(q, k, v, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0):
    """``plain``'s output (the same values) and each q row's log-sum-exp
    over its kept scores, (B, H, Sq) float32: the forward of training on
    a CPU tensor."""
    s = ref.attention_scores_ref(q, k, causal=causal, window=window,
                                 softcap=softcap)
    o = ref.attention_from_scores(s, v, q.dtype)
    b, sq, h, _ = q.shape
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def plain_backward(q, k, v, o, lse, do, *, causal: bool = True,
                   window: int = 0, softcap: float = 0.0):
    """The backward's plain version from its explicit formulas, in
    float32: with s the scaled (capped) scores, P = exp(s - lse) where
    kept, D = rowsum(dO o), dS = P (dO v^T - D) (times 1 - tanh^2 under a
    cap), dq = scale dS k, dk = scale dS^T q and dv = P^T dO, dk and dv
    summed over each kv head's q heads. ``lse``: (B, H, Sq) float32, the
    forward's. Returns (dq, dk, dv) in the inputs' dtype. One batch row
    at a time, so the (KV, G, Sq, Skv) temporaries are one row's."""
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    scale = 1.0 / math.sqrt(hd)
    mask = ref.attention_mask(sq, skv, causal, window, q.device)
    outs = []
    for i in range(b):
        qg = q[i].float().reshape(sq, n_kv, g, hd)
        dog = do[i].float().reshape(sq, n_kv, g, hd)
        kf, vf = k[i].float(), v[i].float()
        x = torch.einsum("qkgh,skh->kgqs", qg, kf) * scale
        if softcap:
            t = torch.tanh(x / softcap)
            x = t * softcap
        p = torch.where(mask, torch.exp(x - lse[i].reshape(n_kv, g, sq, 1)),
                        0.0)
        dv = torch.einsum("kgqs,qkgh->skh", p, dog)
        dp = torch.einsum("qkgh,skh->kgqs", dog, vf)
        d = (dog * o[i].float().reshape(sq, n_kv, g, hd)).sum(-1)
        ds = p * (dp - d.permute(1, 2, 0)[..., None])
        if softcap:
            ds = ds * (1.0 - t * t)
        dq = torch.einsum("kgqs,skh->qkgh", ds, kf) * scale
        dk = torch.einsum("kgqs,qkgh->skh", ds, qg) * scale
        outs.append((dq.reshape(sq, h, hd), dk, dv))
    dq, dk, dv = (torch.stack(t) for t in zip(*outs))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_args(q, k, v, softcap):
    """The checks both kernels make of their common arguments."""
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has head_dim {HEAD_DIMS},"
                         f" got {hd}")
    if n_kv < 1 or h % n_kv:
        raise ValueError(f"{h} q heads are not a multiple of {n_kv} kv heads")
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    check_cuda("q", q, q.dtype)
    check_cuda("k", k, q.dtype, (b, skv, n_kv, hd))
    check_cuda("v", v, q.dtype, (b, skv, n_kv, hd))
    check_aligned(q=q, k=k, v=v)


def outputs(q, lse: bool = False):
    """What a forward launch allocates: o (B, Sq, H, hd) in q's dtype and,
    for the ``kLse`` instance, the rows' log-sum-exp (B, H, Sq) float32
    (else None)."""
    b, sq, h, _ = q.shape
    return torch.empty_like(q), (q.new_empty((b, h, sq), dtype=torch.float32)
                                 if lse else None)


def backward_outputs(q, k, v, lse):
    """What a backward launch allocates: dq, dk, dv in their inputs'
    shapes and dtype, and the float32 D scratch, one value a q row."""
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(lse))


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, lse: bool = False):
    """Launch the CUDA kernel. ``q``: (B, Sq, H, hd); ``k``/``v``: (B,
    Skv, KV, hd), one dtype (float32 or bfloat16), contiguous, H a
    multiple of KV, hd in ``HEAD_DIMS``; ``softcap`` >= 0 (0: none).
    Returns (B, Sq, H, hd) in q's dtype; with ``lse``, (that, the rows'
    log-sum-exp (B, H, Sq) float32) from the ``kLse`` instance."""
    _check_args(q, k, v, softcap)
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    o, row_lse = outputs(q, lse)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  row_lse.data_ptr() if lse else None, b, sq, skv, h, n_kv,
                  hd, int(bool(causal)), int(window), skv - sq,
                  1.0 / math.sqrt(hd), float(softcap), DTYPES[q.dtype])
    return (o, row_lse) if lse else o


def flash_attention_backward_cuda(q, k, v, o, lse, do, *,
                                  causal: bool = True, window: int = 0,
                                  softcap: float = 0.0):
    """Launch the backward kernels (P2): D, then dk/dv, then dq, one
    count. ``q``, ``k``, ``v`` as ``flash_attention_cuda`` takes them;
    ``o`` and ``do`` (B, Sq, H, hd) in their dtype, contiguous; ``lse``
    (B, H, Sq) float32, the forward's. A mask (``causal`` or a window)
    needs Sq <= Skv (q right-aligned; no training call has more q rows
    than kv rows). Returns (dq, dk, dv) in q's dtype."""
    _check_args(q, k, v, softcap)
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    if (causal or window) and sq > skv:
        raise ValueError(f"the attention backward takes a mask only with Sq "
                         f"<= Skv, got Sq {sq} > Skv {skv}")
    check_cuda("o", o, q.dtype, q.shape)
    check_cuda("do", do, q.dtype, q.shape)
    check_cuda("lse", lse, torch.float32, (b, h, sq))
    check_aligned(o=o, do=do)
    dq, dk, dv, d = backward_outputs(q, k, v, lse)
    BACKWARD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), d.data_ptr(), b, sq, skv,
                    h, n_kv, hd, int(bool(causal)), int(window), skv - sq,
                    1.0 / math.sqrt(hd), float(softcap), DTYPES[q.dtype])
    return dq, dk, dv


def cost(b: int, sq: int, skv: int, h: int, n_kv: int, hd: int,
         elem: int, *, causal: bool = True, window: int = 0,
         lse: bool = False):
    """(operations, bytes) of one call — the arithmetic of the bound in
    ``PERF.md`` §6: 2 * 2 * hd per (q, k) pair the mask keeps (q
    right-aligned against the kv sequence), q, k, v read and o written
    once at ``elem`` bytes a value; the ``kLse`` instance (``lse``) also
    writes a float32 a q row and head. Counted on the host in numpy, so
    it holds under ``FakeTensorMode`` too."""
    q_pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(q_pos, skv - 1) if causal else \
        np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(q_pos - window + 1, 0) if window else \
        np.zeros(sq, dtype=np.int64)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    return 4 * hd * b * h * pairs, elem * b * hd * (2 * sq * h
                                                     + 2 * skv * n_kv) \
        + (4 * b * h * sq if lse else 0)


def cost_backward(b: int, sq: int, skv: int, h: int, n_kv: int, hd: int,
                  elem: int, *, causal: bool = True, window: int = 0):
    """(operations, bytes) of one backward call (P2): 10 hd per kept (q,
    k) pair (the products S = q k^T, dP = dO v^T, dv += P^T dO, dk += dS^T
    q and dq += dS k, 2 hd each), q, k, v, o and dO read and dq, dk, dv
    written once at ``elem`` bytes a value, lse read and D written and
    read in float32."""
    ops_, _ = cost(b, sq, skv, h, n_kv, hd, elem, causal=causal,
                   window=window)
    return ops_ // 4 * 10, elem * b * hd * (4 * sq * h + 4 * skv * n_kv) \
        + 12 * b * h * sq
