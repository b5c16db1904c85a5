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
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (F, I, P, CudaKernel, check_aligned,
                                        check_cuda)

KERNEL = CudaKernel("flash_attention", [P] * 4 + [I] * 9 + [F, F, I])

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


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    """Launch the CUDA kernel. ``q``: (B, Sq, H, hd); ``k``/``v``: (B,
    Skv, KV, hd), one dtype (float32 or bfloat16), contiguous, H a
    multiple of KV, hd in ``HEAD_DIMS``; ``softcap`` >= 0 (0: none).
    Returns (B, Sq, H, hd) in q's dtype."""
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
    o = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                  sq, skv, h, n_kv, hd, int(bool(causal)), int(window),
                  skv - sq, 1.0 / math.sqrt(hd), float(softcap),
                  DTYPES[q.dtype])
    return o


def cost(b: int, sq: int, skv: int, h: int, n_kv: int, hd: int,
         elem: int, *, causal: bool = True, window: int = 0):
    """(operations, bytes) of one call — the arithmetic of the bound in
    ``PERF.md`` §6: 2 * 2 * hd per (q, k) pair the mask keeps (q
    right-aligned against the kv sequence), q, k, v read and o written
    once at ``elem`` bytes a value."""
    q_pos = torch.arange(sq, dtype=torch.int64) + (skv - sq)
    hi = torch.clamp(q_pos, max=skv - 1) if causal else \
        torch.full_like(q_pos, skv - 1)
    lo = torch.clamp(q_pos - window + 1, min=0) if window else \
        torch.zeros_like(q_pos)
    pairs = int(torch.clamp(hi - lo + 1, min=0).sum())
    return 4 * hd * b * h * pairs, elem * b * hd * (2 * sq * h
                                                     + 2 * skv * n_kv)
