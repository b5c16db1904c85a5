"""Single-token (decode) attention over a KV cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention_kernel``, body ``_kernel``): one query token per
sequence against the whole cache, an additive bias row for invalid or
out-of-window slots added before the max, GQA per kv head, float32
softmax state. The ring layout of the cache stays outside: the caller's
slot positions decide validity through the bias (``ops.decode_attention``).

Bound on the H100: bytes — each step reads the layer's whole cache for
one or two operations per byte. One block per (batch, kv head) reads
that head's cache once for its G query heads (see the source note in
the ``.cu`` file).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import F, I, P, CudaKernel, check_cuda

KERNEL = CudaKernel("decode_attention", [P] * 5 + [I] * 5 + [F, I])

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
#: kernel dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits on query heads per kv head and on G * head_dim
MAX_GROUP, MAX_GROUP_DIMS = 16, 1024

#: the plain version (a CPU tensor takes it)
plain = ref.decode_attention_ref


def decode_attention_cuda(q, k_cache, v_cache, bias):
    """Launch the CUDA kernel. ``q``: (B, H, hd); caches: (B, S, KV, hd)
    in q's dtype (float32 or bfloat16); ``bias``: (B, S) float32; all
    contiguous. Returns (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel has head_dim "
                         f"{HEAD_DIMS}, got {hd}")
    if n_kv < 1 or h % n_kv:
        raise ValueError(f"{h} q heads are not a multiple of {n_kv} kv heads")
    g = h // n_kv
    if g > MAX_GROUP or g * hd > MAX_GROUP_DIMS:
        raise ValueError(f"decode_attention kernel takes at most "
                         f"{MAX_GROUP} q heads per kv head and G*hd <= "
                         f"{MAX_GROUP_DIMS}, got G={g}, hd={hd}")
    check_cuda("q", q, q.dtype)
    check_cuda("k_cache", k_cache, q.dtype, (b, s, n_kv, hd))
    check_cuda("v_cache", v_cache, q.dtype, (b, s, n_kv, hd))
    check_cuda("bias", bias, torch.float32, (b, s))
    o = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  bias.data_ptr(), o.data_ptr(), b, s, h, n_kv, hd,
                  1.0 / math.sqrt(hd), DTYPES[q.dtype])
    return o
