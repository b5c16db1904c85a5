"""Single-token (decode) attention over a KV cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention_kernel``, body ``_kernel``): one query token per
sequence against the whole cache, an additive bias row for invalid or
out-of-window slots added before the max, GQA per kv head, float32
softmax state. The ring layout of the cache stays outside: the caller's
slot positions decide validity through the bias (``ops.decode_attention``).

Bound on the H100: bytes — each step reads the layer's whole cache for
one or two operations per byte. The kernel splits the cache into ranges
of whole 64-slot tiles (``split_plan``): a partial kernel runs one block
per (split, kv head, batch), reads each slot of its range once for the
G query heads with 16-byte loads into registers, the next rows in
flight while these are used, and writes each split's float32 (m, l,
acc) to a workspace this wrapper allocates; a merge kernel rescales the
splits into o. One C entry point (``decode_attention_launch``, bound through
``ctypes`` by ``kernels/_build.py``) launches both, so one call counts
one launch. See the source note in the ``.cu`` file.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (F, I, P, CudaKernel, check_aligned,
                                        check_cuda)

KERNEL = CudaKernel("decode_attention", [P] * 6 + [I] * 6 + [F, I])

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
#: kernel dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits on query heads per kv head and on G * head_dim
MAX_GROUP, MAX_GROUP_DIMS = 16, 1024
#: cache slots per tile: a split spans a whole number of tiles
TILE = 64
#: streaming multiprocessors of the H100 SXM; the plan aims for two
#: blocks on each
SMS = 132
#: shared memory one block may spend on its range's float32 scores (G x
#: span), which bounds the span
SCORE_BYTES = 32 * 1024

#: the plain version (a CPU tensor takes it)
plain = ref.decode_attention_ref


def split_plan(b: int, n_kv: int, s: int, g: int) -> tuple[int, int]:
    """``(splits, span)`` for a cache of ``s`` slots read by ``b * n_kv``
    (batch, kv head) pairs of ``g`` query heads each: ``span`` is a
    whole number of tiles, split ``i`` covers slots ``[i * span, min(s,
    (i + 1) * span))``, so every slot is read once and only the last
    split may be partial. The span is the largest that still gives
    ``b * n_kv * splits >= 2 * SMS`` blocks where the cache has that
    many tiles, and at most ``SCORE_BYTES / (4 g)`` slots."""
    tiles = -(-s // TILE)
    want = -(-2 * SMS // (b * n_kv))
    span_tiles = max(1, min(tiles // want, SCORE_BYTES // (4 * g * TILE)))
    return -(-tiles // span_tiles), span_tiles * TILE


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
    check_aligned(q=q, k_cache=k_cache, v_cache=v_cache)
    o = torch.empty_like(q)
    splits, span = split_plan(b, n_kv, s, g)
    ws = (torch.empty((b, h, splits, hd + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else o)
    KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  bias.data_ptr(), ws.data_ptr(), o.data_ptr(), b, s, h,
                  n_kv, hd, span, 1.0 / math.sqrt(hd), DTYPES[q.dtype])
    return o


def cost(b: int, h: int, n_kv: int, hd: int, slots: int, elem: int):
    """(operations, bytes) of one call — the arithmetic of the bound in
    ``PERF.md`` §6: both caches read whole, q and o, the float32 bias
    row; 2 * 2 * hd per (head, slot)."""
    return 4 * hd * b * h * slots, (2 * elem * b * slots * n_kv * hd
                                    + 2 * elem * b * h * hd + 4 * b * slots)
