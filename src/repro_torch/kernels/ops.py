"""The port's fused ops — the fleet loop's and the served model's —
dispatched by the device of their tensors: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel or raises. There is no fallback from one to the other and no
switch to choose."""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import dqn_head as _dqn_head
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import int8_matmul as _int8_matmul
from repro_torch.kernels import selective_scan as _selective_scan
from repro_torch.kernels import tabular_rl as _tabular_rl
from repro_torch.kernels.ref import NEG_INF


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused op path for device {t.device}")
    return t.device.type


def fused_tabular_update(q, s, a, r, s2, *, alpha: float, gamma: float):
    """Fused tabular act+update: ``q`` (cells, S, K) f32 is updated IN
    PLACE; ``s``/``a``/``s2`` (cells,) int32, ``r`` (cells,) f32.
    Returns ``(q, greedy2, td)``; see ``ref.fused_tabular_ref``."""
    if _route(q) == "cpu":
        return _tabular_rl.plain(q, s, a, r, s2, alpha=alpha, gamma=gamma)
    return _tabular_rl.tabular_rl_cuda(q, s, a, r, s2, alpha=alpha,
                                       gamma=gamma)


def dqn_head(active, member, end_b, agg, params, allowed, acc_table, *,
             threshold: float, topk: int):
    """Fused featurize + constraint-aware greedy head.

    active/member/end_b: (cells, N) f32; agg: (cells, 8) f32 cell
    aggregates; params: the shared MLP (``[{"w", "b"}] * 3``, weights
    ``(in, out)``); allowed: (N, A) bool or 0/1 mask; acc_table: (A,)
    f32 accuracy ladder. Returns ``(dec, q)``; see ``ref.dqn_head_ref``.
    """
    (w1, b1), (w2, b2), (w3, b3) = [(p["w"], p["b"]) for p in params]
    allowed_f = allowed.to(torch.float32)
    fn = _dqn_head.plain if _route(active) == "cpu" else \
        _dqn_head.dqn_head_cuda
    return fn(active, member, end_b, agg, w1, b1, w2, b2, w3, b3, allowed_f,
              acc_table, threshold=threshold, topk=topk)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Prefill attention. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) ->
    (B, Sq, H, hd), q right-aligned against the kv sequence; see
    ``ref.attention_ref``."""
    fn = _flash_attention.plain if _route(q) == "cpu" else \
        _flash_attention.flash_attention_cuda
    return fn(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, kv_pos, cur_pos, *,
                     window: int = 0):
    """One query token against a cache. q: (B, H, hd); caches: (B, S,
    KV, hd); kv_pos: (B, S) absolute position of each slot (-1 empty);
    cur_pos: (B,). A slot attends iff ``0 <= kv_pos <= cur_pos`` (and
    ``kv_pos > cur_pos - window`` with a window), carried into the
    kernel as an additive float32 bias row."""
    valid = (kv_pos >= 0) & (kv_pos <= cur_pos[:, None])
    if window:
        valid &= kv_pos > cur_pos[:, None] - window
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    fn = _decode_attention.plain if _route(q) == "cpu" else \
        _decode_attention.decode_attention_cuda
    return fn(q, k_cache, v_cache, bias)


def int8_matmul(x_q, sx, w_q, sw, *, out_dtype=torch.float32):
    """(M, K) int8 x (K, N) int8 -> (M, N) ``(acc * sx) * sw`` with ``sx``
    (M, 1) and ``sw`` (1, N), rounded once to ``out_dtype``; see
    ``ref.int8_matmul_ref``. On the card ``w_q`` must be K-major (strides
    (1, K)); see ``kernels/int8_matmul.py``."""
    fn = _int8_matmul.plain if _route(x_q) == "cpu" else \
        _int8_matmul.int8_matmul_cuda
    return fn(x_q, sx, w_q, sw, out_dtype)


def selective_scan(u, dt, A, B, C, D):
    """Mamba-1 selective scan. u, dt: (Bt, S, di); A: (di, N); B, C: (Bt,
    S, N) (slices of a projection are made contiguous here); D: (di,).
    Returns ``(y (Bt, S, di) in u's dtype, h_last (Bt, di, N) f32)``; see
    ``ref.selective_scan_ref``."""
    if _route(u) == "cpu":
        return _selective_scan.plain(u, dt, A, B, C, D)
    return _selective_scan.selective_scan_cuda(
        u.contiguous(), dt.contiguous(), A.contiguous(), B.contiguous(),
        C.contiguous(), D.contiguous())
