"""The port's fused ops — the fleet loop's and the served model's —
dispatched by the device of their tensors: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel or raises. There is no fallback from one to the other and no
switch to choose.

Given FakeTensors (``obs.prof`` counting a step under a
``FakeTensorMode``), an op launches nothing: it records its kernel's
``cost`` through ``_build.record_cost`` and returns empty outputs of the
kernel's shapes.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import best_response as _best_response
from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import dqn_head as _dqn_head
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import int8_matmul as _int8_matmul
from repro_torch.kernels import selective_scan as _selective_scan
from repro_torch.kernels import tabular_rl as _tabular_rl
from repro_torch.kernels._build import record_cost
from repro_torch.kernels.ref import NEG_INF


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused op path for device {t.device}")
    return t.device.type


def fused_tabular_update(q, s, a, r, s2, *, alpha: float, gamma: float):
    """Fused tabular act+update: ``q`` (cells, S, K) f32 is updated IN
    PLACE; ``s``/``a``/``s2`` (cells,) int32, ``r`` (cells,) f32.
    Returns ``(q, greedy2, td)``; see ``ref.fused_tabular_ref``."""
    if is_fake(q):
        record_cost("tabular_rl", *_tabular_rl.cost(*q.shape))
        return (q, s.new_empty(s.shape, dtype=torch.int32),
                r.new_empty(r.shape, dtype=torch.float32))
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
    if is_fake(active):
        cells, users = active.shape
        record_cost("dqn_head", *_dqn_head.cost(
            cells, users, agg.shape[1], w2.shape[0], w3.shape[1],
            threshold, topk))
        return (active.new_empty((cells, users), dtype=torch.int32),
                active.new_empty((cells, users, w3.shape[1])))
    allowed_f = allowed.to(torch.float32)
    fn = _dqn_head.plain if _route(active) == "cpu" else \
        _dqn_head.dqn_head_cuda
    return fn(active, member, end_b, agg, w1, b1, w2, b2, w3, b3, allowed_f,
              acc_table, threshold=threshold, topk=topk)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Prefill attention. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) ->
    (B, Sq, H, hd), q right-aligned against the kv sequence; see
    ``ref.attention_ref``."""
    if is_fake(q):
        b, sq, h, hd = q.shape
        record_cost("flash_attention", *_flash_attention.cost(
            b, sq, k.shape[1], h, k.shape[2], hd, q.element_size(),
            causal=causal, window=window))
        return torch.empty_like(q)
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
    if is_fake(q):
        b, h, hd = q.shape
        record_cost("decode_attention", *_decode_attention.cost(
            b, h, k_cache.shape[2], hd, k_cache.shape[1], q.element_size()))
        return torch.empty_like(q)
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
    if is_fake(x_q):
        (m, k), n = x_q.shape, w_q.shape[1]
        out = x_q.new_empty((m, n), dtype=out_dtype)
        record_cost("int8_matmul", *_int8_matmul.cost(m, k, n,
                                                      out.element_size()))
        return out
    fn = _int8_matmul.plain if _route(x_q) == "cpu" else \
        _int8_matmul.int8_matmul_cuda
    return fn(x_q, sx, w_q, sw, out_dtype)


def selective_scan(u, dt, A, B, C, D):
    """Mamba-1 selective scan. u, dt: (Bt, S, di); A: (di, N); B, C: (Bt,
    S, N) (slices of a projection are made contiguous here); D: (di,).
    Returns ``(y (Bt, S, di) in u's dtype, h_last (Bt, di, N) f32)``; see
    ``ref.selective_scan_ref``."""
    if is_fake(u):
        bt, seq, di = u.shape
        record_cost("selective_scan", *_selective_scan.cost(
            bt, seq, di, A.shape[1], u.element_size()))
        return (torch.empty_like(u),
                u.new_empty((bt, di, A.shape[1]), dtype=torch.float32))
    if _route(u) == "cpu":
        return _selective_scan.plain(u, dt, A, B, C, D)
    return _selective_scan.selective_scan_cuda(
        u.contiguous(), dt.contiguous(), A.contiguous(), B.contiguous(),
        C.contiguous(), D.contiguous())


def best_response_round(idx, pu_table, end_b, edge_b, member, feas, cand_e,
                        cand_c, cell_edge, edge_capacity,
                        cloud_servers: float, calib=None, packed=None):
    """One Gauss-Seidel round of the coupled-fleet oracle over every cell
    in order. idx/edge_b/cell_edge: (cells,) int32; pu_table: (K, N);
    end_b: (cells, N) int32; member: (cells, N) bool; feas: (cells, K)
    bool; cand_e/cand_c: (cells, K) int32; edge_capacity: (n_edges,)
    f32; ``packed``, the kernel's form of ``pu_table``
    (``best_response.pack_actions``), packed here when not given. Returns
    ``(new_idx, changed)``; see ``best_response.plain``."""
    if is_fake(idx):
        record_cost("best_response", *_best_response.cost(
            idx.shape[0], pu_table.shape[0], pu_table.shape[1],
            edge_capacity.shape[0]))
        return torch.empty_like(idx), idx.new_empty((), dtype=torch.bool)
    if _route(idx) == "cpu":
        return _best_response.plain(idx, pu_table, end_b, edge_b, member,
                                    feas, cand_e, cand_c, cell_edge,
                                    edge_capacity, cloud_servers, calib)
    if packed is None:
        packed = _best_response.pack_actions(pu_table)
    return _best_response.best_response_cuda(
        idx, packed, end_b, edge_b, member, feas, cand_e, cand_c, cell_edge,
        edge_capacity, cloud_servers, calib)
