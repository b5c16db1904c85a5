"""The port's fused ops — the fleet loop's and the served model's —
dispatched by the device of their tensors: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel or raises. There is no fallback from one to the other and no
switch to choose.

Given FakeTensors (``obs.prof`` counting a step under a
``FakeTensorMode``), an op launches nothing: it records its kernel's
``cost`` through ``_build.record_cost`` and allocates what the launch
path allocates (outputs, workspaces, the decode bias row, the training
instances' ``kLse`` / ``kStates`` buffers) through the kernel module's
own ``outputs``, so a traced peak of live bytes sees them. Under grad
mode the attention and the scan go through their autograd functions on
fakes too, so a traced training step records K3's and K6's training
instances and their backwards, P2 and P3.
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
        return (q,) + _tabular_rl.outputs(q)
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
    if is_fake(active):
        cells, users = active.shape
        record_cost("dqn_head", *_dqn_head.cost(
            cells, users, agg.shape[1], w2.shape[0], w3.shape[1],
            threshold, topk))
        return _dqn_head.outputs(active, w3.shape[1])
    fn = _dqn_head.plain if _route(active) == "cpu" else \
        _dqn_head.dqn_head_cuda
    return fn(active, member, end_b, agg, w1, b1, w2, b2, w3, b3, allowed_f,
              acc_table, threshold=threshold, topk=topk)


class _FlashAttention(torch.autograd.Function):
    """K3 with its gradient: the forward saves q, k, v, o and the rows'
    log-sum-exp (the ``kLse`` instance on the card, ``plain_with_lse`` on
    the CPU); the backward is P2 (``flash_attention_backward_cuda``) on
    the card and ``plain_backward`` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        mask = dict(causal=causal, window=window, softcap=softcap)
        if is_fake(q):
            o, lse = _fake_flash(q, k, v, causal, window, lse=True)
        elif _route(q) == "cpu":
            o, lse = _flash_attention.plain_with_lse(q, k, v, **mask)
        else:
            o, lse = _flash_attention.flash_attention_cuda(q, k, v, lse=True,
                                                           **mask)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if is_fake(q):
            b, sq, h, hd = q.shape
            record_cost(_flash_attention.BACKWARD.name,
                        *_flash_attention.cost_backward(
                            b, sq, k.shape[1], h, k.shape[2], hd,
                            q.element_size(), causal=ctx.mask["causal"],
                            window=ctx.mask["window"]))
            return _flash_attention.backward_outputs(q, k, v, lse)[:3] + \
                (None, None, None)
        fn = _flash_attention.plain_backward if _route(q) == "cpu" else \
            _flash_attention.flash_attention_backward_cuda
        dq, dk, dv = fn(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None


def _fake_flash(q, k, v, causal, window, lse=False):
    """K3 on fakes: its cost recorded, its outputs allocated."""
    b, sq, h, hd = q.shape
    record_cost(_flash_attention.KERNEL.name, *_flash_attention.cost(
        b, sq, k.shape[1], h, k.shape[2], hd, q.element_size(),
        causal=causal, window=window, lse=lse))
    return _flash_attention.outputs(q, lse)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Prefill attention. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) ->
    (B, Sq, H, hd), q right-aligned against the kv sequence, each scaled
    score capped as ``tanh(s / softcap) * softcap`` where ``softcap >
    0``; see ``ref.attention_ref``. Differentiable: where grad mode is on
    and an input requires grad, the call goes through ``_FlashAttention``
    (K3 with its row log-sum-exp, P2 for the gradient); otherwise it is
    the serving call."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    if is_fake(q):
        return _fake_flash(q, k, v, causal, window)[0]
    fn = _flash_attention.plain if _route(q) == "cpu" else \
        _flash_attention.flash_attention_cuda
    return fn(q, k, v, causal=causal, window=window, softcap=softcap)


def decode_attention(q, k_cache, v_cache, kv_pos, cur_pos, *,
                     window: int = 0, softcap: float = 0.0):
    """One query token against a cache. q: (B, H, hd); caches: (B, S,
    KV, hd); kv_pos: (B, S) absolute position of each slot (-1 empty);
    cur_pos: (B,). A slot attends iff ``0 <= kv_pos <= cur_pos`` (and
    ``kv_pos > cur_pos - window`` with a window), carried into the
    kernel as an additive float32 bias row; ``softcap > 0`` caps each
    scaled score before the bias."""
    valid = (kv_pos >= 0) & (kv_pos <= cur_pos[:, None])
    if window:
        valid &= kv_pos > cur_pos[:, None] - window
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    if is_fake(q):
        b, h, hd = q.shape
        record_cost("decode_attention", *_decode_attention.cost(
            b, h, k_cache.shape[2], hd, k_cache.shape[1], q.element_size()))
        return _decode_attention.outputs(q, k_cache)[0]
    fn = _decode_attention.plain if _route(q) == "cpu" else \
        _decode_attention.decode_attention_cuda
    return fn(q, k_cache, v_cache, bias, softcap)


def int8_matmul(x_q, sx, w_q, sw, *, out_dtype=torch.float32):
    """(M, K) int8 x (K, N) int8 -> (M, N) ``(acc * sx) * sw`` with ``sx``
    (M, 1) and ``sw`` (1, N), rounded once to ``out_dtype``; see
    ``ref.int8_matmul_ref``. With a leading expert axis on every operand
    ((E, M, K), (E, M, 1), (E, K, N), (E, 1, N)) the E products take one
    launch. On the card each ``w_q`` must be K-major (strides (1, K));
    see ``kernels/int8_matmul.py``."""
    if is_fake(x_q):
        *lead, m, k = x_q.shape
        n = w_q.shape[-1]
        batched = (x_q, w_q) if lead else (x_q[None], w_q[None])
        out = _int8_matmul.operands(*batched, out_dtype)[2]
        record_cost("int8_matmul", *_int8_matmul.cost(
            m, k, n, out.element_size(), lead[0] if lead else 1))
        return out if lead else out[0]
    fn = _int8_matmul.plain if _route(x_q) == "cpu" else \
        _int8_matmul.int8_matmul_cuda
    return fn(x_q, sx, w_q, sw, out_dtype)


class _SelectiveScan(torch.autograd.Function):
    """K6 with its gradient: the forward saves its inputs and the state
    entering every 32-step chunk (the ``kStates`` instance on the card;
    ``plain`` on the CPU, which needs none); the backward is P3
    (``selective_scan_backward_cuda``) on the card and ``plain_backward``
    on the CPU. A gradient autograd leaves out (h_last's, where only y
    is used) reaches the backward as None and is taken as zero."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D):
        ctx.set_materialize_grads(False)
        if is_fake(u):
            y, h_last, states = _fake_scan(u, A, states=True)
        elif _route(u) == "cpu":
            (y, h_last), states = _selective_scan.plain(u, dt, A, B, C, D), \
                None
        else:
            y, h_last, states = _selective_scan.selective_scan_cuda(
                u, dt, A, B, C, D, states=True)
        ctx.save_for_backward(u, dt, A, B, C, D, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, dt, A, B, C, D, states = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        if is_fake(u):
            bt, seq, di = u.shape
            record_cost(_selective_scan.BACKWARD.name,
                        *_selective_scan.cost_backward(
                            bt, seq, di, A.shape[1], u.element_size()))
            return _selective_scan.backward_outputs(u, dt, A, B, C, D)[0]
        if _route(u) == "cpu":
            return _selective_scan.plain_backward(u, dt, A, B, C, D, dy,
                                                  dh_last)
        return _selective_scan.selective_scan_backward_cuda(
            u, dt, A, B, C, D, states, dy, dh_last)


def _fake_scan(u, A, states=False):
    """K6 on fakes: its cost recorded, its outputs allocated."""
    bt, seq, di = u.shape
    record_cost(_selective_scan.KERNEL.name, *_selective_scan.cost(
        bt, seq, di, A.shape[1], u.element_size()))
    return _selective_scan.outputs(u, A.shape[1], states)


def selective_scan(u, dt, A, B, C, D):
    """Mamba-1 selective scan. u, dt: (Bt, S, di); A: (di, N); B, C: (Bt,
    S, N) (slices of a projection are made contiguous here); D: (di,).
    Returns ``(y (Bt, S, di) in u's dtype, h_last (Bt, di, N) f32)``; see
    ``ref.selective_scan_ref``. Differentiable: where grad mode is on and
    an input requires grad, the call goes through ``_SelectiveScan`` (K6
    writing its chunk states, P3 for the gradient); otherwise it is the
    serving call."""
    args = tuple(t.contiguous() for t in (u, dt, A, B, C, D))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    if is_fake(u):
        return _fake_scan(u, A)[:2]
    if _route(u) == "cpu":
        return _selective_scan.plain(*args)
    return _selective_scan.selective_scan_cuda(*args)


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
        if packed is None:
            _best_response.pack_actions(pu_table)
        record_cost("best_response", *_best_response.cost(
            idx.shape[0], pu_table.shape[0], pu_table.shape[1],
            edge_capacity.shape[0]))
        return _best_response.outputs(idx, pu_table.shape[0],
                                      edge_capacity.shape[0])[:2]
    if _route(idx) == "cpu":
        return _best_response.plain(idx, pu_table, end_b, edge_b, member,
                                    feas, cand_e, cand_c, cell_edge,
                                    edge_capacity, cloud_servers, calib)
    if packed is None:
        packed = _best_response.pack_actions(pu_table)
    return _best_response.best_response_cuda(
        idx, packed, end_b, edge_b, member, feas, cand_e, cand_c, cell_edge,
        edge_capacity, cloud_servers, calib)
