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

Given DTensors (a model mesh, ``distributed.sharding``), K3, K4, K5 and
K6 run on the local shards through ``local_map``, each at the
placements it accepts (``_attention_places``, ``_decode_places``,
``_matmul_places``, ``_sharded_scan``): the call on each rank's shards is
the same call as above, so the card launches its kernel, the CPU takes
the plain version and a fake records the local shard's cost. K4 over a
cache sharded along its length runs its ``kLse`` instance on each
rank's slots and merges the ranks' rows by all-reduces of the row max
and of the rescaled sums and outputs (``_merge_over``).
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
from repro_torch.distributed.sharding import (_k_major, is_dtensor,
                                              on_shards, places, settled,
                                              shard_dims)
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
    if is_dtensor(q):
        return _sharded_flash(q, k, v, causal, window, softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    if is_fake(q):
        return _fake_flash(q, k, v, causal, window)[0]
    fn = _flash_attention.plain if _route(q) == "cpu" else \
        _flash_attention.flash_attention_cuda
    return fn(q, k, v, causal=causal, window=window, softcap=softcap)


def _attention_places(q, k):
    """K3's placements for q (B, Sq, H, hd) and k, v (B, Skv, KV, hd):
    the batch where q shards it, q's heads where q shards them, the kv
    heads where k shards them beside q's; everything else replicated.
    Where q's heads are split and the kv heads are not, each rank keeps
    the one kv head its q heads read (``kv_pick``: mesh dim, q heads a
    kv head), or q's heads are gathered where a rank's q heads span
    more than one kv head. Returns (q's, k's placements, kv_pick)."""
    qs, ks = shard_dims(q), shard_dims(k)
    mesh = q.device_mesh
    qd = {i: d for i, d in qs.items() if d in (0, 2)}
    kd = {i: 0 for i, d in qd.items() if d == 0}
    pick = None
    for i, d in list(qd.items()):
        if d != 2:
            continue
        if ks.get(i) == 2:
            kd[i] = 2
            continue
        g = q.shape[2] // k.shape[2]
        h_loc = q.shape[2] // mesh.size(i)
        if g % h_loc == 0 and pick is None:
            pick = (i, g)
        else:
            del qd[i]
    return places(mesh.ndim, qd), places(mesh.ndim, kd), pick


def _sharded_flash(q, k, v, causal, window, softcap):
    """K3 over the local shards (``_attention_places``)."""
    qp, kp, pick = _attention_places(q, k)
    first = None
    if pick is not None:
        i, g = pick
        h_loc = q.shape[2] // q.device_mesh.size(i)
        first = q.device_mesh.get_local_rank(i) * h_loc // g

    def local(ql, kl, vl):
        if first is not None:
            kl = kl[:, :, first:first + 1].contiguous()
            vl = vl[:, :, first:first + 1].contiguous()
        return flash_attention(ql, kl, vl, causal=causal, window=window,
                               softcap=softcap)
    return on_shards(local, (q, k, v), (qp, kp, kp), qp)


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
    if is_dtensor(q):
        return _sharded_decode(q, k_cache, v_cache, bias, softcap)
    return _decode(q, k_cache, v_cache, bias, softcap)


def _decode(q, k_cache, v_cache, bias, softcap, lse=False):
    """K4 on one device's tensors (its ``kLse`` instance with ``lse``,
    returning (o, row log-sum-exp (B, H) float32))."""
    if is_fake(q):
        b, h, hd = q.shape
        record_cost("decode_attention", *_decode_attention.cost(
            b, h, k_cache.shape[2], hd, k_cache.shape[1], q.element_size(),
            lse))
        out = _decode_attention.outputs(q, k_cache, lse)
        return (out[0], out[3]) if lse else out[0]
    if lse:
        fn = _decode_attention.plain_with_lse if _route(q) == "cpu" else \
            _decode_attention.decode_attention_cuda
        return fn(q, k_cache, v_cache, bias, softcap, lse=True)
    fn = _decode_attention.plain if _route(q) == "cpu" else \
        _decode_attention.decode_attention_cuda
    return fn(q, k_cache, v_cache, bias, softcap)


def _decode_places(q, k_cache):
    """K4's placements: the batch where the cache shards it; the heads
    where the cache shards its kv heads (q's heads with them, G a rank);
    the slots where it shards its length (q and its heads whole there).
    Returns (q's, the caches', the bias's placements, the mesh dims of
    the length)."""
    cs = shard_dims(k_cache)
    mesh = q.device_mesh
    qd = {i: {0: 0, 2: 1}[d] for i, d in cs.items() if d in (0, 2)}
    cd = {i: d for i, d in cs.items() if d in (0, 1, 2)}
    bd = {i: d for i, d in cs.items() if d in (0, 1)}
    return (places(mesh.ndim, qd), places(mesh.ndim, cd),
            places(mesh.ndim, bd), [i for i, d in cs.items() if d == 1])


def _merge_over(o, lse, mesh, dims):
    """The rows of K4's ``kLse`` instance over each rank's slots merged
    across the mesh dims ``dims`` that split the cache's length: the
    row max all-reduced, then each rank's output and sum rescaled to it
    and all-reduced. Returns o (B, H, hd) in o's dtype."""
    from torch.distributed import _functional_collectives as funcol
    m = lse
    for i in dims:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, i)))
    w = torch.exp(lse - m)
    num = o.float() * w[..., None]
    for i in dims:
        num = funcol.wait_tensor(funcol.all_reduce(num, "sum", (mesh, i)))
        w = funcol.wait_tensor(funcol.all_reduce(w, "sum", (mesh, i)))
    return (num / w[..., None]).to(o.dtype)


def _sharded_decode(q, k_cache, v_cache, bias, softcap):
    """K4 over the local shards (``_decode_places``); over a cache split
    along its length, the ``kLse`` instance and ``_merge_over``."""
    qp, cp, bp, dims = _decode_places(q, k_cache)
    mesh = q.device_mesh

    def local(ql, kl, vl, bl):
        if not dims:
            return _decode(ql, kl, vl, bl, softcap)
        o, lse = _decode(ql, kl, vl, bl, softcap, lse=True)
        return _merge_over(o, lse, mesh, dims)
    return on_shards(local, (q, k_cache, v_cache, bias), (qp, cp, cp, bp),
                      qp)


def int8_matmul(x_q, sx, w_q, sw, *, out_dtype=torch.float32):
    """(M, K) int8 x (K, N) int8 -> (M, N) ``(acc * sx) * sw`` with ``sx``
    (M, 1) and ``sw`` (1, N), rounded once to ``out_dtype``; see
    ``ref.int8_matmul_ref``. With a leading expert axis on every operand
    ((E, M, K), (E, M, 1), (E, K, N), (E, 1, N)) the E products take one
    launch. On the card each ``w_q`` must be K-major (strides (1, K));
    see ``kernels/int8_matmul.py``."""
    if is_dtensor(x_q):
        return _sharded_int8(x_q, sx, w_q, sw, out_dtype)
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


def _matmul_places(x_q, w_q):
    """A product's placements (K5's, and a dense one's, ``sharded_matmul``)
    for x_q (..., M, K), its scales sx (..., M, 1),
    w_q (..., K, N), its scales sw (..., 1, N) and the output, per mesh
    dim: an expert batch where w shards it (x with it); the rows M where
    x splits them (the weight gathered there, as FSDP does); a
    column-parallel weight (N split: x whole along K, the output split
    along N); a row-parallel weight (K split, x split along K with it:
    the output a ``Partial`` sum)."""
    lead = x_q.dim() - 2
    ws, xs = shard_dims(w_q), shard_dims(x_q)
    m, k, n = lead, lead + 1, lead + 1
    xd, wd, sxd, swd, od, part = {}, {}, {}, {}, {}, []
    for i in range(x_q.device_mesh.ndim):
        w, x = ws.get(i), xs.get(i)
        if lead and w == 0:                          # experts
            xd[i] = wd[i] = sxd[i] = swd[i] = od[i] = 0
        elif x == m:                                 # rows
            xd[i] = sxd[i] = od[i] = m
        elif w == lead + 1:                          # column parallel
            wd[i] = swd[i] = od[i] = n
        elif w == lead:                              # row parallel
            xd[i], wd[i] = k, lead
            part.append(i)
    nd = x_q.device_mesh.ndim
    return (places(nd, xd), places(nd, sxd), places(nd, wd),
            places(nd, swd), places(nd, od, part))


def _partial_sum(y, dtype):
    """A product's output whole, in ``dtype``: where it is a ``Partial``
    sum over ranks (a row-parallel weight), the ranks' float32 partials
    are reduced first and rounded to ``dtype`` once, as the one-device
    product rounds its float32 accumulator once."""
    from torch.distributed.tensor import Partial
    if any(isinstance(p, Partial) for p in y.placements):
        y = settled(y)
    return y.to(dtype)


def _sharded_int8(x_q, sx, w_q, sw, out_dtype):
    """K5 over the local shards (``_matmul_places``), a row-parallel
    weight's partial products in float32 (``_partial_sum``). A weight
    that comes gathered (its K-major view lost) is made K-major again on
    the card."""
    from torch.distributed.tensor import Partial
    xp, sxp, wp, swp, op = _matmul_places(x_q, w_q)
    partial = any(isinstance(p, Partial) for p in op)

    def local(xl, sxl, wl, swl):
        if wl.is_cuda and not _k_major(wl):
            wl = _int8_matmul.k_major(wl)
        return int8_matmul(xl, sxl, wl, swl, out_dtype=torch.float32
                           if partial else out_dtype)
    return _partial_sum(on_shards(local, (x_q, sx, w_q, sw),
                                   (xp, sxp, wp, swp), op), out_dtype)


def sharded_matmul(x, w):
    """``x @ w`` of a dense linear under a model mesh: x (M, K) and w (K,
    N) DTensors, the product on the local shards at ``_matmul_places``
    (column-parallel, row-parallel, rows), in x's dtype. A row-parallel
    weight's partial products are taken in float32 (the same products,
    a float32 accumulator) and reduced before the one rounding to x's
    dtype (``_partial_sum``): on the card a bf16 product with a float32
    output (``torch.mm``'s ``out_dtype``), at the tensor cores' rate."""
    from torch.distributed.tensor import Partial
    xp, _, wp, _, op = _matmul_places(x, w)
    partial = any(isinstance(p, Partial) for p in op)

    def local(xl, wl):
        wl = wl.to(xl.dtype)
        if not partial:
            return xl @ wl
        if xl.dtype == torch.float32 or _route(xl) == "cpu" \
                and not is_fake(xl):
            return xl.float() @ wl.float()      # the CPU has no mm.dtype
        return torch.mm(xl, wl, out_dtype=torch.float32)
    return _partial_sum(on_shards(local, (x, w), (xp, wp), op), x.dtype)


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
    if is_dtensor(u):
        return _sharded_scan(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    if is_fake(u):
        return _fake_scan(u, A)[:2]
    if _route(u) == "cpu":
        return _selective_scan.plain(*args)
    return _selective_scan.selective_scan_cuda(*args)


def _sharded_scan(u, dt, A, B, C, D):
    """K6 over the local shards: per mesh dim the batch where u splits
    it, or the d_inner channels (u, dt, A, D and the outputs with them;
    B and C whole there); y as u, h_last (Bt, di, N) with it."""
    nd = u.device_mesh.ndim
    bd = {i: 0 for i, d in shard_dims(u).items() if d == 0}
    cd = {i: 2 for i, d in shard_dims(u).items() if d == 2}
    up = places(nd, {**bd, **cd})
    ap = places(nd, {i: 0 for i in cd})
    bcp = places(nd, bd)
    hp = places(nd, {**bd, **{i: 1 for i in cd}})
    return on_shards(selective_scan, (u, dt, A, B, C, D),
                      (up, up, ap, bcp, bcp, ap), (up, hp))


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
