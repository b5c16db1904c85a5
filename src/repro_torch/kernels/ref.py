"""Plain PyTorch versions of the port's kernels — the port of the oracles
in ``repro/kernels/ref.py``: the fleet loop's (K1, K2) and the served
model's (K3 attention, K4 decode attention, K5 int8 matmul, K6 the
Mamba-1 selective scan). A CPU
tensor takes these; on the card they are what ``chip_smoke.py`` holds
each CUDA kernel against.
"""
from __future__ import annotations

import itertools
import math

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, causal: bool, window: int,
                   device=None):
    """(Sq, Skv) bool: which kv positions each q row keeps, q
    right-aligned against the kv sequence; ``window > 0`` keeps kv_pos in
    (q_pos - window, q_pos]."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kv_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    return mask


def attention_scores_ref(q, k, *, causal: bool = True, window: int = 0,
                         bias=None, softcap: float = 0.0):
    """The float32 scores (B, KV, G, Sq, Skv) of ``attention_ref``: scaled,
    capped, masked to ``NEG_INF``, plus ``bias``."""
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    s = s * (1.0 / math.sqrt(hd))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(attention_mask(sq, skv, causal, window, q.device), s,
                    NEG_INF)
    if bias is not None:
        s = s + bias[:, None, None, None, :]
    return s


def attention_from_scores(s, v, dtype):
    """softmax(s) v for scores (B, KV, G, Sq, Skv): (B, Sq, H, hd) in
    ``dtype``."""
    b, n_kv, g, sq, _ = s.shape
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(b, sq, n_kv * g, v.shape[-1]).to(dtype)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  bias=None, softcap: float = 0.0):
    """Naive exact attention in float32. q: (B, Sq, H, hd); k, v: (B,
    Skv, KV, hd) with H = KV * G (q head h reads kv head h // G). q is
    right-aligned against the kv sequence; ``window > 0`` keeps kv_pos in
    (q_pos - window, q_pos]; ``bias``: (B, Skv) additive (invalid cache
    slots); ``softcap > 0`` caps each scaled score as ``tanh(s / softcap)
    * softcap`` before the mask and the bias, as the reference's model
    layer does. Returns q's dtype."""
    s = attention_scores_ref(q, k, causal=causal, window=window, bias=bias,
                             softcap=softcap)
    return attention_from_scores(s, v, q.dtype)


def decode_attention_ref(q, k_cache, v_cache, bias, softcap: float = 0.0):
    """q: (B, H, hd); caches: (B, S, KV, hd); bias: (B, S) additive;
    ``softcap`` as in ``attention_ref``."""
    return attention_ref(q[:, None], k_cache, v_cache, causal=False,
                         bias=bias, softcap=softcap)[:, 0]


def int8_matmul_ref(x_q, sx, w_q, sw):
    """x_q: (M, K) int8; sx: (M, 1) f32; w_q: (K, N) int8; sw: (1, N)
    f32 -> (M, N) f32 ``(float(acc) * sx) * sw``. The integer product is
    taken in float64, exact while |acc| < 2^53 (K <= 2^38 at int8), so
    the result is the int32 accumulation's on every device."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    return acc.to(torch.float32) * sx * sw


def quantize_ref(x, dim: int = -1):
    """Symmetric int8 quantization along ``dim`` -> (x_q, scale): scale
    = (max |x| + 1e-8) / 127, x_q = clip(round(x / scale), +-127) with
    round half to even."""
    amax = x.abs().amax(dim=dim, keepdim=True).float() + 1e-8
    s = amax / 127.0
    x_q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return x_q, s


def first_argmax_ref(x: torch.Tensor) -> torch.Tensor:
    """First-index argmax along the last axis (max, then the lowest index
    holding it), as int32 — the tie-break of ``jnp.argmax``."""
    k = x.shape[-1]
    m = x.max(-1, keepdim=True).values
    iota = torch.arange(k, dtype=torch.int32, device=x.device)
    cand = torch.where(x == m, iota, torch.tensor(k, dtype=torch.int32,
                                                  device=x.device))
    return cand.min(-1).values


def fused_tabular_ref(q, s, a, r, s2, *, alpha: float, gamma: float):
    """Fused tabular act+update, updating ``q`` IN PLACE.

    ``q``: (cells, S, K) f32; ``s``/``a``/``s2``: (cells,) int32;
    ``r``: (cells,) f32. Returns ``(q, greedy2, td)`` where

    * ``td = r + gamma * max_k q[c, s2] - q[c, s, a]`` on the table
      before the update,
    * ``q[c, s, a] += alpha * td`` (written in place, as the reference
      kernel's ``input_output_aliases`` did),
    * ``greedy2`` = first-index argmax of row ``s2`` AFTER the update
      (when ``s2 == s`` the freshly written entry takes part).
    """
    cells = torch.arange(q.shape[0], device=q.device)
    s, a, s2 = s.long(), a.long(), s2.long()
    q_sa = q[cells, s, a]
    row2 = q[cells, s2]                                    # (cells, K)
    td = r + gamma * row2.max(-1).values - q_sa
    v_new = q_sa + alpha * td
    col = torch.arange(q.shape[2], device=q.device)
    hit = (s2 == s)[:, None] & (col[None, :] == a[:, None])
    greedy2 = first_argmax_ref(torch.where(hit, v_new[:, None], row2))
    q[cells, s, a] = v_new
    return q, greedy2, td


def stable_topk_ref(q: torch.Tensor, k: int):
    """k rounds of (max, first-argmax, mask): values descending, ties by
    ascending index (``torch.topk`` does not promise that order).
    Exhausted rows re-yield ``NEG_INF`` values, which the constraint
    head's invalid filter culls."""
    iota = torch.arange(q.shape[-1], device=q.device)
    vals, idx, cur = [], [], q
    for _ in range(k):
        i = first_argmax_ref(cur)
        vals.append(cur.gather(-1, i.long()[..., None])[..., 0])
        idx.append(i)
        cur = torch.where(iota == i[..., None], NEG_INF, cur)
    return torch.stack(vals, -1), torch.stack(idx, -1)


def head_q_ref(active, member, end_b, agg, w1, b1, w2, b2, w3, b3,
               allowed) -> torch.Tensor:
    """The head's masked per-user values: per-user 11-wide feature rows
    ``[active, member, end_b, agg...]`` through the shared 3-layer ReLU
    MLP, disallowed entries set to exactly ``NEG_INF``. (cells, N, A)."""
    cells, n = active.shape
    feats = torch.cat([active[..., None], member[..., None],
                       end_b[..., None],
                       agg[:, None, :].expand(cells, n, agg.shape[-1])], -1)
    x = feats.reshape(cells * n, feats.shape[-1])
    h = torch.relu(x @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    q = (h @ w3 + b3).reshape(cells, n, -1)
    return torch.where(allowed[None] > 0.5, q, NEG_INF)


def combo_table(topk: int, users: int, device=None) -> torch.Tensor:
    """(topk^N, N) int64 per-user top-k slot of every combination, in
    ``itertools.product`` order."""
    return torch.tensor(list(itertools.product(range(topk), repeat=users)),
                        dtype=torch.int64, device=device)


def combo_scores_ref(q, member, acc_table, *, threshold: float,
                     topk: int):
    """The constraint head's scoring of the per-user top-k combinations:
    returns ``(score, idx, combos)`` — (cells, topk^N) summed member
    values, ``-inf`` where a member entry is masked or the mean member
    accuracy misses ``threshold``; the (cells, N, k) top-k ids; and the
    (topk^N, N) combination table."""
    cells, n, _ = q.shape
    vals, idx = stable_topk_ref(q, topk)                   # (cells, N, k)
    acc_k = acc_table[idx.long()]
    combos = combo_table(topk, n, q.device)                # (Kc, N)
    mem = member > 0.5
    nm = torch.clamp(mem.sum(-1), min=1)[:, None].to(q.dtype)
    score = torch.zeros((cells, combos.shape[0]), dtype=q.dtype,
                        device=q.device)
    macc_sum = torch.zeros_like(score)
    invalid = torch.zeros(score.shape, dtype=torch.bool, device=q.device)
    for u in range(n):
        cu = combos[:, u]
        v_u, a_u = vals[:, u, cu], acc_k[:, u, cu]         # (cells, Kc)
        m_u = mem[:, u:u + 1]
        score = score + torch.where(m_u, v_u, 0.0)
        macc_sum = macc_sum + torch.where(m_u, a_u, 0.0)
        invalid = invalid | ((v_u < -1e29) & m_u)
    macc = torch.where(mem.any(-1, keepdim=True), macc_sum / nm, 100.0)
    feas = macc >= threshold - 1e-9        # dynamics.feasible, inlined
    return torch.where(feas & ~invalid, score, -torch.inf), idx, combos


def greedy_head_ref(q, member, acc_table, *, threshold: float, topk: int):
    """The head's decisions from its masked values ``q`` (cells, N, A):
    the plain per-user first-index argmax, or with a ``threshold`` the
    best-scoring feasible combination of the per-user top-k
    (``combo_scores_ref``, first index on ties), falling back to the
    plain argmax in a cell with no feasible combo. (cells, N) int32."""
    plain = first_argmax_ref(q)
    if not threshold:
        return plain
    score, idx, combos = combo_scores_ref(q, member, acc_table,
                                          threshold=threshold, topk=topk)
    j = first_argmax_ref(score).long()                     # (cells,)
    best = idx.gather(2, combos[j][..., None])[..., 0]
    has_feasible = torch.isfinite(score.gather(1, j[:, None]))[:, 0]
    return torch.where(has_feasible[:, None], best, plain)


def dqn_head_ref(active, member, end_b, agg, w1, b1, w2, b2, w3, b3,
                 allowed, acc_table, *, threshold: float, topk: int):
    """Fused featurize + constraint-aware greedy head.

    ``active``/``member``/``end_b``: (cells, N) f32; ``agg``: (cells, 8)
    f32 cell aggregates; ``w*``/``b*``: the shared MLP, weights
    ``(in, out)``; ``allowed``: (N, A) f32 0/1 mask; ``acc_table``: (A,)
    f32 accuracy ladder. Returns ``(dec, q)``: (cells, N) int32 greedy
    decisions (``greedy_head_ref``) and the (cells, N, A) masked head
    values (``head_q_ref``).
    """
    q = head_q_ref(active, member, end_b, agg, w1, b1, w2, b2, w3, b3,
                   allowed)
    return greedy_head_ref(q, member, acc_table, threshold=threshold,
                           topk=topk), q


def selective_scan_ref(u, dt, A, B, C, D):
    """Sequential (loop over time) selective-SSM oracle:
    ``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t`` from ``h_0 = 0`` and
    ``y_t = h_t . C_t + D u_t``.

    u, dt: (Bt, S, di); A: (di, N); B, C: (Bt, S, N); D: (di,).
    Returns (y: (Bt, S, di) in u's dtype, h_last: (Bt, di, N) float32);
    all arithmetic in float32."""
    uf, dtf = u.to(torch.float32), dt.to(torch.float32)
    Bf, Cf = B.to(torch.float32), C.to(torch.float32)
    Af = A.to(torch.float32)
    h = torch.zeros((u.shape[0], u.shape[2], A.shape[1]),
                    dtype=torch.float32, device=u.device)
    ys = []
    for t in range(u.shape[1]):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])
        dBu = (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        h = h * dA + dBu
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + uf * D.to(torch.float32)[None, None]
    return y.to(u.dtype), h
