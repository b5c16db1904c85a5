"""Mixture-of-experts layer — the port of ``repro/models/moe.py``: a top-k
router and capacity-based scatter dispatch (Switch/GShard semantics).

Capacity per batch row C = ceil(S * top_k / E * capacity_factor)
(``capacity``); a (token, slot) past its expert's capacity is dropped,
and the router's aux loss keeps the load balanced. The reference lays
the dispatched activations out (B, E, C, D); the port scatters them
expert-major, (E, B, C, D), so the three expert products run on (E, B C,
D) with no copy, and hands ``sharding.shard_moe_dispatch`` the (B, E, C,
D) view, as the reference does.

The expert products are one batched ``torch.bmm`` per projection in
bf16/float32 (the reference's ``jnp.einsum``, outside any Pallas kernel).
With int8 experts the rows are quantized once as ``layers.linear``
quantizes them, and each projection is ONE launch of K5 over all experts
(``ops.int8_matmul`` on (E, M, K) x (E, K, N)); each expert's ``w_q`` is
held K-major and its scales per column, (E, 1, out).

Top-k order: descending probability, ties by ascending expert index
(``ref.stable_topk_ref``'s order, through a stable sort). ``torch.topk``
promises no tie order on CUDA and ``jax.lax.top_k`` breaks exact ties
otherwise on JAX 0.9.0, so the two packages may pick other experts where
two probabilities are exactly equal, and only there.

Nothing here syncs the host: dropped entries are scattered into one
spare row past the E B C rows, which is then cut off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.kernels import int8_matmul, ops
from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, cfg):
    """The router (a float32 linear (d, E)) and the experts' ``w_gate``,
    ``w_up`` (E, d, d_ff) and ``w_down`` (E, d_ff, d); int8 experts hold
    ``{"w_q" (K-major per expert), "s" (E, 1, out) float32}``."""
    m = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, m.n_experts
    dtype = L.dt(cfg.dtype)
    dev = gen.device

    def ew(din, dout, scale):
        w = torch.randn((e, din, dout), generator=gen, device=dev) * scale
        if cfg.quant == "int8":
            s = w.abs().amax(1, keepdim=True) / 127.0 + 1e-8
            w_q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
            return {"w_q": int8_matmul.k_major(w_q), "s": s}
        return {"w": w.to(dtype)}
    return {
        "router": L.init_linear(gen, d, e, torch.float32),  # router in f32
        "w_gate": ew(d, f, d ** -0.5),
        "w_up": ew(d, f, d ** -0.5),
        "w_down": ew(f, d, (f * max(1, 2 * cfg.n_layers)) ** -0.5),
    }


def _gathered(p):
    """The expert weights under the reference's constraint: experts on
    'model', the matrix dims gathered (the identity without a model
    mesh)."""
    key = "w_q" if "w_q" in p else "w"
    q = dict(p)
    q[key] = sharding.logical(p[key], "expert", None, None)
    return q


def _experts(p, x, xq=None):
    """(E, R, Din) @ the per-expert weights (E, Din, Dout) -> (E, R, Dout)
    in ``x.dtype``; ``xq``, the rows of ``x`` already quantized
    (``layers.quantize_rows``), where the experts are int8."""
    if "w_q" in p:
        x_q, sx = xq if xq is not None else L.quantize_rows(x)
        return ops.int8_matmul(x_q, sx, p["w_q"], p["s"], out_dtype=x.dtype)
    return torch.bmm(x, p["w"].to(x.dtype))


def capacity(seq: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(1, int(-(-seq * top_k * cf // n_experts)))


def router(params, x, cfg):
    """The float32 router: (softmax probabilities (B, S, E), the top-k
    gates renormalised (B, S, k), their expert ids (B, S, k) int64)."""
    k = cfg.moe.top_k
    logits = L.linear(params["router"], x.to(torch.float32))       # (B,S,E)
    probs = torch.softmax(logits, -1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[..., :k], ids[..., :k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_ids


def moe_aux(probs, expert_ids, keep, n_experts):
    """``{"aux_loss", "dropped_frac"}`` (0-d float32 tensors) of one
    ``moe_apply``: the Switch load-balance loss E * sum_e f_e * p_e and the
    share of (token, slot) entries past their expert's capacity."""
    me = probs.mean((0, 1))                                         # (E,)
    ce = F.one_hot(expert_ids[..., 0], n_experts).to(torch.float32) \
        .mean((0, 1))
    return {"aux_loss": n_experts * (me * ce).sum(),
            "dropped_frac": 1.0 - keep.to(torch.float32).mean()}


def moe_block(params, x, cfg):
    """x: (B, S, D) -> (B, S, D), ``{"aux_loss", "dropped_frac"}`` (0-d
    float32 tensors), as the reference's ``moe_block``."""
    y, probs, expert_ids, keep = moe_apply(params, x, cfg)
    return y, moe_aux(probs, expert_ids, keep, cfg.moe.n_experts)


def moe_apply(params, x, cfg):
    """The block without its aux statistics, as the served model calls it:
    x (B, S, D) -> (y (B, S, D), the router's probabilities (B, S, E),
    expert ids (B, S, k), keep (B, S k), False where a (token, slot) was
    dropped), from which ``moe_aux`` computes them."""
    from repro_torch.tuning import FLAGS
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = capacity(s, k, e, FLAGS["moe_cf"] or m.capacity_factor)

    probs, gate_vals, expert_ids = router(params, x, cfg)

    # Position of each (token, slot) within its expert, per batch row, in
    # token-major (s, k) order: earlier tokens win capacity.
    flat_ids = expert_ids.reshape(b, s * k)                         # (B,T)
    onehot = F.one_hot(flat_ids, e).to(torch.int32)                 # (B,T,E)
    pos_in_e = onehot.cumsum(1, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(2, flat_ids[..., None])[..., 0]           # (B,T)
    keep = pos < cap

    # Dispatch, expert-major: a kept entry of row b at position p of its
    # expert e goes to row (e B + b) C + p, a dropped one to the spare row
    # E B C.
    rows = torch.arange(b, device=x.device)[:, None]
    slot = (flat_ids * b + rows) * cap                              # (B,T)
    dest = torch.where(keep, slot + pos, e * b * cap)
    buf = x.new_zeros((e * b * cap + 1, d))
    buf[dest.view(b, s, k)] = x[:, :, None, :]
    dispatched = buf[:-1].view(e, b, cap, d)
    dispatched = sharding.shard_moe_dispatch(
        dispatched.transpose(0, 1)).transpose(0, 1)                 # (E,B,C,D)
    xe = dispatched.reshape(e, b * cap, d)

    xq = L.quantize_rows(xe) if "w_q" in params["w_gate"] else None
    h = F.silu(_experts(_gathered(params["w_gate"]), xe, xq))
    h = h * _experts(_gathered(params["w_up"]), xe, xq)
    out_e = _experts(_gathered(params["w_down"]), h)                # (E,BC,D)
    out_e = sharding.shard_moe_dispatch(
        out_e.view(e, b, cap, d).transpose(0, 1)).transpose(0, 1)

    # Combine: each (token, slot)'s expert row, at min(pos, cap - 1).
    src = slot + torch.clamp(pos, max=cap - 1)
    gathered = out_e.reshape(e * b * cap, d)[src]                   # (B,T,D)
    w = (gate_vals.reshape(b, s * k) * keep).to(x.dtype)
    y = (gathered * w[..., None]).reshape(b, s, k, d).sum(2)
    return y, probs, expert_ids, keep


def moe_block_dense_ref(params, x, cfg):
    """Oracle: every token through its top-k experts with NO capacity drop
    (dense over all experts). Used by tests to validate dispatch."""
    e = cfg.moe.n_experts
    _, gate_vals, expert_ids = router(params, x, cfg)
    comb = (F.one_hot(expert_ids, e).to(torch.float32)
            * gate_vals[..., None]).sum(2)                          # (B,S,E)
    ys = []
    for wg, wu, wd in zip(params["w_gate"]["w"], params["w_up"]["w"],
                          params["w_down"]["w"]):
        h = F.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))
        ys.append(h @ wd.to(x.dtype))
    y = torch.einsum("ebsd,bse->bsd", torch.stack(ys).to(torch.float32),
                     comb)
    return y.to(x.dtype)
