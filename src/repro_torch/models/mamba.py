"""Mamba-1 selective-SSM block — the port of ``repro/models/mamba.py``
(the SSM path of Falcon-Mamba and of Hymba's hybrid layers).

Prefill runs the selective scan through ``ops.selective_scan``: on the
card the hand-written kernel K6 (``csrc/selective_scan.cu``), which
never materialises the (B, S, d_inner, N) state the reference's
associative and chunked scans build, so the port has no chunked variant
and no flag. Under autograd (``Model.loss``) the same call keeps only
the state at every 32-step chunk boundary, and its gradient is the
hand-written backward P3 (``csrc/selective_scan_backward.cu``). Decode is the O(1) recurrent step in plain PyTorch, with
the ``conv`` window and the ``h`` state of the cache updated IN PLACE
(the values equal the reference's functional update).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init_mamba(gen: torch.Generator, cfg):
    """S4D-real ``A_log``, inverse-softplus ``dt_b``; ``in_proj`` and
    ``out_proj`` take ``cfg.quant``, ``x_proj`` always stays dense."""
    s = cfg.ssm
    d, di, n = cfg.d_model, cfg.d_inner, s.state_dim
    dtr = s.resolved_dt_rank(d)
    dev = gen.device
    dtype = L.dt(cfg.dtype)
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    dt_init = torch.exp(torch.rand((di,), generator=gen, device=dev)
                        * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    inv_softplus = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "in_proj": L.init_linear(gen, d, 2 * di, dtype, cfg.quant),
        "conv_w": (torch.randn((s.d_conv, di), generator=gen, device=dev)
                   * (1.0 / math.sqrt(s.d_conv))).to(dtype),
        "conv_b": torch.zeros(di, device=dev),
        "x_proj": L.init_linear(gen, di, dtr + 2 * n, dtype),
        "dt_w": torch.randn((dtr, di), generator=gen, device=dev)
        * dtr ** -0.5,
        "dt_b": inv_softplus,
        "A_log": torch.log(a),                      # (di, N) f32
        "D": torch.ones(di, device=dev),
        "out_proj": L.init_linear(
            gen, di, d, dtype, cfg.quant,
            scale=1.0 / math.sqrt(di * max(1, 2 * cfg.n_layers))),
    }


def _ssm_params(params, xc, cfg):
    """xc: (..., di) post-conv activations -> dt (..., di), B, C (..., N),
    all float32: the ``x_proj`` product in the activations' dtype, cast
    afterwards, then ``softplus(dt_r @ dt_w + dt_b)``."""
    s = cfg.ssm
    dtr = s.resolved_dt_rank(cfg.d_model)
    proj = L.linear(params["x_proj"], xc).to(torch.float32)
    dt_r, b_, c_ = torch.split(proj, [dtr, s.state_dim, s.state_dim], -1)
    dt = F.softplus(dt_r @ params["dt_w"] + params["dt_b"])
    return dt, b_, c_


def causal_conv1d(x, w, b, *, state=None):
    """Depthwise causal conv in the activations' dtype. x: (Bt, S, di);
    w: (K, di); state: (Bt, K-1, di), the last K-1 inputs before x.
    Returns (y, new state)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i][None, None].to(x.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y + b.to(x.dtype)[None, None], new_state


def mamba_block(params, x, cfg, *, cache=None):
    """x: (Bt, S, d_model) -> (y, cache).

    cache: ``{"conv": (Bt, K-1, di), "h": (Bt, di, N) f32}`` or None. For
    S > 1, or without a cache, the selective scan (K6 on the card) from a
    zero state, returning a new cache; for S == 1 with a cache, the
    recurrent step, updating that cache in place and returning it."""
    xz = L.linear(params["in_proj"], x)
    xi, z = torch.chunk(xz, 2, dim=-1)                      # (Bt, S, di)
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = causal_conv1d(xi, params["conv_w"], params["conv_b"],
                                 state=conv_state)
    xc = F.silu(xc)
    dt, b_, c_ = _ssm_params(params, xc, cfg)
    A = -torch.exp(params["A_log"])                          # (di, N)

    if x.shape[1] == 1 and cache is not None:
        h = cache["h"]                                       # (Bt, di, N)
        u = xc[:, 0].to(torch.float32)
        dA = torch.exp(dt[:, 0, :, None] * A[None])
        dBu = (dt[:, 0] * u)[..., None] * b_[:, 0, None, :]
        h.mul_(dA).add_(dBu)
        y = (h * c_[:, 0, None, :]).sum(-1) + u * params["D"]
        y = y[:, None, :].to(x.dtype)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        y, h_last = ops.selective_scan(xc, dt, A, b_, c_, params["D"])
        new_cache = {"conv": new_conv, "h": h_last}

    y = y * F.silu(z)
    return L.linear(params["out_proj"], y), new_cache


def mamba_cache_spec(cfg, batch: int):
    """The decode cache of one Mamba block for ``batch`` sequences, as
    (shape, dtype) pairs: the ``conv`` window (batch, d_conv - 1, di) in
    the model's dtype and the ``h`` state (batch, di, N) float32."""
    s = cfg.ssm
    di, n = cfg.d_inner, s.state_dim
    return {"conv": ((batch, s.d_conv - 1, di), L.dt(cfg.dtype)),
            "h": ((batch, di, n), torch.float32)}
