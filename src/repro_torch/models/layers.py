"""Core building blocks of the served model — the port of
``repro/models/layers.py``: linear (incl. int8), RMSNorm, RoPE, the
attention cores (full, sliding-window banded and decode) and the
attention/MLP blocks.

All functions are plain tensor functions over dict params, as in the
reference; weights are ``(in, out)``. The attention cores and the int8
projection go through ``kernels.ops``, so on the card they launch the
hand-written kernels (K3 flash attention, K4 decode attention, K5 int8
matmul) and on the CPU their plain versions. Initialisers draw from an
explicit ``torch.Generator`` and create their tensors on that
generator's device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding
from repro_torch.kernels import int8_matmul, ops


def dt(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Linear (dense or int8-quantized)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype=torch.bfloat16, quant: str = "none",
                scale: Optional[float] = None):
    """A linear's params, weights ``(in, out)``. With ``quant="int8"``,
    ``{"w_q", "s"}``: ``w_q`` is held K-major, an (in, out) view of (out,
    in) row-major storage (strides (1, in)), the layout K5 reads
    (``int8_matmul.k_major``)."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * std
    if quant == "int8":
        s = w.abs().amax(0, keepdim=True) / 127.0 + 1e-8
        w_q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        return {"w_q": int8_matmul.k_major(w_q), "s": s}
    return {"w": w.to(dtype)}


def quantize_rows(x):
    """Each row (last axis) of ``x`` as int8 with its float32 scale:
    scale = (max |x| + 1e-8) / 127, x_q = clip(round(x / scale), +-127),
    round half to even. Returns ``(x_q, scale)``, the scale with a
    trailing axis of 1."""
    # max |x| (exact in float32) and x / sx in float32 (x upcast exactly
    # by type promotion), in as few eager ops as the reference's rounding
    # allows
    if isinstance(x, DTensor):
        # a partial sum is reduced first; a row split over ranks gives a
        # partial max, reduced before the scale is taken out of place
        # (the same arithmetic)
        x = sharding.settled(x)
        amax = torch.linalg.vector_norm(x, math.inf, -1, keepdim=True,
                                        dtype=torch.float32)
        sx = (amax + 1e-8) / 127.0
        return torch.div(x, sx).round().clamp(-127, 127).to(torch.int8), \
            sx
    amax = torch.linalg.vector_norm(x, math.inf, -1, keepdim=True,
                                    dtype=torch.float32)
    sx = amax.add_(1e-8).div_(127.0)
    return torch.div(x, sx).round_().clamp_(-127, 127).to(torch.int8), sx


def linear(params, x):
    """y = x @ W. The int8 path quantizes each token's activations
    (``quantize_rows``) and takes the int8 x int8 product through
    ``ops.int8_matmul`` (K5) with the per-column weight scales, which
    rounds it once to ``x.dtype``. Its ``w_q`` is held K-major
    (``init_linear``). Under a model mesh the dense product runs on the
    local shards too (``ops.sharded_matmul``)."""
    if "w_q" in params:
        lead = x.shape[:-1]
        x_q, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
        y = ops.int8_matmul(x_q, sx, params["w_q"], params["s"],
                            out_dtype=x.dtype)
        return y.reshape(*lead, -1)
    if isinstance(x, DTensor):
        lead = x.shape[:-1]
        return ops.sharded_matmul(x.reshape(-1, x.shape[-1]),
                                  params["w"]).reshape(*lead, -1)
    return x @ params["w"].to(x.dtype)


# ---------------------------------------------------------------------------
# Norms


def init_rmsnorm(d: int, device=None):
    return {"g": torch.zeros(d, device=device)}      # gemma-style (1 + g)


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params["g"])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device,
                                         dtype=torch.float32) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Split
    halves (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores. q (B, Sq, H, hd), k/v (B, Skv, KV, hd) with H = KV * G.


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      softcap: float = 0.0):
    """Online-softmax attention over the full sequence through
    ``ops.flash_attention`` (K3), q right-aligned against the kv
    sequence. ``window > 0`` keeps kv_pos in (q_pos - window, q_pos];
    ``causal=False`` keeps every kv position (an encoder's
    self-attention, a decoder's cross-attention, Sq and Skv free);
    ``softcap > 0`` caps each scaled score as ``tanh(s / softcap) *
    softcap`` before the mask.

    The reference's jnp mirror rounds the probabilities to the value
    dtype before the PV product, and so does the bf16 kernel (its PV
    product runs on the tensor cores); the float32 kernel and the plain
    version keep them in float32 (equal in float32 models)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def local_banded_attention(q, k, v, *, window: int, softcap: float = 0.0):
    """Sliding-window causal attention over a prefill longer than the
    window: kv_pos in (q_pos - window, q_pos]. The reference computes it
    block-locally in jnp (each window-long block against itself and the
    block before); here it is the same function of K3 with its window,
    whose whole-tile skips give the banded cost."""
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               softcap=softcap)


def decode_attention(q, k_cache, v_cache, kv_pos, cur_pos, *,
                     window: int = 0, softcap: float = 0.0):
    """Single-token attention against a (possibly ring-buffered) cache
    through ``ops.decode_attention`` (K4).

    q: (B, 1, H, hd); caches: (B, Sc, KV, hd); kv_pos: (B, Sc) absolute
    position of each slot (-1 = empty); cur_pos: (B,) position of the
    new token; ``softcap`` as in ``chunked_attention``."""
    o = ops.decode_attention(q[:, 0], k_cache, v_cache, kv_pos, cur_pos,
                             window=window, softcap=softcap)
    return o[:, None]


# ---------------------------------------------------------------------------
# Attention block (projections + rope)


def init_attention(gen: torch.Generator, cfg):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dtype = dt(cfg.dtype)
    return {
        "wq": init_linear(gen, d, qd, dtype, cfg.quant),
        "wk": init_linear(gen, d, kvd, dtype, cfg.quant),
        "wv": init_linear(gen, d, kvd, dtype, cfg.quant),
        "wo": init_linear(gen, qd, d, dtype, cfg.quant,
                          scale=1.0 / math.sqrt(qd * max(1, 2 * cfg.n_layers))),
    }


def attention_qkv(params, x, cfg, positions=None, *, rope: bool = True):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = sharding.split_heads(linear(params["wq"], x), cfg.n_heads, hd)
    k = sharding.split_heads(linear(params["wk"], x), cfg.n_kv_heads, hd)
    v = sharding.split_heads(linear(params["wv"], x), cfg.n_kv_heads, hd)
    if rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# MLP


def init_mlp(gen: torch.Generator, cfg):
    d, f = cfg.d_model, cfg.d_ff
    dtype = dt(cfg.dtype)
    down = 1.0 / math.sqrt(f * max(1, 2 * cfg.n_layers))
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {"w_gate": init_linear(gen, d, f, dtype, cfg.quant),
                "w_up": init_linear(gen, d, f, dtype, cfg.quant),
                "w_down": init_linear(gen, f, d, dtype, cfg.quant,
                                      scale=down)}
    return {"w_up": init_linear(gen, d, f, dtype, cfg.quant),
            "w_down": init_linear(gen, f, d, dtype, cfg.quant, scale=down)}


def mlp(params, x, act: str):
    if act == "swiglu":
        h = F.silu(linear(params["w_gate"], x)) * linear(params["w_up"], x)
    elif act == "geglu":
        h = F.gelu(linear(params["w_gate"], x), approximate="tanh") \
            * linear(params["w_up"], x)
    else:
        h = F.gelu(linear(params["w_up"], x), approximate="tanh")
    return linear(params["w_down"], h)
