"""The decoder stack — the port of ``repro/models/transformer.py`` for the
dense family (the served edge-ladder model).

Layers are grouped into homogeneous SEGMENTS (contiguous runs sharing
one attention kind, global vs sliding) as in the reference; where the
reference stacks a segment's params on a leading axis for ``lax.scan``,
the port keeps a list of per-layer param dicts and runs a Python loop.

Cache layout: ``{"pos": int, "segments": [{"k", "v": (Lseg, B, Sc, KV,
hd)}, ...]}`` with Sc the full context for global segments (the
reference's). ``layer_decode`` writes the new token's K/V row into the
cache IN PLACE (slot ``pos % Sc``); the values equal the reference's
functional update.

The mixture-of-experts, state-space, hybrid, encoder-decoder and vision
families raise ``NotImplementedError`` (ROADMAP queue 1, other
architectures), as does the reference's int8 KV cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L

_LATER = "(ROADMAP queue 1: other architectures of the served models)"


@dataclasses.dataclass(frozen=True)
class Segment:
    start: int
    length: int
    is_global: bool


def segments_of(cfg) -> tuple:
    mask = cfg.global_layer_mask()
    segs = []
    i = 0
    for j in range(1, cfg.n_layers + 1):
        if j == cfg.n_layers or mask[j] != mask[i]:
            segs.append(Segment(i, j - i, mask[i]))
            i = j
    return tuple(segs)


def seg_window(cfg, seg: Segment) -> int:
    """Effective attention window of a segment (0 = unlimited/global)."""
    return 0 if seg.is_global else cfg.sliding_window


def check_supported(cfg) -> None:
    """The port runs the dense decoder only (so far)."""
    if cfg.arch_type != "dense" or cfg.moe is not None or \
            cfg.ssm is not None or cfg.is_encdec:
        raise NotImplementedError(
            f"repro_torch serves the dense decoder family only; "
            f"{cfg.name!r} is {cfg.arch_type!r} {_LATER}")


# ---------------------------------------------------------------------------
# Per-layer init


def _init_layer(gen: torch.Generator, cfg):
    p = {"ln1": L.init_rmsnorm(cfg.d_model),
         "attn": L.init_attention(gen, cfg)}
    if cfg.has_mlp:
        p["ln2"] = L.init_rmsnorm(cfg.d_model)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init_segment(gen: torch.Generator, cfg, seg: Segment) -> list:
    return [_init_layer(gen, cfg) for _ in range(seg.length)]


# ---------------------------------------------------------------------------
# Layer application — full sequence (prefill)


def _ffn(p, x, cfg):
    if "mlp" in p:
        h = L.rmsnorm(p["ln2"], x, cfg.rms_norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.mlp_act)
    return x


def layer_full(p, x, cfg, window: int, positions):
    """One decoder layer over a full sequence (causal). Returns (x, (k,
    v)) with this layer's keys and values for the cache."""
    if window and x.shape[1] > window:
        raise NotImplementedError(
            "sliding-window prefill longer than the window needs "
            f"local_banded_attention {_LATER}")
    h = L.rmsnorm(p["ln1"], x, cfg.rms_norm_eps)
    q, k, v = L.attention_qkv(p["attn"], h, cfg, positions,
                              rope=(cfg.rope_theta > 0))
    o = L.chunked_attention(q, k, v, causal=True, window=window,
                            softcap=cfg.logit_softcap)
    x = x + L.linear(p["attn"]["wo"], o.reshape(*x.shape[:2], -1))
    return _ffn(p, x, cfg), (k, v)


# ---------------------------------------------------------------------------
# Layer application — single-token decode


def layer_decode(p, x, kc, vc, cfg, window: int, pos: int):
    """One decoder layer for one token at absolute position ``pos``.
    ``kc``/``vc``: this layer's (B, Sc, KV, hd) cache, into which slot
    ``pos % Sc`` is written in place. Returns x."""
    b = x.shape[0]
    h = L.rmsnorm(p["ln1"], x, cfg.rms_norm_eps)
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = L.attention_qkv(p["attn"], h, cfg, positions,
                              rope=(cfg.rope_theta > 0))
    sc = kc.shape[1]
    slot = pos % sc
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]
    # absolute position held by each ring slot after the write
    idx = torch.arange(sc, device=x.device)
    kv_pos = pos - (pos - idx) % sc
    o = L.decode_attention(q, kc, vc, kv_pos[None, :].expand(b, sc),
                           torch.full((b,), pos, device=x.device),
                           window=window, softcap=cfg.logit_softcap)
    x = x + L.linear(p["attn"]["wo"], o.reshape(b, 1, -1))
    return _ffn(p, x, cfg)


# ---------------------------------------------------------------------------
# Stacks


def run_stack_full(segments, seg_params_list, x, cfg, positions, *,
                   want_cache: bool = False):
    """Full-sequence pass over all segments. Returns (x, per-segment
    ``{"k", "v": (Lseg, B, S, KV, hd)}`` or None)."""
    seg_caches = []
    for seg, seg_params in zip(segments, seg_params_list):
        window = seg_window(cfg, seg)
        ks, vs = [], []
        for p in seg_params:
            x, (k, v) = layer_full(p, x, cfg, window, positions)
            ks.append(k)
            vs.append(v)
        seg_caches.append({"k": torch.stack(ks), "v": torch.stack(vs)}
                          if want_cache else None)
    return x, seg_caches


def run_stack_decode(segments, seg_params_list, x, cache, cfg, pos: int):
    """Single-token pass; the caches are updated in place. Returns (x,
    ``{"pos": pos + 1, "segments": cache["segments"]}``)."""
    for seg, seg_params, seg_cache in zip(segments, seg_params_list,
                                          cache["segments"]):
        if "k_s" in seg_cache:
            raise NotImplementedError("the int8 KV cache (ROADMAP queue 1)")
        window = seg_window(cfg, seg)
        for i, p in enumerate(seg_params):
            x = layer_decode(p, x, seg_cache["k"][i], seg_cache["v"][i],
                             cfg, window, pos)
    return x, {"pos": pos + 1, "segments": cache["segments"]}
