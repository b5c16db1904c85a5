"""The decoder and encoder stacks — the port of
``repro/models/transformer.py`` for every family of the reference:
dense, state-space (``ssm``), hybrid, mixture-of-experts (``moe``),
vision-language (``vlm``, the decoder behind a stub image prefix) and
encoder-decoder (``audio``): the served edge ladder, InternLM2, Yi,
Gemma, Gemma3, PaliGemma, Falcon-Mamba, Hymba, Granite-MoE, DBRX and
Whisper models.

Layers are grouped into homogeneous SEGMENTS (contiguous runs sharing
one attention kind, global vs sliding) as in the reference; where the
reference stacks a segment's params on a leading axis for ``lax.scan``,
the port keeps a list of per-layer param dicts and runs a Python loop.
A layer's mixer is attention (dense), the Mamba block (ssm), or both on
the same normed input, each output normed and the two averaged (hybrid);
its feed-forward is the MLP or, in the moe family, ``moe.moe_apply``:
the block without its aux statistics, which prefill and decode never
compute, as the reference's prefill drops them (the loss comes with the
training slice, through ``moe.moe_block``).

An encoder layer is a dense layer whose self-attention keeps every
position (``causal=False``, RoPE at ``arange(S)``). A decoder layer of
an encoder-decoder model adds a cross-attention block after its mixer:
its query from the normed residual (``ln_cross``), its K/V projected
from the encoder's output, every frame kept, no RoPE and no soft-cap,
as in the reference.

Cache layout: ``{"pos": int, "segments": [seg_cache, ...]}`` where an
attention segment holds ``{"k", "v": (Lseg, B, Sc, KV, hd)}`` with Sc
the full context for global segments and ``min(window, ctx)`` ring
slots for sliding ones, and an ssm or hybrid segment adds ``{"conv":
(Lseg, B, K-1, di), "h": (Lseg, B, di, N) f32}``; an encoder-decoder's
segment adds the cross cache ``{"ck", "cv": (Lseg, B, Se, KV, hd)}``,
which decode reads and never writes. ``layer_decode`` updates its
layer's slices IN PLACE (the K/V row at slot ``pos % Sc``, the conv
window and the SSM state); the values equal the reference's functional
update.

The reference's int8 KV cache raises ``NotImplementedError`` (ROADMAP
queue 1); so does a head_dim the attention kernels have no instance of
(16, 32, 64, 128 and 256), on the card (``check_kernel_shapes``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE

#: the families the port serves: the reference's six
FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


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
    if not cfg.has_attention:
        return 0
    return 0 if seg.is_global else cfg.sliding_window


def check_supported(cfg) -> None:
    """The port runs the reference's six families (``FAMILIES``); any
    other ``arch_type`` raises."""
    if cfg.arch_type not in FAMILIES:
        raise NotImplementedError(
            f"repro_torch serves the reference's {'/'.join(FAMILIES)} "
            f"families; {cfg.name!r} is {cfg.arch_type!r}")


def check_kernel_shapes(cfg) -> None:
    """On the card, attention runs through K3 and K4, which have
    instances for ``HEAD_DIMS`` only: any other head_dim raises here,
    before a weight is drawn."""
    hd = cfg.resolved_head_dim
    if cfg.has_attention and (hd not in flash_attention.HEAD_DIMS
                              or hd not in decode_attention.HEAD_DIMS):
        raise NotImplementedError(
            f"{cfg.name!r} has head_dim {hd}; the attention kernels have "
            f"{flash_attention.HEAD_DIMS}")


# ---------------------------------------------------------------------------
# Per-layer init


def _init_layer(gen: torch.Generator, cfg, cross: bool = False):
    """One layer's params; ``cross`` adds the cross-attention block
    (``cross``, ``ln_cross``) of an encoder-decoder's decoder layer."""
    dev = gen.device
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dev)}
    if cfg.arch_type == "ssm":
        p["ssm"] = M.init_mamba(gen, cfg)
        return p
    p["attn"] = L.init_attention(gen, cfg)
    if cfg.arch_type == "hybrid":
        p["ssm"] = M.init_mamba(gen, cfg)
        p["ln_attn_out"] = L.init_rmsnorm(cfg.d_model, dev)
        p["ln_ssm_out"] = L.init_rmsnorm(cfg.d_model, dev)
    if cross:
        p["cross"] = L.init_attention(gen, cfg)
        p["ln_cross"] = L.init_rmsnorm(cfg.d_model, dev)
    if cfg.moe is not None:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev)
        p["moe"] = MOE.init_moe(gen, cfg)
    elif cfg.has_mlp:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init_segment(gen: torch.Generator, cfg, seg: Segment,
                 cross: bool = False) -> list:
    return [_init_layer(gen, cfg, cross) for _ in range(seg.length)]


# ---------------------------------------------------------------------------
# Layer application — full sequence (prefill)


def _ffn(p, x, cfg):
    if "moe" in p:
        h = L.rmsnorm(p["ln2"], x, cfg.rms_norm_eps)
        return x + MOE.moe_apply(p["moe"], h, cfg)[0]
    if "mlp" in p:
        h = L.rmsnorm(p["ln2"], x, cfg.rms_norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.mlp_act)
    return x


def _mix(p, outs, cfg):
    """The mixer's output: the one path's, or for a hybrid layer the mean
    of the attention and SSM outputs, each through its own norm."""
    if cfg.arch_type == "hybrid":
        a = L.rmsnorm(p["ln_attn_out"], outs["attn"], cfg.rms_norm_eps)
        s = L.rmsnorm(p["ln_ssm_out"], outs["ssm"], cfg.rms_norm_eps)
        return 0.5 * (a + s)
    return next(iter(outs.values()))


def _cross_full(p, x, cfg, cross_src):
    """The cross-attention block over a full sequence: x's queries onto
    the encoder output ``cross_src`` (B, Se, D), every frame kept.
    Returns (x with the block's output added, (ck, cv) (B, Se, KV,
    hd))."""
    hd = cfg.resolved_head_dim
    b, se = cross_src.shape[:2]
    hc = L.rmsnorm(p["ln_cross"], x, cfg.rms_norm_eps)
    ck = L.linear(p["cross"]["wk"], cross_src).reshape(b, se,
                                                       cfg.n_kv_heads, hd)
    cv = L.linear(p["cross"]["wv"], cross_src).reshape(b, se,
                                                       cfg.n_kv_heads, hd)
    qc = L.linear(p["cross"]["wq"], hc).reshape(*hc.shape[:2], cfg.n_heads,
                                                hd)
    oc = L.chunked_attention(qc, ck, cv, causal=False)
    return x + L.linear(p["cross"]["wo"], oc.reshape(*hc.shape[:2], -1)), \
        (ck, cv)


def layer_full(p, x, cfg, window: int, positions, *, causal: bool = True,
               cross_src=None):
    """One layer over a full sequence: causal (a decoder's) or not (an
    encoder's, every position kept); ``cross_src``, the encoder's output,
    runs a decoder layer's cross-attention block. Returns (x, this
    layer's cache entries: ``k``/``v`` of its attention, ``ck``/``cv``
    of its cross-attention, ``conv``/``h`` of its Mamba block)."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_norm_eps)
    outs, ys = {}, {}
    if "attn" in p:
        q, k, v = L.attention_qkv(p["attn"], h, cfg, positions,
                                  rope=(cfg.rope_theta > 0))
        if not causal:
            o = L.chunked_attention(q, k, v, causal=False,
                                    softcap=cfg.logit_softcap)
        elif window and h.shape[1] > window:
            o = L.local_banded_attention(q, k, v, window=window,
                                         softcap=cfg.logit_softcap)
        else:
            o = L.chunked_attention(q, k, v, causal=True, window=window,
                                    softcap=cfg.logit_softcap)
        outs["attn"] = L.linear(p["attn"]["wo"], o.reshape(*x.shape[:2], -1))
        ys["k"], ys["v"] = k, v
    if "ssm" in p:
        outs["ssm"], c = M.mamba_block(p["ssm"], h, cfg)
        ys["conv"], ys["h"] = c["conv"], c["h"]
    x = x + _mix(p, outs, cfg)
    if cross_src is not None and "cross" in p:
        x, (ys["ck"], ys["cv"]) = _cross_full(p, x, cfg, cross_src)
    return _ffn(p, x, cfg), ys


# ---------------------------------------------------------------------------
# Layer application — single-token decode


def layer_decode(p, x, cache_l, cfg, window: int, pos: int, cross=None):
    """One decoder layer for one token at absolute position ``pos``.
    ``cache_l``: this layer's cache slices — ``k``/``v`` (B, Sc, KV, hd),
    into which slot ``pos % Sc`` is written, and ``conv``/``h``, which
    the Mamba step advances; all in place. An encoder-decoder's
    ``ck``/``cv`` (B, Se, KV, hd) are read by the cross-attention block
    at ``cross`` (``cross_positions``: every frame valid). Returns x."""
    b = x.shape[0]
    h = L.rmsnorm(p["ln1"], x, cfg.rms_norm_eps)
    outs = {}
    if "attn" in p:
        kc, vc = cache_l["k"], cache_l["v"]
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
        outs["attn"] = L.linear(p["attn"]["wo"], o.reshape(b, 1, -1))
    if "ssm" in p:
        outs["ssm"], _ = M.mamba_block(
            p["ssm"], h, cfg, cache={"conv": cache_l["conv"],
                                     "h": cache_l["h"]})
    x = x + _mix(p, outs, cfg)
    if "cross" in p and cross is not None:
        hc = L.rmsnorm(p["ln_cross"], x, cfg.rms_norm_eps)
        qc = L.linear(p["cross"]["wq"], hc).reshape(
            b, 1, cfg.n_heads, cfg.resolved_head_dim)
        oc = L.decode_attention(qc, cache_l["ck"], cache_l["cv"], *cross)
        x = x + L.linear(p["cross"]["wo"], oc.reshape(b, 1, -1))
    return _ffn(p, x, cfg)


# ---------------------------------------------------------------------------
# Stacks


def run_stack_full(segments, seg_params_list, x, cfg, positions, *,
                   causal: bool = True, cross_src=None,
                   want_cache: bool = False):
    """Full-sequence pass over all segments (``causal=False`` for an
    encoder; ``cross_src``, the encoder's output, for an encoder-decoder's
    decoder). Returns (x, per-segment cache entries stacked over its
    layers — ``{"k", "v": (Lseg, B, S, KV, hd)}``, ``{"ck", "cv":
    (Lseg, B, Se, KV, hd)}`` and/or ``{"conv": (Lseg, B, K-1, di), "h":
    (Lseg, B, di, N)}`` — or None)."""
    seg_caches = []
    for seg, seg_params in zip(segments, seg_params_list):
        window = seg_window(cfg, seg)
        stacked = {}
        for i, p in enumerate(seg_params):
            x, y = layer_full(p, x, cfg, window, positions, causal=causal,
                              cross_src=cross_src)
            if not want_cache:
                continue
            # each layer's entries go straight into the stacked buffers,
            # so no layer's copy outlives its layer
            for name, t in y.items():
                if name not in stacked:
                    stacked[name] = t.new_empty((len(seg_params),) + t.shape)
                stacked[name][i] = t
        seg_caches.append(stacked if want_cache else None)
    return x, seg_caches


def cross_positions(seg_caches):
    """The cross cache's slot positions (B, Se) and current position
    (B,) at which every frame is valid, built once a decode step for all
    of an encoder-decoder's layers; None without a cross cache."""
    for c in seg_caches:
        if "ck" in c:
            b, se = c["ck"].shape[1:3]
            frames = torch.arange(se, device=c["ck"].device)
            return (frames[None, :].expand(b, se),
                    torch.full((b,), se, device=frames.device))
    return None


def run_stack_decode(segments, seg_params_list, x, cache, cfg, pos: int):
    """Single-token pass; the caches are updated in place. Returns (x,
    ``{"pos": pos + 1, "segments": cache["segments"]}``)."""
    cross = cross_positions(cache["segments"])
    for seg, seg_params, seg_cache in zip(segments, seg_params_list,
                                          cache["segments"]):
        if "k_s" in seg_cache:
            raise NotImplementedError("the int8 KV cache (ROADMAP queue 1)")
        window = seg_window(cfg, seg)
        for i, p in enumerate(seg_params):
            x = layer_decode(p, x, {name: t[i] for name, t in
                                    seg_cache.items()}, cfg, window, pos,
                             cross)
    return x, {"pos": pos + 1, "segments": cache["segments"]}
