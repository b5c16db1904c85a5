"""The decoder stack — the port of ``repro/models/transformer.py`` for the
dense, state-space (``ssm``), hybrid, mixture-of-experts (``moe``) and
vision-language (``vlm``, the decoder behind a stub image prefix)
families: the served edge ladder, InternLM2, Yi, Gemma, Gemma3,
PaliGemma, Falcon-Mamba, Hymba, Granite-MoE and DBRX models.

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

Cache layout: ``{"pos": int, "segments": [seg_cache, ...]}`` where an
attention segment holds ``{"k", "v": (Lseg, B, Sc, KV, hd)}`` with Sc
the full context for global segments and ``min(window, ctx)`` ring
slots for sliding ones, and an ssm or hybrid segment adds ``{"conv":
(Lseg, B, K-1, di), "h": (Lseg, B, di, N) f32}``. ``layer_decode``
updates its layer's slices IN PLACE (the K/V row at slot ``pos % Sc``,
the conv window and the SSM state); the values equal the reference's
functional update.

The encoder-decoder (audio) family raises ``NotImplementedError``
(ROADMAP queue 1, other architectures), as do the reference's int8 KV
cache and logit soft-capping; so does a head_dim the attention kernels
have no instance of (16, 32, 64, 128 and 256), on the card
(``check_kernel_shapes``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE

_LATER = "(ROADMAP queue 1: other architectures of the served models)"
#: the families the port serves
FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm")


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
    """The port runs the dense, ssm, hybrid, moe and vlm decoders (so
    far); the encoder-decoder stack is still to port."""
    if cfg.arch_type not in FAMILIES or cfg.is_encdec:
        raise NotImplementedError(
            f"repro_torch serves the {'/'.join(FAMILIES)} decoder families "
            f"only; {cfg.name!r} is {cfg.arch_type!r} {_LATER}")


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


def _init_layer(gen: torch.Generator, cfg):
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
    if cfg.moe is not None:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev)
        p["moe"] = MOE.init_moe(gen, cfg)
    elif cfg.has_mlp:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init_segment(gen: torch.Generator, cfg, seg: Segment) -> list:
    return [_init_layer(gen, cfg) for _ in range(seg.length)]


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


def layer_full(p, x, cfg, window: int, positions):
    """One decoder layer over a full sequence (causal). Returns (x, this
    layer's cache entries: ``k``/``v`` of its attention, ``conv``/``h``
    of its Mamba block)."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_norm_eps)
    outs, ys = {}, {}
    if "attn" in p:
        q, k, v = L.attention_qkv(p["attn"], h, cfg, positions,
                                  rope=(cfg.rope_theta > 0))
        if window and h.shape[1] > window:
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
    return _ffn(p, x + _mix(p, outs, cfg), cfg), ys


# ---------------------------------------------------------------------------
# Layer application — single-token decode


def layer_decode(p, x, cache_l, cfg, window: int, pos: int):
    """One decoder layer for one token at absolute position ``pos``.
    ``cache_l``: this layer's cache slices — ``k``/``v`` (B, Sc, KV, hd),
    into which slot ``pos % Sc`` is written, and ``conv``/``h``, which
    the Mamba step advances; all in place. Returns x."""
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
    return _ffn(p, x + _mix(p, outs, cfg), cfg)


# ---------------------------------------------------------------------------
# Stacks


def run_stack_full(segments, seg_params_list, x, cfg, positions, *,
                   want_cache: bool = False):
    """Full-sequence pass over all segments. Returns (x, per-segment
    cache entries stacked over its layers — ``{"k", "v": (Lseg, B, S,
    KV, hd)}`` and/or ``{"conv": (Lseg, B, K-1, di), "h": (Lseg, B, di,
    N)}`` — or None)."""
    seg_caches = []
    for seg, seg_params in zip(segments, seg_params_list):
        window = seg_window(cfg, seg)
        ys = []
        for p in seg_params:
            x, y = layer_full(p, x, cfg, window, positions)
            if want_cache:
                ys.append(y)
        seg_caches.append({name: torch.stack([y[name] for y in ys])
                           for name in ys[0]} if want_cache else None)
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
            x = layer_decode(p, x, {name: t[i] for name, t in
                                    seg_cache.items()}, cfg, window, pos)
    return x, {"pos": pos + 1, "segments": cache["segments"]}
