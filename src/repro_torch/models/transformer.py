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
compute, as the reference's prefill drops them; the training forward
(``run_stack_full(aux=True)``, ``Model.loss``) runs ``moe.moe_block``
and sums its aux loss over the layers. Under ``remat`` each layer of the
training forward runs under ``torch.utils.checkpoint``
(``rematerialise``), as the reference's ``jax.checkpoint`` of each
scanned layer.

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
update. An int8 K/V cache (``Model.cache_spec`` under
``FLAGS["kv_cache_dtype"] == "int8"``) also holds float32 scales
``{"k_s", "v_s": (Lseg, B, Sc, KV)}``: the new row is quantized into it
and the whole cache dequantized for K4, as the reference does
(``quantized_write``).

A head_dim the attention kernels have no instance of (16, 32, 64, 128
and 256) raises on the card (``check_kernel_shapes``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as _ckpt

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


def _ffn(p, x, cfg, want_aux: bool = False):
    """The feed-forward block. Returns (x, aux): with ``want_aux`` a MoE
    block runs ``moe.moe_block`` and ``aux`` is its aux loss (0-d
    float32); otherwise (and without a MoE block) ``aux`` is None."""
    if "moe" in p:
        h = L.rmsnorm(p["ln2"], x, cfg.rms_norm_eps)
        if want_aux:
            y, stats = MOE.moe_block(p["moe"], h, cfg)
            return x + y, stats["aux_loss"]
        return x + MOE.moe_apply(p["moe"], h, cfg)[0], None
    if "mlp" in p:
        h = L.rmsnorm(p["ln2"], x, cfg.rms_norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.mlp_act), None
    return x, None


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
               cross_src=None, want_aux: bool = False):
    """One layer over a full sequence: causal (a decoder's) or not (an
    encoder's, every position kept); ``cross_src``, the encoder's output,
    runs a decoder layer's cross-attention block. Returns (x, this
    layer's cache entries: ``k``/``v`` of its attention, ``ck``/``cv``
    of its cross-attention, ``conv``/``h`` of its Mamba block; its MoE
    block's aux loss where ``want_aux``, else None)."""
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
    x, aux = _ffn(p, x, cfg, want_aux)
    return x, ys, aux


# ---------------------------------------------------------------------------
# Layer application — single-token decode


def quantized_write(cache, scales, row, slot: int):
    """The reference's int8 K/V cache step
    (``repro/models/transformer.py`` ``layer_decode``): ``row`` (B, 1,
    KV, hd) quantized per (sequence, kv head) with the symmetric scale
    ``(amax + 1e-8) / 127``, rounded half to even and clipped to +-127,
    written with its scale into slot ``slot`` of the int8 ``cache`` (B,
    Sc, KV, hd) and float32 ``scales`` (B, Sc, KV), in place. Returns
    the whole cache dequantized (``cache * scales``) in row's dtype, the
    K or V that K4 reads. Each division is by a tensor on the row's
    device (filled there, not copied from the host): on the card,
    division by a Python number multiplies by its float32 reciprocal."""
    rf = row[:, 0].float()                                  # (B, KV, hd)
    amax = rf.abs().amax(-1) + 1e-8
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(rf / scale[..., None]), -127, 127)
    cache[:, slot] = q.to(torch.int8)
    scales[:, slot] = scale
    return (cache.float() * scales[..., None]).to(row.dtype)


def layer_decode(p, x, cache_l, cfg, window: int, pos: int, cross=None):
    """One decoder layer for one token at absolute position ``pos``.
    ``cache_l``: this layer's cache slices — ``k``/``v`` (B, Sc, KV, hd),
    into which slot ``pos % Sc`` is written (an int8 cache, with its
    float32 scales ``k_s``/``v_s`` (B, Sc, KV), through
    ``quantized_write``), and ``conv``/``h``, which the Mamba step
    advances; all in place. An encoder-decoder's ``ck``/``cv`` (B, Se,
    KV, hd) are read by the cross-attention block at ``cross``
    (``cross_positions``: every frame valid). Returns x."""
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
        if "k_s" in cache_l:
            kc = quantized_write(kc, cache_l["k_s"], k, slot)
            vc = quantized_write(vc, cache_l["v_s"], v, slot)
        else:
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
    return _ffn(p, x, cfg)[0]


# ---------------------------------------------------------------------------
# Stacks


#: the products a ``"dots"`` rematerialised layer keeps for its backward:
#: matrix products without batch dims (the projections), as JAX's
#: ``dots_with_no_batch_dims_saveable``; ``bmm`` (the experts' products)
#: and everything elementwise are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def rematerialise(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint`` (not
    reentrant: the params it closes over get their gradients), keeping
    for the backward what ``FLAGS["remat_policy"]`` names: nothing
    (``"full"``: the layer is recomputed whole) or the outputs of its
    ``mm``/``addmm`` (``"dots"``, through the selective-checkpoint
    context)."""
    from repro_torch.tuning import FLAGS
    policy = FLAGS["remat_policy"]
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy is 'full' or 'dots', got {policy!r}")
    extra = {}
    if policy == "dots":
        extra["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, **extra,
                            **kwargs)


def run_stack_full(segments, seg_params_list, x, cfg, positions, *,
                   causal: bool = True, cross_src=None,
                   want_cache: bool = False, aux: bool = False,
                   remat: bool = False):
    """Full-sequence pass over all segments (``causal=False`` for an
    encoder; ``cross_src``, the encoder's output, for an encoder-decoder's
    decoder). Returns (x, per-segment cache entries stacked over its
    layers — ``{"k", "v": (Lseg, B, S, KV, hd)}``, ``{"ck", "cv":
    (Lseg, B, Se, KV, hd)}`` and/or ``{"conv": (Lseg, B, K-1, di), "h":
    (Lseg, B, di, N)}`` — or None; the MoE blocks' aux losses summed
    over the layers, 0-d float32), as the reference's.

    The training forward: with ``aux``, each MoE block computes its aux
    statistics (``moe.moe_block``); without, it runs ``moe.moe_apply``,
    as prefill does, and the sum stays 0. With ``remat``, each layer runs
    under ``rematerialise`` and keeps no cache."""
    if remat and want_cache:
        raise ValueError("a rematerialised stack keeps no cache")
    aux_total = x.new_zeros((), dtype=torch.float32)
    seg_caches = []
    for seg, seg_params in zip(segments, seg_params_list):
        window = seg_window(cfg, seg)
        stacked = {}
        for i, p in enumerate(seg_params):
            call = functools.partial(layer_full, p, cfg=cfg, window=window,
                                     positions=positions, causal=causal,
                                     cross_src=cross_src, want_aux=aux)
            if remat:
                x, aux_l = rematerialise(_without_cache, call, x)
                y = {}
            else:
                x, y, aux_l = call(x=x)
            if aux_l is not None:
                aux_total = aux_total + aux_l
            if not want_cache:
                continue
            # each layer's entries go straight into the stacked buffers,
            # so no layer's copy outlives its layer
            for name, t in y.items():
                if name not in stacked:
                    stacked[name] = t.new_empty((len(seg_params),) + t.shape)
                stacked[name][i] = t
        seg_caches.append(stacked if want_cache else None)
    return x, seg_caches, aux_total


def _without_cache(call, x):
    """A layer's (x, aux) without its cache entries: what a
    rematerialised layer returns."""
    x, _, aux = call(x=x)
    return x, aux


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
        window = seg_window(cfg, seg)
        for i, p in enumerate(seg_params):
            x = layer_decode(p, x, {name: t[i] for name, t in
                                    seg_cache.items()}, cfg, window, pos,
                             cross)
    return x, {"pos": pos + 1, "segments": cache["segments"]}
