"""Model facade — the port of ``repro/models/model.py`` for every family
of the reference (dense, state-space, hybrid, mixture-of-experts,
vision-language and encoder-decoder):

    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    loss, metrics = model.loss(params, {"tokens": tokens})
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len=...)
    logits, cache = model.decode(params, cache, tokens)   # (B, 1) tokens
    specs = model.input_specs(INPUT_SHAPES["decode_32k"])  # meta tensors

A ``vlm`` model's prefill also takes ``batch["img_embeds"]`` (B,
n_img_tokens, d_model), the stub frontend's patch embeddings, as the
reference's does; they go through ``proj_img`` and are prepended to the
token embeddings, so positions and the cache's ``pos`` count them. An
``audio`` (encoder-decoder) model's prefill also takes
``batch["frames"]`` (B, enc_seq, d_model), the stub frontend's frame
embeddings: cast to ``cfg.dtype``, they run through the encoder (a
dense stack of ``n_enc_layers`` layers, every position kept, and its
final norm), whose output each decoder layer projects to its own cross
K/V, kept in the cache as ``ck``/``cv``. Decode takes tokens only.

Params are a plain dict: ``{"embed": {"w"}, "final_norm": {"g"},
"segments": [[layer dict, ...], ...]}``, with ``lm_head`` where the
embeddings are untied, ``proj_img`` in a ``vlm`` model and ``encoder``
(``{"segments", "final_norm"}``) in an encoder-decoder, whose decoder
layers also hold ``cross`` and ``ln_cross`` (``convert.model_params``
carries the reference's stacked params across).

``loss`` is the reference's training forward: next-token cross-entropy
in float32 over the text tokens, through K3 with its backward (P2) and
the selective scan K6 with its backward (P3) on the card, plus the MoE
blocks' weighted aux loss in the moe family.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mamba import mamba_cache_spec


class Model:
    def __init__(self, cfg):
        T.check_supported(cfg)
        self.cfg = cfg
        self.segments = T.segments_of(cfg)
        self.enc_cfg, self.enc_segments = None, ()
        if cfg.is_encdec:     # the encoder: dense, every layer global
            self.enc_cfg = dataclasses.replace(
                cfg, n_layers=cfg.n_enc_layers, attn_pattern="full",
                global_layers=(), global_interval=0, moe=None, ssm=None,
                arch_type="dense")
            self.enc_segments = T.segments_of(self.enc_cfg)

    # ---------------- init ----------------
    def init(self, seed: int = 0, device=None):
        """Random params from ``seed``, drawn on ``device`` itself by one
        ``torch.Generator`` there, so a served 7 B model is neither drawn
        on the host nor held there (~15 GB per bf16 variant) before the
        copy: drawing Falcon-Mamba-7B on the host takes over a minute per
        variant (``tools/torch_init_time.py``), on the card a fraction of
        a second. The weights of one seed depend on the device's kind:
        every card gives the same ones, but the card's Philox draws
        differ from the CPU's, so a comparison across the two copies the
        params instead of reseeding."""
        cfg = self.cfg
        dev = resolve_device(device)
        if dev.type == "cuda":
            T.check_kernel_shapes(cfg)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = {
            "embed": {"w": (torch.randn((cfg.padded_vocab, cfg.d_model),
                                        generator=gen, device=dev)
                            * cfg.d_model ** -0.5).to(L.dt(cfg.dtype))},
            "final_norm": L.init_rmsnorm(cfg.d_model, dev),
            "segments": [T.init_segment(gen, cfg, seg, cross=cfg.is_encdec)
                         for seg in self.segments],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.init_linear(gen, cfg.d_model,
                                              cfg.padded_vocab,
                                              L.dt(cfg.dtype))
        if cfg.arch_type == "vlm":
            params["proj_img"] = L.init_linear(gen, cfg.d_model, cfg.d_model,
                                               L.dt(cfg.dtype))
        if cfg.is_encdec:
            params["encoder"] = {
                "segments": [T.init_segment(gen, self.enc_cfg, seg)
                             for seg in self.enc_segments],
                "final_norm": L.init_rmsnorm(cfg.d_model, dev)}
        return params

    # ---------------- shared pieces ----------------
    def _embed(self, params, tokens):
        cfg = self.cfg
        dtype = L.dt(cfg.dtype)
        w = params["embed"]["w"]
        # a vocab-split table takes the lookup with a DTensor strategy
        x = torch.nn.functional.embedding(tokens.long(), w) \
            if sharding.is_dtensor(w) else w[tokens.long()]
        x = x.to(dtype) * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
        return sharding.logical(x, "batch", "seq", "embed")

    def _inputs_full(self, params, batch):
        """Token embeddings, behind the projected image embeddings in a
        ``vlm`` model. Returns (x, the number of prefix positions)."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.arch_type == "vlm":
            img = L.linear(params["proj_img"],
                           batch["img_embeds"].to(x.dtype))
            # proj_img's columns split over 'model': the prefix placed
            # as the token embeddings are before the two are joined
            img = sharding.logical(img, "batch", "seq", "embed")
            return torch.cat([img, x], dim=1), img.shape[1]
        return x, 0

    def _encode(self, params, frames):
        """The encoder over ``frames`` (B, enc_seq, d_model), cast to
        ``cfg.dtype``: every position kept, RoPE at ``arange(enc_seq)``,
        then the encoder's final norm. Returns (B, enc_seq, d_model)."""
        x = frames.to(L.dt(self.cfg.dtype))
        x, _, _ = T.run_stack_full(self.enc_segments,
                                   params["encoder"]["segments"], x,
                                   self.enc_cfg, None, causal=False)
        return L.rmsnorm(params["encoder"]["final_norm"], x,
                         self.cfg.rms_norm_eps)

    def _logits(self, params, x):
        x = L.rmsnorm(params["final_norm"], x, self.cfg.rms_norm_eps)
        if self.cfg.tie_embeddings:
            logits = x @ params["embed"]["w"].to(x.dtype).T
        else:
            logits = L.linear(params["lm_head"], x)
        return sharding.logical(logits, "batch", "seq", "vocab")

    # ---------------- training forward ----------------
    def loss(self, params, batch, *, remat: bool = True,
             loss_chunk: int = 0):
        """Next-token cross-entropy over ``batch["tokens"]`` (B, S) (with
        the stub embeddings a ``vlm`` or ``audio`` model takes), as the
        reference's ``Model.loss``: the decoder stack (each layer under
        ``transformer.rematerialise`` with ``remat``; an encoder-decoder's
        encoder over ``batch["frames"]`` is not rematerialised), the final
        norm, then over the text positions only, chunks of ``loss_chunk``
        positions (``FLAGS["loss_chunk"]`` when 0), each rematerialised
        too: the head's logits in float32, the padded vocab columns at
        -1e30, ``logsumexp - gold`` summed. The last chunk is shorter
        where ``loss_chunk`` does not divide S - 1, the same sum the
        reference takes over its padded and masked chunk. Divided by
        ``B (S - 1)``. Returns (loss, {"loss": the cross-entropy,
        "aux_loss"}): a moe model adds ``aux_loss_weight`` times the
        layers' summed aux loss to the loss it returns."""
        from repro_torch.tuning import FLAGS
        loss_chunk = loss_chunk or FLAGS["loss_chunk"]
        cfg = self.cfg
        x, n_prefix = self._inputs_full(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        cross_src = self._encode(params, batch["frames"]) \
            if cfg.is_encdec else None
        x, _, aux = T.run_stack_full(self.segments, params["segments"], x,
                                     cfg, positions, cross_src=cross_src,
                                     aux=True, remat=remat)
        x = L.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
        x = x[:, n_prefix:]                       # predict only text tokens
        tokens = batch["tokens"].long()
        inputs_x, targets = x[:, :-1], tokens[:, 1:]
        head = params["embed"]["w"] if cfg.tie_embeddings else None

        def chunk_loss(xc, tc):
            if head is not None:
                logits = xc @ head.to(xc.dtype).T
            else:
                logits = L.linear(params["lm_head"], xc)
            logits = logits.float()
            if cfg.padded_vocab > cfg.vocab_size:
                logits = torch.cat([logits[..., :cfg.vocab_size],
                                    logits.new_full(
                                        logits.shape[:-1]
                                        + (cfg.padded_vocab
                                           - cfg.vocab_size,), -1e30)], -1)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, tc[..., None])[..., 0]
            return (lse - gold).sum()

        s = inputs_x.shape[1]
        total = x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, s, loss_chunk):
            xc, tc = inputs_x[:, c0:c0 + loss_chunk], \
                targets[:, c0:c0 + loss_chunk]
            total = total + (T.rematerialise(chunk_loss, xc, tc) if remat
                             else chunk_loss(xc, tc))
        loss = total / (inputs_x.shape[0] * s)
        metrics = {"loss": loss, "aux_loss": aux}
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux
        return loss, metrics

    # ---------------- prefill ----------------
    def prefill(self, params, batch, *, max_len: Optional[int] = None):
        """Run the full prompt (behind its image prefix in a ``vlm``
        model, cross-attending the encoded ``batch["frames"]`` in an
        encoder-decoder); return (last-token logits (B, 1, Vp), decode
        cache)."""
        x, _ = self._inputs_full(params, batch)
        s_total = x.shape[1]
        max_len = max_len or s_total
        positions = torch.arange(s_total, device=x.device)[None, :]
        cross_src = self._encode(params, batch["frames"]) \
            if self.cfg.is_encdec else None
        x, seg_ys, _ = T.run_stack_full(self.segments, params["segments"],
                                        x, self.cfg, positions,
                                        cross_src=cross_src, want_cache=True)
        logits = self._logits(params, x[:, -1:])
        return logits, self._cache_from_prefill(seg_ys, s_total, max_len)

    def _cache_from_prefill(self, seg_ys, s: int, max_len: int):
        """The last ``min(s, Sc)`` positions of each layer's K/V go to
        ring slots ``arange(s - n_keep, s) % Sc``; the rest stays zero.
        A Mamba layer's ``conv`` window and ``h`` state and an
        encoder-decoder's cross K/V (``ck``/``cv``) carry over as they
        are; a pure-SSM segment has no K/V."""
        segs = []
        for seg, ys in zip(self.segments, seg_ys):
            c = {}
            if "k" in ys:
                sc = self._seg_cache_len(seg, max_len)
                for name in ("k", "v"):
                    kv = ys[name]               # (Lseg, B, S, KV, hd)
                    if sharding.is_dtensor(kv):
                        # no mesh axis splits S: the ring fill on each
                        # rank's shard (an indexed write into a DTensor
                        # has no strategy everywhere)
                        where = tuple(kv.placements)
                        c[name] = sharding.on_shards(
                            lambda t: _ring(t, s, sc), (kv,), (where,),
                            where)
                    else:
                        c[name] = _ring(kv, s, sc)
            if "ck" in ys:
                c["ck"], c["cv"] = ys["ck"], ys["cv"]
            if "conv" in ys:
                c["conv"], c["h"] = ys["conv"], ys["h"]
            segs.append(c)
        cache = {"pos": s, "segments": segs}
        mesh = sharding.current_mesh()
        if sharding.is_model_mesh(mesh):
            # the decode cache at its placements (``batch_specs``): a
            # cache of kv heads the model axis does not divide goes to a
            # split of its slots, each rank keeping its block
            cache["segments"] = _placed(segs, sharding.batch_specs(
                {"segments": segs}, mesh)["segments"], mesh)
        return cache

    # ---------------- decode ----------------
    def decode(self, params, cache, tokens):
        """One decode step. tokens: (B, 1) int. Returns (logits (B, 1,
        Vp), cache); the cache's buffers are updated in place."""
        x = self._embed(params, tokens)
        x, new_cache = T.run_stack_decode(self.segments, params["segments"],
                                          x, cache, self.cfg, cache["pos"])
        return self._logits(params, x), new_cache

    # ---------------- specs (dry run; no allocation) ----------------
    def _seg_cache_len(self, seg: T.Segment, ctx: int) -> int:
        if seg.is_global or self.cfg.attn_pattern == "full":
            return ctx
        return min(self.cfg.sliding_window, ctx)

    def cache_spec(self, batch: int, ctx: int):
        """The decode cache of ``batch`` sequences and ``ctx`` positions
        as the reference's tree, each leaf a ``meta`` tensor of its shape
        and dtype (nothing allocated): per segment ``k``/``v`` (Lseg,
        batch, Sc, KV, hd) — int8 with float32 ``k_s``/``v_s`` (Lseg,
        batch, Sc, KV) under ``FLAGS["kv_cache_dtype"] == "int8"`` —,
        an encoder-decoder's ``ck``/``cv`` (Lseg, batch, enc_seq, KV,
        hd), a Mamba block's ``conv``/``h``; ``pos`` a 0-d int32."""
        from repro_torch.tuning import FLAGS
        cfg = self.cfg
        dt_ = L.dt(cfg.dtype)
        kv_int8 = FLAGS["kv_cache_dtype"] == "int8"
        kv_dt = torch.int8 if kv_int8 else dt_
        hd = cfg.resolved_head_dim
        segs = []
        for seg in self.segments:
            c = {}
            if cfg.has_attention:
                sc = self._seg_cache_len(seg, ctx)
                shp = (seg.length, batch, sc, cfg.n_kv_heads, hd)
                c["k"] = _meta(shp, kv_dt)
                c["v"] = _meta(shp, kv_dt)
                if kv_int8:
                    c["k_s"] = _meta(shp[:-1], torch.float32)
                    c["v_s"] = _meta(shp[:-1], torch.float32)
            if cfg.is_encdec:
                shp = (seg.length, batch, cfg.enc_seq, cfg.n_kv_heads, hd)
                c["ck"] = _meta(shp, dt_)
                c["cv"] = _meta(shp, dt_)
            if cfg.ssm is not None:
                for name, (shp, dtype) in mamba_cache_spec(cfg,
                                                           batch).items():
                    c[name] = _meta((seg.length,) + shp, dtype)
            segs.append(c)
        return {"pos": _meta((), torch.int32), "segments": segs}

    def input_specs(self, shape):
        """``meta`` stand-ins for every model input of an ``InputShape``
        (``configs.INPUT_SHAPES``): ``tokens`` (B, S - n_img_tokens in a
        ``vlm`` model) int32 with a VLM's ``img_embeds`` / an
        encoder-decoder's ``frames`` for ``train`` and ``prefill``; one
        token against a ``seq_len``-slot ``cache_spec`` for ``decode``."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt_ = L.dt(cfg.dtype)
        if shape.kind in ("train", "prefill"):
            s_text = s - (cfg.n_img_tokens if cfg.arch_type == "vlm" else 0)
            spec = {"tokens": _meta((b, s_text), torch.int32)}
            if cfg.arch_type == "vlm":
                spec["img_embeds"] = _meta((b, cfg.n_img_tokens,
                                            cfg.d_model), dt_)
            if cfg.is_encdec:
                spec["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), dt_)
            return spec
        return {"tokens": _meta((b, 1), torch.int32),
                "cache": self.cache_spec(b, s)}


def _ring(kv, s: int, sc: int):
    """The last ``min(s, sc)`` of the ``s`` positions of ``kv`` (Lseg, B,
    S, KV, hd) in ring slots ``arange(s - n_keep, s) % sc`` of a zeroed
    (Lseg, B, sc, KV, hd) cache."""
    n_keep = min(s, sc)
    buf = kv.new_zeros(kv.shape[:2] + (sc,) + kv.shape[3:])
    slots = torch.arange(s - n_keep, s, device=kv.device) % sc
    buf[:, :, slots] = kv[:, :, s - n_keep:]
    return buf


def _placed(tree, specs, mesh):
    """The tensors of ``tree`` redistributed to ``specs`` on ``mesh``."""
    if isinstance(tree, dict):
        return {k: _placed(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placed(v, s, mesh) for v, s in zip(tree, specs)]
    return sharding.place(tree, specs, mesh)


def _meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the ``meta`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def build_model(cfg) -> Model:
    return Model(cfg)
