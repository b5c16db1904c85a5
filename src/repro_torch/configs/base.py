"""Model configuration — the port's own copy of ``repro/configs/base.py``.

``ModelConfig`` keeps every field and derived property of the reference
(so analytic counts such as ``active_param_count`` agree), and
``scale_width`` is the variant-ladder scaling and ``reduced`` the
smoke-test cut of a family. ``get_config`` knows the configurations the
port can build: ``edge-ladder`` (the paper's Table-4 ladder as a small
decoder transformer), the dense ``internlm2-20b`` and ``yi-34b`` (GQA,
head_dim 128), ``gemma-7b`` and ``gemma3-4b`` (head_dim 256, Gemma3
with 5:1 sliding:global layers), the VLM ``paligemma-3b`` (a
Gemma-style decoder behind a stub image prefix), ``falcon-mamba-7b``
(pure Mamba-1 SSM), ``hymba-1.5b`` (attention and Mamba heads in
parallel), the mixture-of-experts ``granite-moe-1b-a400m`` and
``dbrx-132b``, and the encoder-decoder ``whisper-medium`` (a stub audio
frontend's 1,500 frames through 24 encoder layers, cross-attended by
24 decoder layers): every configuration of the reference. Every one
runs on the card; DBRX's 263 GB in bf16 and Yi's 69 GB do not fit one
beside the rest, so the card runs them cut in depth.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass, replace
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, math.ceil(d_model / 16))


@dataclass(frozen=True)
class ModelConfig:
    """Architecture-describing config (decoder-transformer centric);
    ``arch_type`` in {dense, moe, ssm, hybrid, vlm, audio}."""
    name: str
    arch_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    attn_pattern: str = "full"           # full | sliding | mixed
    sliding_window: int = 4096
    global_interval: int = 0
    global_layers: tuple = ()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    n_enc_layers: int = 0
    enc_seq: int = 0
    n_img_tokens: int = 0
    mlp_act: str = "swiglu"              # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    quant: str = "none"                  # none | int8
    width_mult: float = 1.0
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    citation: str = ""

    # ---- derived -----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_mlp(self) -> bool:
        return self.d_ff > 0

    def layer_is_global(self, layer_id: int) -> bool:
        """Whether ``layer_id`` uses full (global) attention."""
        if self.attn_pattern == "full":
            return True
        if self.attn_pattern == "sliding":
            return False
        if self.global_layers:
            return layer_id in self.global_layers
        if self.global_interval:
            return (layer_id + 1) % self.global_interval == 0
        return True

    def global_layer_mask(self) -> tuple:
        return tuple(self.layer_is_global(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d = self.d_model
        n_attn = self.n_layers if self.arch_type != "ssm" else 0
        p = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.has_attention and self.arch_type != "ssm":
            per = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            p += n_attn * per
        if self.moe:
            per = d * self.moe.n_experts \
                + self.moe.n_experts * 3 * d * self.d_ff
            p += self.n_layers * per
        elif self.has_mlp:
            n_mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            p += self.n_layers * n_mats * d * self.d_ff
        if self.ssm is not None:
            di = self.d_inner
            dtr = self.ssm.resolved_dt_rank(d)
            per = (d * 2 * di + di * self.ssm.d_conv
                   + di * (dtr + 2 * self.ssm.state_dim)
                   + dtr * di + di + di * self.ssm.state_dim + di + di * d)
            p += self.n_layers * per
        p += self.n_layers * 2 * d + d
        if self.is_encdec:
            enc = self.n_enc_layers * (
                2 * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
                // 2 + 2 * d * self.d_ff + 2 * d)
            cross = self.n_layers * (d * self.q_dim + 2 * d * self.kv_dim
                                     + self.q_dim * d + d)
            p += enc + cross
        return p

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.moe:
            return self.param_count()
        expert_p = self.n_layers * self.moe.n_experts * 3 * self.d_model \
            * self.d_ff
        active_p = self.n_layers * self.moe.top_k * 3 * self.d_model \
            * self.d_ff
        return self.param_count() - expert_p + active_p


@dataclass(frozen=True)
class InputShape:
    """One input shape of the dry run: ``global_batch`` sequences of
    ``seq_len`` tokens for a ``kind`` of call: ``train`` (a training
    step), ``prefill`` (a prompt) or ``decode`` (one token against a
    ``seq_len``-slot cache)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

#: the published architectures, in the reference's order
ARCH_IDS = [
    "paligemma-3b", "dbrx-132b", "internlm2-20b", "gemma3-4b",
    "whisper-medium", "yi-34b", "granite-moe-1b-a400m", "hymba-1.5b",
    "falcon-mamba-7b", "gemma-7b",
]

#: arch id -> module of ``repro_torch.configs`` holding its ``CONFIG``
_MODULE_FOR = {"edge-ladder": "edge_ladder",
               "internlm2-20b": "internlm2_20b",
               "yi-34b": "yi_34b",
               "gemma-7b": "gemma_7b",
               "gemma3-4b": "gemma3_4b",
               "paligemma-3b": "paligemma_3b",
               "falcon-mamba-7b": "falcon_mamba_7b",
               "hymba-1.5b": "hymba_1_5b",
               "granite-moe-1b-a400m": "granite_moe_1b_a400m",
               "dbrx-132b": "dbrx_132b",
               "whisper-medium": "whisper_medium"}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"repro_torch has no config {arch_id!r}; it knows "
                       f"{sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.CONFIG


def list_archs() -> list:
    return list(ARCH_IDS)


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            n_heads: int = 4, d_ff: int = 512, vocab: int = 512,
            max_experts: int = 4) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers, d_model<=512,
    <=4 experts, preserving arch_type/attention pattern/SSM-ness."""
    kv = max(1, min(cfg.n_kv_heads, n_heads // 2))
    moe = None
    if cfg.moe:
        ne = min(cfg.moe.n_experts, max_experts)
        moe = replace(cfg.moe, n_experts=ne,
                      top_k=min(cfg.moe.top_k, max(1, ne // 2)))
    upd = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=kv,
        head_dim=d_model // n_heads, d_ff=(d_ff if cfg.d_ff else 0),
        vocab_size=vocab, moe=moe, ssm=cfg.ssm,
        sliding_window=min(cfg.sliding_window, 64),
        global_interval=(min(cfg.global_interval, n_layers)
                         if cfg.global_interval else 0),
        global_layers=(tuple(g for g in cfg.global_layers if g < n_layers)
                       or ((n_layers - 1,) if cfg.global_layers else ())),
        n_enc_layers=(n_layers if cfg.n_enc_layers else 0),
        enc_seq=(32 if cfg.enc_seq else 0),
        n_img_tokens=(8 if cfg.n_img_tokens else 0),
    )
    return replace(cfg, **upd)


def scale_width(cfg: ModelConfig, width_mult: float,
                quant: str = "none") -> ModelConfig:
    """Variant-ladder scaling (the paper's MobileNet width multiplier):
    shrink d_ff and the q/kv head counts uniformly; ``quant`` switches
    the projections' matmul type."""
    def rnd(x, m=8):
        return max(m, int(round(x * width_mult / m)) * m)
    nh = max(1, int(round(cfg.n_heads * width_mult)))
    # keep GQA grouping valid: n_kv must divide n_heads
    nkv = max(d for d in range(1, nh + 1)
              if nh % d == 0 and d <= max(1, cfg.n_kv_heads))
    return replace(
        cfg,
        d_ff=rnd(cfg.d_ff) if cfg.d_ff else 0,
        n_heads=nh, n_kv_heads=nkv,
        width_mult=width_mult, quant=quant,
        name=f"{cfg.name}-w{width_mult}{'-int8' if quant == 'int8' else ''}",
    )
