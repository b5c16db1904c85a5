"""Model-variant ladder — the port of ``repro/models/variants.py``: any
``ModelConfig`` expands into the paper's 8-point Table-4 ladder, width in
{1.0, 0.75, 0.5, 0.25} x quant in {none, int8}, each variant with its
per-token MAC count and the Table-4 accuracy metadata. The width scales
heads and d_ff only (``scale_width``), so a pure SSM such as
Falcon-Mamba has two distinct shapes: d0..d3 and d4..d7, as in the
reference."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, scale_width
from repro_torch.configs.edge_ladder import MOBILENET_TABLE4

WIDTHS = (1.0, 0.75, 0.5, 0.25)


@dataclasses.dataclass(frozen=True)
class Variant:
    vid: str                      # d0..d7
    cfg: ModelConfig
    million_macs: float           # per-token forward MACs (analytic)
    top1: float                   # paper Table 4 metadata
    top5: float
    dtype_tag: str                # fp32-equivalent ("none") or int8


def per_token_macs(cfg: ModelConfig) -> float:
    """Analytic forward MACs per generated token (weights touched once)."""
    return cfg.active_param_count() / 1e6


def build_ladder(cfg: ModelConfig) -> Dict[str, Variant]:
    """d0..d7 variants of ``cfg`` mirroring the paper's Table 4 ladder."""
    out = {}
    for i, (vid, _macs, dt_, t1, t5) in enumerate(MOBILENET_TABLE4):
        quant = "int8" if dt_ == "int8" else "none"
        vcfg = scale_width(cfg, WIDTHS[i % 4], quant=quant)
        out[vid] = Variant(vid=vid, cfg=vcfg,
                           million_macs=per_token_macs(vcfg),
                           top1=t1, top5=t5, dtype_tag=dt_)
    return out
