"""Hymba-1.5B hybrid-head decoder [arXiv:2411.13676].

32 layers, d_model 1600, 25 attention heads (GQA kv=5, head_dim 64)
running in PARALLEL with Mamba heads inside every layer (outputs fused
by per-path norms and a mean); d_ff 5504, vocab 32001, SSM state 16.
Most layers use sliding-window attention (1024); three layers (first,
middle, last) are global.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", arch_type="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32_001,
    attn_pattern="mixed", sliding_window=1024, global_layers=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, d_conv=4, expand=2),
    mlp_act="swiglu", rope_theta=10_000.0,
    citation="arXiv:2411.13676 (Hymba)",
)
