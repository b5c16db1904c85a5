"""Granite-3.0 1B-A400M fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model 1024, 16 heads (GQA kv=8, head_dim 64), per-expert d_ff 512,
32 experts top-8, vocab 49155.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", arch_type="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155,
    moe=MoEConfig(n_experts=32, top_k=8),
    mlp_act="swiglu", rope_theta=10_000.0,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
