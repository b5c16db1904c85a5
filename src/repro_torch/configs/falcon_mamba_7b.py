"""Falcon-Mamba-7B pure Mamba-1 SSM [arXiv:2410.05355].

64 Mamba blocks, d_model 4096 (d_inner 8192, state 16, conv 4), no
attention, no separate MLP (d_ff=0), vocab 65024, untied head. Decode
carries an O(1) state per layer (conv window and SSM state).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=0, vocab_size=65_024,
    attn_pattern="none",
    ssm=SSMConfig(state_dim=16, d_conv=4, expand=2),
    tie_embeddings=False,
    citation="arXiv:2410.05355 (Falcon-Mamba)",
)
