"""Gemma-7B dense decoder [arXiv:2403.08295].

28L, d_model 3072, 16 heads (MHA kv=16, head_dim 256), d_ff 24576
(GeGLU), vocab 256000, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", arch_type="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256_000,
    mlp_act="geglu", rope_theta=10_000.0, tie_embeddings=True,
    citation="arXiv:2403.08295 (Gemma)",
)
