"""Yi-34B llama-architecture dense GQA decoder [arXiv:2403.04652].

60L, d_model 7168, 56 heads (GQA kv=8, head_dim 128), d_ff 20480,
vocab 64000, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", arch_type="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64_000,
    mlp_act="swiglu", rope_theta=5_000_000.0, tie_embeddings=False,
    citation="arXiv:2403.04652 (Yi)",
)
