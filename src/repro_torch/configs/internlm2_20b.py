"""InternLM2-20B dense GQA decoder [arXiv:2403.17297].

48L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), d_ff 16384,
vocab 92544, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", arch_type="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92_544,
    mlp_act="swiglu", rope_theta=1_000_000.0, tie_embeddings=False,
    citation="arXiv:2403.17297 (InternLM2)",
)
