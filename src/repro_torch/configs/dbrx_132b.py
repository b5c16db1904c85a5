"""DBRX-132B fine-grained MoE [hf:databricks/dbrx-base].

40L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), per-expert d_ff
10752, 16 experts top-4, vocab 100352. Expert-parallel over the 'model'
mesh axis (one expert per rank on the 16-wide axis).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100_352,
    moe=MoEConfig(n_experts=16, top_k=4),
    mlp_act="swiglu", rope_theta=500_000.0, tie_embeddings=False,
    citation="hf:databricks/dbrx-base",
)
