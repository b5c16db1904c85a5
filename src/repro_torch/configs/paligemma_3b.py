"""PaliGemma-3B language backbone [arXiv:2407.07726].

SigLIP vision tower + projector are STUBS: the caller supplies 256
precomputed patch embeddings of shape (B, 256, 2048) as
``batch["img_embeds"]``, projected and prepended to the text sequence
(see models/model.py). Backbone = Gemma-2B-style
decoder: 18L, d_model 2048, 8 heads with MQA-style kv=1, head_dim 256,
d_ff 16384 (GeGLU), vocab 257216.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", arch_type="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257_216,
    n_img_tokens=256, mlp_act="geglu", rope_theta=10_000.0,
    citation="arXiv:2407.07726 (PaliGemma); gemma backbone arXiv:2403.08295",
)
