"""Gemma3-4B dense decoder with 5:1 local:global attention
[hf:google/gemma-3-1b-pt family card, arXiv:2503.19786].

34L, d_model 2560, 8 heads (GQA kv=4, head_dim 256), d_ff 10240,
vocab 262144. Every 6th layer is global full attention; the other five
use a 1024-token sliding window -> long-context (128k+) capable, and the
only *dense* arch we run at long_500k (window caps the KV of 5/6 layers;
global layers shard their 524k KV over the 'data' axis).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", arch_type="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262_144,
    attn_pattern="mixed", sliding_window=1024, global_interval=6,
    mlp_act="geglu", rope_theta=1_000_000.0,
    citation="hf:google/gemma-3-1b-pt; arXiv:2503.19786",
)
