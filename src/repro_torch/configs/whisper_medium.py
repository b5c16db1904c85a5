"""Whisper-medium encoder-decoder [arXiv:2212.04356].

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA: kv=16,
head_dim 64), d_ff 4096 (GELU), vocab 51865. The mel-spectrogram + conv
frontend is a STUB: input_specs() supplies (B, 1500, 1024) frame
embeddings consumed by the encoder; the decoder cross-attends. Decoder
uses learned-positional-free RoPE here (adaptation noted in DESIGN.md);
decode_32k exercises a 32768-entry self-cache + 1500-entry cross-cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", arch_type="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51_865,
    n_enc_layers=24, enc_seq=1500,
    mlp_act="gelu", tie_embeddings=False,
    citation="arXiv:2212.04356 (Whisper)",
)
