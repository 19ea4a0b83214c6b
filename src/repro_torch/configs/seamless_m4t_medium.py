"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596]

12L (decoder) + 12L (encoder) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The mel-spectrogram/conv feature extractor is a STUB: input_specs() provides
precomputed frame embeddings (B, enc_seq_len, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="encdec",
    source="arXiv:2308.11596",
    num_layers=12,             # decoder layers
    num_enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    activation="gelu",
    enc_seq_len=4096,          # stubbed audio frame-embedding length
    dtype="bfloat16",
    param_dtype="bfloat16",
)
