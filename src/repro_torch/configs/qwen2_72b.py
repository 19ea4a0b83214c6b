"""qwen2-72b [dense] — GQA kv=8, QKV bias.  [arXiv:2407.10671]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-72b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=False,
    remat=True,                # 80 layers: remat the scanned block for train
    dtype="bfloat16",
    param_dtype="bfloat16",
)
