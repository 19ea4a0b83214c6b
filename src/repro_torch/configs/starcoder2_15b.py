"""starcoder2-15b [dense] — GQA, RoPE, LayerNorm + biases, GELU.
[arXiv:2402.19173]

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,           # classic 2-matrix GPT MLP (d_ff = 4·d_model)
    rope_theta=100_000.0,
    qkv_bias=True,
    attn_out_bias=True,
    mlp_bias=True,
    sliding_window=4096,       # starcoder2 trains with a 4k sliding window
    dtype="bfloat16",
    param_dtype="bfloat16",
)
