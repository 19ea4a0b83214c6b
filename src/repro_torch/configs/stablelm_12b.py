"""stablelm-12b [dense] — StableLM-2 family (partial rotary, LayerNorm).
[hf:stabilityai/stablelm-2-1_6b (family); 12B sizing per assignment]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-12b",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    norm="layernorm",
    activation="silu",
    rotary_pct=0.25,           # stablelm-2 partial rotary embeddings
    rope_theta=10_000.0,
    qkv_bias=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
