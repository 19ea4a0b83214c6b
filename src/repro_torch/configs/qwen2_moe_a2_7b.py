"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

24L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=151936.
Shared experts are modeled as one always-on gated MLP of width 4*1408=5632
with a sigmoid shared-expert gate (matches the HF implementation)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    shared_expert_d_ff=1408,   # x4 shared experts -> one 5632-wide MLP
    qkv_bias=True,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    capacity_factor=1.25,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
