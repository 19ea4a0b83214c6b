"""arctic-480b [moe] — 128 routed experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (per expert) vocab=32000.
Arctic's dense-MoE hybrid: a dense residual MLP runs in parallel with the
routed expert FFN in every layer."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                 # dense-residual MLP width
    moe_d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    norm="rmsnorm",
    activation="silu",
    rope_theta=10_000.0,
    capacity_factor=1.25,
    remat=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
