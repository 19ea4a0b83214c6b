"""zamba2-1.2b [hybrid] — Mamba-2 backbone + weight-shared attention blocks.
[arXiv:2411.15242]

38L d_model=2048 32H (kv=32) d_ff=8192 ssm_state=64.  One *shared*
(weight-tied) attention+MLP block fires every 6th layer (7 sites)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv=4,
    ssd_chunk=128,
    attn_every=6,
    norm="rmsnorm",
    activation="gelu",
    scan_layers=False,         # hybrid sites need distinct cache slots
    dtype="bfloat16",
    param_dtype="bfloat16",
)
