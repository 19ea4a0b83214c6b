"""mamba2-130m [ssm] — pure SSD (state-space duality).  [arXiv:2405.21060]

24L d_model=768, attention-free, ssm_state=128, headdim=64, expand=2."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    num_heads=1,               # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv=4,
    ssd_chunk=128,
    norm="rmsnorm",
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
