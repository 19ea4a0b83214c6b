"""zamba2-7b [zamba2] — Zamba2-7B-Instruct at its published settings.
[arXiv:2411.15242; https://huggingface.co/Zyphra/Zamba2-7B-Instruct]

81 Mamba-2 layers of hidden 3584 (d_inner 7168, 112 heads of 64, state 64,
2 groups, conv 4); 13 shared-block sites (layers 6, 11, 17, ..., 77) over 2
shared blocks taken in turn: 32 heads of 224 over the 7168-wide
concatenation of the hidden state and the embedding, a gated MLP of 14336
with a rank-128 adapter per site, and a 3584 x 3584 linear per site;
vocabulary 32000, tied embeddings.  ``ssd_chunk`` is 128, the SSD kernels'
chunk, where the published ``chunk_size`` is 256: the blocking of the
same scan."""
from .zamba2 import Zamba2Config

CONFIG = Zamba2Config(
    arch_id="zamba2-7b",
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    norm_eps=1e-5,
    rope_theta=10_000.0,
    tie_embeddings=True,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=2,
    ssm_conv=4,
    ssd_chunk=128,
    shared_sites=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
    scan_layers=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
