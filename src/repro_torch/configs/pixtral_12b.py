"""pixtral-12b [vlm] — Pixtral-ViT frontend (STUBBED) + Mistral-Nemo decoder.
[hf:mistralai/Pixtral-12B-2409]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
The vision encoder/projector is a stub: input_specs() provides precomputed
patch embeddings (B, num_patches, d_model) scattered at image-token slots.
Mistral lineage -> sliding-window variant available for long_500k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    num_patches=1024,          # stub frontend: 1024 patch embeddings
    image_token_id=10,
    # sliding_window stays None here; the launcher enables window=8192 for the
    # long_500k shape only (sub-quadratic carve-out, see DESIGN.md).
    dtype="bfloat16",
    param_dtype="bfloat16",
)
