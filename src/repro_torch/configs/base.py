"""Unified model configuration covering all six assigned architecture families
(dense / MoE / SSM / hybrid / encoder-decoder audio / VLM).

A field-for-field copy of the reference's ``repro/configs/base.py``.  The
port serves the ``dense`` family; ``use_pallas`` is kept for equality with
the reference and is not read: the port always calls its attention
wrappers, which launch the Hopper kernels on CUDA tensors."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "reduce_for_smoke"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str = "unnamed"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""               # citation (paper / model card)

    # trunk
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # flavor
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    activation: str = "silu"       # silu | gelu
    gated_mlp: bool = True         # False = classic 2-matrix GPT MLP (starcoder2)
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0        # stablelm-2 uses 0.25
    qkv_bias: bool = False         # qwen2 uses True
    attn_out_bias: bool = False
    mlp_bias: bool = False         # starcoder2 uses True
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # enables ring-buffer decode cache

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None       # expert hidden size (d_ff used if None)
    n_shared_experts: int = 0            # qwen2-moe: always-on experts
    shared_expert_d_ff: Optional[int] = None
    dense_residual: bool = False         # arctic: dense MLP parallel to MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssd_chunk: int = 128

    # hybrid (zamba2): one weight-shared attention block applied every k layers
    attn_every: int = 0

    # encoder-decoder (audio)
    num_enc_layers: int = 0
    enc_seq_len: int = 4096        # stubbed frame-embedding length for specs

    # VLM: stubbed vision frontend hands (B, num_patches, d_model) embeddings
    num_patches: int = 0
    image_token_id: int = 10       # token id replaced by patch embeddings

    # numerics / compile
    kv_cache_dtype: str = "auto"   # auto (activation dtype) | int8 (quantized)
    attn_impl: str = "reference"   # reference | chunked (flash-style, fused)
    attn_block: int = 1024         # q-chunk for the chunked path
    dtype: str = "float32"
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "full"     # full | dots (save matmuls, recompute rest)
    use_pallas: bool = False       # route attention/SSD through Pallas kernels
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # -- derived -------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def effective_moe_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    # -- what the shared layers read; the ``zamba2`` family's configuration
    #    (configs/zamba2.py) overrides them ------------------------------------
    @property
    def attn_in(self) -> int:
        """The width that attention's q, k and v read."""
        return self.d_model

    @property
    def attn_scale(self) -> Optional[float]:
        """The softmax scale; ``None`` is 1/sqrt(head_dim)."""
        return None

    @property
    def norm_groups(self) -> int:
        """The groups of the Mamba-2 block's gated RMSNorm."""
        return 1

    @property
    def shared_sites(self) -> Tuple[int, ...]:
        """The layers before which a shared block runs."""
        return ()

    def n_params(self) -> int:
        """Approximate parameter count (for scaling-law accuracy proxies and
        MODEL_FLOPS = 6·N·D bookkeeping)."""
        d, hd = self.d_model, self.head_dim
        mf = 3 if self.gated_mlp else 2  # matrices per MLP
        p = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "vlm"):
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            if self.family == "moe":
                ff = 3 * d * self.effective_moe_d_ff * self.n_experts
                ff += 3 * d * (self.shared_expert_d_ff or self.effective_moe_d_ff) * self.n_shared_experts
                if self.dense_residual:
                    ff += mf * d * self.d_ff
            else:
                ff = mf * d * self.d_ff
            p += self.num_layers * (attn + ff)
        elif self.family == "ssm":
            p += self.num_layers * self._mamba_block_params()
        elif self.family == "hybrid":
            p += self.num_layers * self._mamba_block_params()
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            p += attn + mf * d * self.d_ff  # one shared block
        elif self.family == "encdec":
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            ff = mf * d * self.d_ff
            p += self.num_enc_layers * (attn + ff)
            p += self.num_layers * (2 * attn + ff)  # self + cross per dec layer
        return int(p)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        all_ff = 3 * d * self.effective_moe_d_ff * self.n_experts * self.num_layers
        act_ff = 3 * d * self.effective_moe_d_ff * self.top_k * self.num_layers
        return int(full - all_ff + act_ff)

    def _mamba_block_params(self) -> int:
        d, di, ns = self.d_model, self.d_inner, self.ssm_state
        g = self.ssm_ngroups
        in_proj = d * (2 * di + 2 * g * ns + self.ssm_nheads)
        conv = self.ssm_conv * (di + 2 * g * ns)
        out = di * d
        return in_proj + conv + out + 3 * self.ssm_nheads + di


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests:
    2 layers, d_model <= 512, <= 4 experts (spec requirement)."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    return dataclasses.replace(
        cfg,
        num_layers=2,
        num_enc_layers=min(cfg.num_enc_layers, 2),
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d // heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else cfg.d_ff,
        moe_d_ff=min(cfg.effective_moe_d_ff, 256) if cfg.n_experts else None,
        shared_expert_d_ff=min(cfg.shared_expert_d_ff, 256) if cfg.shared_expert_d_ff else None,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=min(cfg.ssm_headdim, 32),
        ssd_chunk=32,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        num_patches=min(cfg.num_patches, 16) if cfg.num_patches else 0,
        enc_seq_len=min(cfg.enc_seq_len, 64),
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else None,
        scan_layers=False,
        dtype="float32",
        param_dtype="float32",
    )
