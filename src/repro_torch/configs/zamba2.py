"""The ``zamba2`` family's configuration: Zamba2's published shared blocks
(arXiv:2411.15242; transformers' ``models/zamba2/modeling_zamba2.py``).

A Mamba-2 backbone of ``num_layers`` pre-norm layers with ``ssm_ngroups``
groups, whose gated RMSNorm is taken per group.  Before each layer of
``shared_sites`` one of ``num_mem_blocks`` shared transformer blocks runs,
the blocks taken in turn over the sites (site j runs block j mod
``num_mem_blocks``); a block's weights are shared by all its sites.  The
block reads ``concat([h, embedding])``, ``attn_in = 2 d_model`` wide:
RMSNorm over it, causal attention of ``num_heads`` heads of ``head_dim``
(``num_heads * head_dim == attn_in``) with RoPE over the whole head and
the softmax scale ``attn_scale = (head_dim / 2) ** -0.5``, the output
projection back to d_model, RMSNorm, and a gated MLP of exact-erf
GELU(gate) * up whose gate/up product gains the site's own low-rank
adapter (``adapter_rank``); no residual inside the block.  The site's own
linear (d_model -> d_model) takes the block's output, which is added to
the input of the layer's Mamba-2 block before its norm, beside the
residual.

The settings live on :class:`Zamba2Config`, a subclass of the port's
``ModelConfig`` (whose fields stay the reference's).  Each key of the
published ``config.json`` is a field too, derived from the settings when
the configuration is made (never passed), so that a file of published keys
can be held to the configuration field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .base import ModelConfig

__all__ = ["Zamba2Config"]

#: the ``hidden_act`` each of the port's activations is published as
_HIDDEN_ACT = {"gelu_exact": "gelu", "gelu": "gelu_pytorch_tanh", "silu": "silu"}


def _published():
    """A published key: derived in ``__post_init__``, left out of
    comparisons (the settings it comes from are compared)."""
    return dataclasses.field(default=None, init=False, repr=False, compare=False)


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    family: str = "zamba2"
    activation: str = "gelu_exact"
    #: the layers before whose Mamba-2 block a shared block runs
    #: (``hybrid_layer_ids``), ascending
    shared_sites: Tuple[int, ...] = ()
    #: shared blocks, taken in turn over the sites
    num_mem_blocks: int = 2
    #: the rank of each site's adapter on the MLP's gate/up product
    adapter_rank: int = 128

    # -- the published config.json's other keys -------------------------------
    add_bias_linear: Optional[bool] = _published()
    attention_head_dim: Optional[int] = _published()
    attention_hidden_size: Optional[int] = _published()
    chunk_size: Optional[int] = _published()
    ffn_hidden_size: Optional[int] = _published()
    hidden_act: Optional[str] = _published()
    hidden_size: Optional[int] = _published()
    hybrid_layer_ids: Optional[List[int]] = _published()
    intermediate_size: Optional[int] = _published()
    kv_channels: Optional[int] = _published()
    layers_block_type: Optional[List[str]] = _published()
    mamba_d_conv: Optional[int] = _published()
    mamba_d_state: Optional[int] = _published()
    mamba_expand: Optional[int] = _published()
    mamba_headdim: Optional[int] = _published()
    mamba_ngroups: Optional[int] = _published()
    max_position_embeddings: Optional[int] = _published()
    model_type: Optional[str] = _published()
    n_mamba_heads: Optional[int] = _published()
    num_attention_heads: Optional[int] = _published()
    num_hidden_layers: Optional[int] = _published()
    num_key_value_heads: Optional[int] = _published()
    num_logits_to_keep: Optional[int] = _published()
    num_query_groups: Optional[int] = _published()
    rms_norm_eps: Optional[float] = _published()
    time_step_floor: Optional[float] = _published()
    time_step_limit: Optional[Tuple[float, float]] = _published()
    time_step_max: Optional[float] = _published()
    time_step_min: Optional[float] = _published()
    use_conv_bias: Optional[bool] = _published()
    use_long_context: Optional[bool] = _published()
    use_mem_rope: Optional[bool] = _published()
    use_shared_attention_adapter: Optional[bool] = _published()
    use_shared_mlp_adapter: Optional[bool] = _published()

    def __post_init__(self):
        super().__post_init__()
        if self.num_heads * self.head_dim != self.attn_in:
            raise ValueError(f"{self.arch_id}: {self.num_heads} heads of {self.head_dim} do "
                             f"not span the attention input of {self.attn_in}")
        sites = self.shared_sites
        if list(sites) != sorted(set(sites)) or (sites and not 0 <= sites[0] <= sites[-1]
                                                 < self.num_layers):
            raise ValueError(f"{self.arch_id}: shared sites {sites} are not ascending layers "
                             f"of {self.num_layers}")
        for k, v in self._derived().items():
            object.__setattr__(self, k, v)

    def _derived(self) -> Dict[str, Any]:
        """The published keys from the settings; the constants are what the
        family implements: no biases, RoPE in the shared attention, adapters
        on the MLP only, the conv's bias, no dt limit in the forward, the
        initializer's dt range (``layers.init_leaf``: 1e-3 to 1e-1, above
        the floor), and the published position limit (the program sets
        none)."""
        sites = list(self.shared_sites)
        return {
            "add_bias_linear": False,
            "attention_head_dim": self.head_dim,
            "attention_hidden_size": self.attn_in,
            "chunk_size": self.ssd_chunk,
            "ffn_hidden_size": self.d_ff,
            "hidden_act": _HIDDEN_ACT[self.activation],
            "hidden_size": self.d_model,
            "hybrid_layer_ids": sites,
            "intermediate_size": self.d_ff,
            "kv_channels": self.d_model // self.num_heads,
            "layers_block_type": ["hybrid" if i in sites else "mamba"
                                  for i in range(self.num_layers)],
            "mamba_d_conv": self.ssm_conv,
            "mamba_d_state": self.ssm_state,
            "mamba_expand": self.ssm_expand,
            "mamba_headdim": self.ssm_headdim,
            "mamba_ngroups": self.ssm_ngroups,
            "max_position_embeddings": 4096,
            "model_type": self.family,
            "n_mamba_heads": self.ssm_nheads,
            "num_attention_heads": self.num_heads,
            "num_hidden_layers": self.num_layers,
            "num_key_value_heads": self.num_kv_heads,
            "num_logits_to_keep": 1,
            "num_query_groups": self.num_heads,
            "rms_norm_eps": self.norm_eps,
            "time_step_floor": 1e-4,
            "time_step_limit": None,
            "time_step_max": 0.1,
            "time_step_min": 0.001,
            "use_conv_bias": True,
            "use_long_context": False,
            "use_mem_rope": True,
            "use_shared_attention_adapter": False,
            "use_shared_mlp_adapter": True,
        }

    # -- derived: what the shared layers read (models/layers.py, ssm.py) -----
    @property
    def attn_in(self) -> int:
        """The attention input width: the hidden state and the embedding."""
        return 2 * self.d_model

    @property
    def attn_scale(self) -> float:
        """The softmax scale, (head_dim / 2) ** -0.5."""
        return (self.head_dim / 2) ** -0.5

    @property
    def norm_groups(self) -> int:
        """The groups of the Mamba-2 block's gated RMSNorm."""
        return self.ssm_ngroups

    def block_of(self, site: int) -> int:
        """The shared block that site ``site`` runs."""
        return site % self.num_mem_blocks
