"""The model stack of the port: layers, the MoE and Mamba-2 layers, the
model, the weight carry."""
from .carry import params_from_reference, params_to, params_to_reference, specs_to_reference
from .layers import (
    ParamDecl,
    apply_attention,
    apply_mlp,
    apply_norm,
    make_positions,
    rope,
    specs_from_decl,
)
from .model import DecodeCache, Model
from .moe import apply_moe, moe_decl, router_aux_loss
from .ssm import apply_mamba, init_ssm_state, mamba_decl, mamba_decode_step, ssd_reference

__all__ = [
    "Model", "DecodeCache", "ParamDecl", "apply_attention", "apply_mlp",
    "apply_norm", "rope", "make_positions", "params_from_reference", "params_to",
    "params_to_reference", "specs_from_decl", "specs_to_reference",
    "apply_mamba", "init_ssm_state", "mamba_decl", "mamba_decode_step", "ssd_reference",
    "apply_moe", "moe_decl", "router_aux_loss",
]
