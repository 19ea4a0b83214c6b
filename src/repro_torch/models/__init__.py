"""The dense model stack of the port: layers, the model, the weight carry."""
from .carry import params_from_reference, params_to
from .layers import ParamDecl, apply_attention, apply_mlp, apply_norm, make_positions, rope
from .model import DecodeCache, Model, check_ported

__all__ = [
    "Model", "DecodeCache", "check_ported", "ParamDecl", "apply_attention", "apply_mlp",
    "apply_norm", "rope", "make_positions", "params_from_reference", "params_to",
]
