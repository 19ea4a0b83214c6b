"""Carry the reference's parameters into the port.

The reference draws its weights with ``jax.random``, which the port cannot
reproduce, so the two packages compute the same function only on the same
weights: :func:`params_from_reference` takes the reference's parameter tree
as numpy arrays (``jax.tree.map(np.asarray, model.init(key))``) and returns
the port's.  The reference stacks every layer leaf of a layer stack
(``layers``; the encoder-decoder family's ``enc_layers`` and
``dec_layers``) on a leading ``L`` axis (scan over layers); the port keeps
one dict per layer.  That split is the only change of layout, and it lives
here.  Every other subtree (the embedding, the final norms, the
unembedding, the hybrid family's unstacked ``shared_attn`` block) is
carried as it is, and the leaves of a layer like any other leaf: the mamba
leaves (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``,
``D``, ``norm_scale``, ``out_proj``), the MoE leaves (``router``, the
expert weights ``(L, E, d, f)`` / ``(L, E, f, d)`` split into one
``(E, d, f)`` / ``(E, f, d)`` a layer, the ``shared`` and ``dense``
sub-MLPs, ``shared_gate``) and the decoder's cross attention (``ln_x``,
``xattn``).
:func:`params_to_reference` goes the other way, for checkpoints and for
the parity tests.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.instance import resolve_device
from .layers import ParamDecl
from .model import Model

__all__ = [
    "params_from_reference", "params_to_reference", "params_to", "to_numpy", "specs_to_reference",
]


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 included, as ``ml_dtypes`` gives it) as a
    tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _carry(decl, tree, device, where: str):
    if isinstance(decl, ParamDecl):
        t = _tensor(tree, device)
        if tuple(t.shape) != tuple(decl.shape):
            raise ValueError(f"{where}: shape {tuple(t.shape)}, expected {decl.shape}")
        return t
    if set(decl) != set(tree):
        raise ValueError(f"{where}: keys {sorted(tree)}, expected {sorted(decl)}")
    return {k: _carry(decl[k], tree[k], device, f"{where}.{k}") for k in decl}


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """The port's parameters for ``cfg`` from the reference's tree of numpy
    arrays, on ``device`` (default: the CUDA device; raises without one).
    Every leaf keeps its dtype and its shape; each layer stack becomes a
    list of per-layer dicts."""
    dev = resolve_device(device)
    model = Model(cfg)
    decl, stacks = model.decl(), model.stack_sizes()
    if set(decl) != set(tree):
        raise ValueError(f"params: keys {sorted(tree)}, expected {sorted(decl)}")
    out: Dict[str, Any] = {}
    for name, sub in decl.items():
        if name in stacks:
            out[name] = [
                _carry(sub, _index(tree[name], i), dev, f"{name}[{i}]")
                for i in range(stacks[name])
            ]
        else:
            out[name] = _carry(sub, tree[name], dev, name)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host.  numpy has no bfloat16, so a
    bfloat16 tensor comes back as float32, exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_reference(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: the reference's tree of
    numpy arrays for the port's ``params``, every layer leaf stacked on a
    leading axis as the reference's ``init_from_decl(..., stack=)`` lays
    them out (bfloat16 leaves as float32, :func:`to_numpy`)."""
    model = Model(cfg)
    decl, stacks = model.decl(), model.stack_sizes()
    if set(decl) != set(params):
        raise ValueError(f"params: keys {sorted(params)}, expected {sorted(decl)}")
    for name, n in stacks.items():
        if len(params[name]) != n:
            raise ValueError(f"params: {len(params[name])} {name}, expected {n}")

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return to_numpy(tree)

    return {k: _stack([host(layer) for layer in v]) if k in stacks else host(v)
            for k, v in params.items()}


def _stack(layers):
    """Per-layer trees of arrays -> one tree of arrays stacked on axis 0."""
    if isinstance(layers[0], dict):
        return {k: _stack([t[k] for t in layers]) for k in layers[0]}
    return np.stack(layers)


def _index(tree, i: int):
    """Layer i of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def specs_to_reference(cfg: ModelConfig, specs: Dict[str, Any]) -> Dict[str, Any]:
    """The port's per-layer logical specs (``Model.param_logical_specs``)
    in the reference's layout: each layer stack's axes (every layer of a
    stack has the same) with the stacked ``"layers"`` axis prepended."""
    stacks = Model(cfg).stack_sizes()

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("layers",) + tuple(tree)

    return {k: stacked(v[0]) if k in stacks else v for k, v in specs.items()}


def params_to(params, device):
    """A copy of a parameter tree (dicts and lists of tensors) on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)
