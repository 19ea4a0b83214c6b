"""Sharded steps: train / prefill / serve, with the inputs' and
outputs' DTensor placements resolved from the logical-axis rules of
``repro_torch.sharding``.

The port's counterpart of ``repro/launch/steps.py``.  Where the reference
``jax.jit``s a step with ``in_shardings``/``out_shardings``, the port runs
its existing step (``training.make_train_step``,
``serving.make_prefill_step``/``make_serve_step``) eagerly on DTensors
under ``use_sharding``: every rank of the mesh's process group calls the
step on its DTensors, the model's ``shard(...)`` sites lay the activations
out, DTensor inserts the collectives, and the attention and SSD kernels
run on each rank's local shards (``kernels/ops.py``).  The outputs are
redistributed to the reference's ``out_shardings`` before they are
returned; the cache is updated in place, as on one device.

Rule profiles (the reference's):
  * TRAIN_RULES — 2-D weight sharding: the model-parallel dimension on
    ``model``, the complementary one on ``data`` (FSDP-style; the AdamW
    moments take the same layout).
  * SERVE_RULES — tensor-parallel weights on ``model``, replicated across
    ``data``: decode must not gather weights every token.

The train step keeps the plain route (``kernels.common.model_backend``),
as on one device.  Each ``build_*`` returns ``(fn, abstract_args)``: the step
and its arguments as ``meta`` tensors (``launch/specs.py``);
:func:`distribute` lays out real arguments by the ``*_shardings``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..models.model import DecodeCache, Model
from ..serving.engine import make_prefill_step, make_serve_step
from ..sharding import DEFAULT_RULES, placements_for, use_sharding
from ..training.optimizer import AdamWConfig, AdamWState
from ..training.train_loop import TrainState, make_train_step
from .specs import ShapeSpec, abstract_cache, abstract_state, decode_tokens_spec, input_specs

__all__ = [
    "TRAIN_RULES",
    "SERVE_RULES",
    "params_shardings",
    "state_shardings",
    "batch_shardings",
    "cache_shardings",
    "build_train_step",
    "build_prefill_step",
    "build_serve_step",
    "distribute",
]

TRAIN_RULES = dict(DEFAULT_RULES, embed="data", d_inner_in=None)
SERVE_RULES = dict(DEFAULT_RULES)


def _rep(mesh):
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def _zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over a tree of dicts, lists and tuples (a
    tuple of ``other`` is a leaf: the logical axes)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def params_shardings(model: Model, mesh, rules) -> Any:
    """The placements of every parameter, in the parameters' layout."""
    return _zip_map(lambda p, lg: placements_for(p.shape, lg, mesh, rules),
                    model.abstract_params(), model.param_logical_specs())


def state_shardings(model: Model, mesh, rules) -> TrainState:
    """A ``TrainState`` of placements: the moments laid out as the
    parameters, the step replicated."""
    ps = params_shardings(model, mesh, rules)
    return TrainState(params=ps, opt=AdamWState(step=_rep(mesh), m=ps, v=ps))


def batch_shardings(cfg: ModelConfig, specs: Dict[str, Any], mesh, rules) -> Dict[str, Any]:
    """Every batch input on the batch axes by its first dimension."""
    return {k: placements_for(v.shape, ["batch"] + [None] * (v.dim() - 1), mesh, rules)
            for k, v in specs.items()}


def cache_shardings(model: Model, acache: DecodeCache, mesh, rules) -> DecodeCache:
    """A ``DecodeCache`` of placements for the port's cache layout: the
    rings (and the int8 rings' scales) on batch, ``kv_seq`` and
    ``kv_heads``, the mamba states on batch and their channel or head
    axis, the index replicated."""
    def kv(x):
        return placements_for(x.shape, ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                              mesh, rules)

    def each(d):
        return None if d is None else {k: kv(v) for k, v in d.items()}

    return DecodeCache(
        index=_rep(mesh),
        attn=each(acache.attn),
        conv=None if acache.conv is None else placements_for(
            acache.conv.shape, ("layers", "batch", "conv", "d_inner"), mesh, rules),
        ssm=None if acache.ssm is None else placements_for(
            acache.ssm.shape, ("layers", "batch", "ssm_heads", "state", "head_dim"), mesh, rules),
        cross=each(acache.cross),
    )


def distribute(tree, shardings, mesh):
    """Each tensor of ``tree`` (the same global value on every rank) as a
    DTensor laid out by the matching placements of ``shardings`` (a tree of
    the same structure); ``int`` and ``None`` leaves stay as they are."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, (dict, list)) or isinstance(tree, tuple) and hasattr(tree, "_fields") \
            or isinstance(tree, DecodeCache):
        return _structured(tree, shardings, lambda t, s: distribute(t, s, mesh))
    if not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, list(shardings))


def _lay_out(tree, shardings):
    """The DTensors of ``tree`` redistributed to ``shardings`` (the
    reference's ``out_shardings``); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, (dict, list)) or isinstance(tree, tuple) and hasattr(tree, "_fields") \
            or isinstance(tree, DecodeCache):
        return _structured(tree, shardings, _lay_out)
    if not isinstance(tree, DTensor) or tuple(tree.placements) == tuple(shardings):
        return tree
    return tree.redistribute(tree.device_mesh, tuple(shardings))


def _structured(tree, other, fn):
    """``fn`` over the matching children of two trees of one structure."""
    if isinstance(tree, dict):
        return {k: fn(v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fn(v, o) for v, o in zip(tree, other)]
    if isinstance(tree, DecodeCache):
        return DecodeCache(**{f: fn(getattr(tree, f), getattr(other, f))
                              for f in ("index", "attn", "conv", "ssm", "cross")})
    return type(tree)(*(fn(v, o) for v, o in zip(tree, other)))


# ---------------------------------------------------------------------------
# the steps — each build_* returns (fn, example abstract args)
# ---------------------------------------------------------------------------

def build_train_step(
    model: Model,
    mesh,
    shape: ShapeSpec,
    rules: Optional[dict] = None,
    opt_cfg: Optional[AdamWConfig] = None,
):
    """``fn(state, batch) -> (state, metrics)`` on DTensors laid out by
    :func:`state_shardings` and :func:`batch_shardings`; the new state
    comes back in the same layout, the metrics replicated."""
    rules = rules or TRAIN_RULES
    raw = make_train_step(model, opt_cfg or AdamWConfig())
    st_sh = state_shardings(model, mesh, rules)

    def step(state, batch):
        with use_sharding(mesh, rules):
            new, metrics = raw(state, batch)
            return _lay_out(new, st_sh), {k: _lay_out(v, _rep(mesh)) for k, v in metrics.items()}

    return step, (abstract_state(model), input_specs(model.cfg, shape))


def build_prefill_step(model: Model, mesh, shape: ShapeSpec, rules=None):
    """``fn(params, batch, cache) -> (next tokens (B, 1), cache)`` on
    DTensors laid out by the ``*_shardings`` of ``rules`` (default
    :data:`SERVE_RULES`); the cache is filled in place."""
    rules = rules or SERVE_RULES
    raw = make_prefill_step(model)
    tok_sh = placements_for((shape.global_batch, 1), ("batch", None), mesh, rules)

    def step(params, batch, cache):
        with use_sharding(mesh, rules):
            tok, cache = raw(params, batch, cache)
            return _lay_out(tok, tok_sh), cache

    return step, (model.abstract_params(), input_specs(model.cfg, shape),
                  abstract_cache(model, shape))


def build_serve_step(model: Model, mesh, shape: ShapeSpec, rules=None):
    """``fn(params, tokens (B, 1), cache) -> (next tokens (B, 1), cache)``:
    one decode step on DTensors, as :func:`build_prefill_step`."""
    rules = rules or SERVE_RULES
    raw = make_serve_step(model)
    tok_sh = placements_for((shape.global_batch, 1), ("batch", None), mesh, rules)

    def step(params, tokens, cache):
        with use_sharding(mesh, rules):
            tok, cache = raw(params, tokens, cache)
            return _lay_out(tok, tok_sh), cache

    return step, (model.abstract_params(), decode_tokens_spec(shape),
                  abstract_cache(model, shape))
