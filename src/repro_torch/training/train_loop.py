"""The loss, and the train and eval steps.

The port of ``repro/training/train_loop.py``.  The reference differentiates
with ``jax.value_and_grad`` and trains on the plain route
(``ModelConfig.use_pallas`` defaults to False: no Pallas kernel in its
train step, and none has a backward).  The port takes the gradient with
``torch.autograd`` over the parameter leaves, and the loss asks for the
plain route itself (``kernels.common.model_backend("torch")``), around the
forward and the backward both, since a checkpointed block (``cfg.remat``)
runs its forward again inside the backward.  The eval step runs under
``torch.no_grad()`` and takes the kernels on the card.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..kernels.common import model_backend
from ..models.model import Model
from ..sharding import shard
from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_unflatten,
)

__all__ = [
    "TrainState", "cross_entropy", "make_loss_fn", "make_train_step", "make_eval_step",
    "init_state",
]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean next-token CE in nats.  logits: (B, S, V) f32, labels: (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    # a vocab-sharded DTensor (the sharded train step) is gathered on the
    # vocab first: the gold logit is one entry of each row
    gold = torch.gather(shard(logits, "batch", None, None), -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _loss(model: Model, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = model.forward(params, batch)
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    loss = ce + model.cfg.router_aux_weight * aux.get("router_aux", 0.0)
    return loss, {"ce": ce, **aux}


def make_loss_fn(model: Model):
    """``loss_fn(params, batch) -> (loss, {"ce", **aux})`` on the plain route."""
    def loss_fn(params, batch):
        with model_backend("torch"):
            return _loss(model, params, batch)

    return loss_fn


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """``train_step(state, batch) -> (new_state, metrics)``: the loss and its
    gradient over every parameter leaf, then :func:`adamw_update`.  The
    metrics are 0-d tensors: ``loss``, ``ce``, ``router_aux``,
    ``grad_norm``, ``lr``."""
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with model_backend("torch"):  # the forward and, for cfg.remat, its rerun
            loss, aux = _loss(model, params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as jax.grad's
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        new_params, new_opt, om = adamw_update(
            tree_unflatten(state.params, grads), state.opt,
            tree_unflatten(state.params, [p.detach() for p in leaves]), opt_cfg,
        )
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}, **om}
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_eval_step(model: Model):
    """``eval_step(params, batch) -> {"loss", "ce", **aux}`` under
    ``torch.no_grad()``, on the route the device gives (the kernels on the
    card)."""
    @torch.no_grad()
    def eval_step(params, batch):
        loss, aux = _loss(model, params, batch)
        return {"loss": loss, **aux}

    return eval_step


def init_state(model: Model, key: Union[int, torch.Generator] = 0, *,
               device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """Fresh parameters (:meth:`Model.init` from ``key``, on ``device``:
    the card unless ``"cpu"`` is asked for) and their AdamW state."""
    params = model.init(key, device=device)
    return TrainState(params, adamw_init(params))
