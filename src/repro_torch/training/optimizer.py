"""AdamW + gradient clipping + the cosine learning-rate schedule.

The port of ``repro/training/optimizer.py``: plain functions on trees of
tensors (nested dicts, lists and tuples) that return new state, as the
reference's.  The moments ``m`` and ``v`` are float32 whatever the
parameter's dtype; each update is computed in float32 and cast back to the
parameter's dtype, in the reference's order of operations.  The gradient
norm sums the leaves in the port's tree order (sorted dict keys, layers in
order), which is not the reference's over stacked layers, so it agrees to
float32 summation order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
    "global_norm", "tree_leaves", "tree_map", "tree_unflatten",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32, 0-d
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts (sorted keys), lists and tuples, in
    order; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are ``leaves``, in
    :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    return build(tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), keeping the structure."""
    flat = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree), *flat)])


def adamw_init(params) -> AdamWState:
    """Zero float32 moments beside every parameter, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``lr``, then a cosine decay to ``min_lr_ratio *
    lr`` at ``total_steps``; float32, as the reference's."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
        )
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)

    return sched


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(
    grads, state: AdamWState, params, cfg: AdamWConfig
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step.  Returns ``(new_params, new_state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}``; nothing is updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg)(step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    new = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v)))]
    new_p, new_m, new_v = (tree_unflatten(params, [u[i] for u in new]) for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
