"""Beyond-paper extensions to the scheduling core — the port of
``repro.core.extensions``.

1. :func:`gus_schedule_ordered` — GUS processing requests by *descending
   best-achievable US* instead of arrival order, with optional per-request
   ``priority`` weights that scale each request's US (the paper's
   future-work item).  The reference's loop body is ``_gus_body`` line for
   line, so the port sorts the rows, runs the GUS kernel on the permuted
   frame and scatters the assignments back: the same greedy, exactly.
2. :func:`apply_mobility` — memoryless user mobility between frames (numpy,
   used by the simulators).

The scheduler takes a frame ``(N, M, L)`` or a batch of frames
``(B, N, M, L)`` and returns an Assignment of the same rank.  It runs on
``device`` (``None`` means the card, as every entry point; the policies pass
their batch's own device).
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from repro_torch.kernels.gus import NEG

from .gus import Assignment, gus_schedule_batch
from .instance import FlatInstance, resolve_device
from .satisfaction import hard_feasible, us_tensor

__all__ = ["gus_schedule_ordered", "best_us_per_request", "apply_mobility"]

#: the leaves with a request axis (the rest are per server or per frame)
ROW_FIELDS = ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")


def best_us_per_request(inst: FlatInstance) -> torch.Tensor:
    """``(..., N)`` best achievable US per request ignoring capacity (an
    upper bound); ``NEG`` where no candidate is feasible."""
    return torch.where(hard_feasible(inst), us_tensor(inst), NEG).amax(dim=(-2, -1))


def as_batch(inst: FlatInstance):
    """``(batch, unbatched)``: a frame with a leading batch axis of one
    added, or a batch as it is."""
    if inst.A.dim() > 1:
        return inst, False
    return FlatInstance(**{f.name: getattr(inst, f.name)[None]
                           for f in dataclasses.fields(inst)}), True


def gus_schedule_ordered(inst: FlatInstance, priority=None, *, device=None) -> Assignment:
    """GUS with requests processed in descending (priority ·) best-US order.

    Same greedy inner rule as Algorithm 1; only the processing order
    differs.  The order is a *stable* ascending sort of ``-best`` (the
    reference's ``jnp.argsort``): rows of equal best US, and every padding
    row (best ``NEG``), keep their index order.  ``priority`` (``(N,)`` or
    ``(B, N)``) multiplies each request's utility once, after it is formed,
    in the ordering and in the greedy's argmax alike.  Returns assignments
    in the ORIGINAL request order; ``loads`` is ``None`` (the kernel's
    per-server sums run in processing order, not request order).
    """
    dev = resolve_device(device)
    batch, unbatched = as_batch(inst.to(dev))
    B, N = batch.A.shape
    prio = None
    us = us_tensor(batch)
    if priority is not None:
        prio = torch.as_tensor(priority, dtype=torch.float32, device=dev).expand(B, N)
        us = us * prio[..., None, None]
    best = torch.where(hard_feasible(batch), us, NEG).amax(dim=(-2, -1))
    order = torch.argsort(-best, dim=-1, stable=True)
    rows = torch.arange(B, device=dev)[:, None]
    perm = dataclasses.replace(batch, **{f: getattr(batch, f)[rows, order] for f in ROW_FIELDS})
    a = gus_schedule_batch(perm, prio=None if prio is None else prio[rows, order], device=dev)
    j = torch.empty_like(a.j).scatter_(1, order, a.j)
    l = torch.empty_like(a.l).scatter_(1, order, a.l)
    if unbatched:
        return Assignment(j[0], l[0])
    return Assignment(j, l)


def apply_mobility(cover: np.ndarray, n_edge: int, move_prob: float, rng) -> np.ndarray:
    """Memoryless user mobility: each user re-attaches to a random edge with
    probability ``move_prob`` (numpy; used by the simulators between frames)."""
    move = rng.random(cover.shape[0]) < move_prob
    new = rng.integers(0, n_edge, size=cover.shape[0]).astype(cover.dtype)
    return np.where(move, new, cover)
