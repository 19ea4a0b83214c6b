"""The paper's five baseline heuristics (Sec. IV, "Baseline algorithms") —
the port of ``repro.core.baselines``.

All share GUS's feasibility rules (2b/2c + capacities) but differ in *which*
servers they consider:

1. Random-Assignment  — one uniformly-random server per request.
2. Offload-All        — cloud servers only.
3. Local-All          — the covering edge server only.
4. Happy-Computation  — GUS with the computation constraint (2d) relaxed.
5. Happy-Communication— GUS with the communication constraint (2e) relaxed.

The reference's restricted greedy (``_restricted_greedy``) is GUS's loop
body with ``feas & mask[:, :, None]``, and hard feasibility starts from
``avail``, so each of the first three is the GUS kernel on ``avail &
mask[..., None]``: a request masked to nothing has no usable candidate and
drops, as there.  The Happy-* pair is GUS with a relaxed budget.

Each takes a frame ``(N, M, L)`` or a batch ``(B, N, M, L)`` and runs on
``device`` (``None`` means the card).  ``random_assignment`` draws its
servers with ``jax.random.randint``'s exact bits (:mod:`.prng`), one key per
frame.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from . import prng
from .extensions import as_batch
from .gus import Assignment, gus_schedule, gus_schedule_batch
from .instance import FlatInstance, resolve_device

__all__ = [
    "random_assignment",
    "offload_all",
    "local_all",
    "happy_computation",
    "happy_communication",
    "BASELINES",
]


def _restricted(inst: FlatInstance, mask_of, device) -> Assignment:
    """GUS on ``inst`` (a frame or a batch) with ``avail`` restricted to
    ``mask_of(batch)``: ``(B, N, M)`` bool, the servers each request may
    use."""
    dev = resolve_device(device)
    batch, unbatched = as_batch(inst.to(dev))
    run = dataclasses.replace(batch, avail=batch.avail & mask_of(batch)[..., None])
    a = gus_schedule_batch(run, device=dev)
    if unbatched:
        return Assignment(a.j[0], a.l[0], (a.loads[0][0], a.loads[1][0]))
    return a


def random_assignment(inst: FlatInstance, key, *, device=None) -> Assignment:
    """Paper baseline 1: a single random server is drawn per request; serve
    there if feasible, else drop.  ``key`` is a ``(2,)`` uint32 key for a
    frame, or ``(B, 2)`` keys for a batch, one per frame; the servers are
    ``randint(key, (N,), 0, M)``, ``jax.random``'s bits."""
    def mask(batch):
        B, N, M, _ = batch.acc.shape
        picks = prng.randint(np.asarray(key, np.uint32).reshape(B, 2), (N,), 0, M)
        picks = torch.from_numpy(picks.astype(np.int64)).to(batch.device)
        return picks[..., None] == torch.arange(M, device=batch.device)

    return _restricted(inst, mask, device)


def offload_all(inst: FlatInstance, cloud_mask, *, device=None) -> Assignment:
    """Paper baseline 2: every request goes to the cloud tier.

    ``cloud_mask``: (M,) bool marking cloud servers."""
    def mask(batch):
        cm = torch.as_tensor(np.asarray(cloud_mask, bool), device=batch.device)
        return cm.expand(batch.A.shape + cm.shape)

    return _restricted(inst, mask, device)


def local_all(inst: FlatInstance, *, device=None) -> Assignment:
    """Paper baseline 3: only the covering edge server is considered."""
    def mask(batch):
        M = batch.acc.shape[-2]
        return batch.cover[..., None].long() == torch.arange(M, device=batch.device)

    return _restricted(inst, mask, device)


def happy_computation(inst: FlatInstance, *, device=None) -> Assignment:
    """Paper baseline 4: computation constraint (2d) relaxed."""
    return _gus_any(inst, device, relax_compute=True)


def happy_communication(inst: FlatInstance, *, device=None) -> Assignment:
    """Paper baseline 5: communication constraint (2e) relaxed."""
    return _gus_any(inst, device, relax_comm=True)


def _gus_any(inst, device, **relax):
    if inst.A.dim() > 1:
        return gus_schedule_batch(inst, device=device, **relax)
    return gus_schedule(inst, device=device, **relax)


BASELINES = {
    "random": random_assignment,
    "offload_all": offload_all,
    "local_all": local_all,
    "happy_computation": happy_computation,
    "happy_communication": happy_communication,
}
