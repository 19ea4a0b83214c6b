"""Continuous batching: a fixed pool of decode slots in lock-step.

The port's counterpart of ``repro/serving/continuous.py``, method for
method.  New requests are prefilled one at a time and *admitted* into free
slots without stopping the running batch; finished sequences vacate their
slot.  The reference ``vmap``s its batch-1 decode step over a slot-major
cache; the port keeps the model's own cache layout instead, with the slots
as its batch axis ((sites, n_slots, W, KV, hd) rings, conv and SSM states
per slot) and a (n_slots,) index on the device, and serves every slot with
**one** :meth:`Model.decode_step` a step (each row at its own position:
``models/model.py``).  Empty and vacated slots keep decoding their stale
rows, as the reference's do; their tokens are ignored.

The model's caches are written in place, so :meth:`ContinuousBatcher.admit`
prefills a batch-1 cache of its own and copies each leaf into the slot.
``admit`` and ``step`` run under ``torch.no_grad()`` (the hand kernels
refuse inputs that require a gradient), and on one stream (the decode
kernel's split-K counters, ``kernels/decode_attention.py``).  A step reads
the next tokens back to the host once; nothing else in it syncs.

This composes with GUS as the paper intends: the scheduler assigns
(request -> server, variant); each server runs one ContinuousBatcher per
hosted variant and admits its assigned requests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.instance import resolve_device
from ..models.model import DecodeCache, Model

__all__ = ["ContinuousBatcher", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _slot_tensors(cache: DecodeCache) -> List[torch.Tensor]:
    """Every tensor of the cache, each with the slots on its axis 1, in
    the same order for any two caches of one model."""
    out = [t for group in (cache.attn, cache.cross) if group for t in group.values()]
    return out + [t for t in (cache.conv, cache.ssm) if t is not None]


class ContinuousBatcher:
    """Fixed-slot continuous batching around a Model whose parameters lie
    on ``device`` (default: the CUDA device; raises without one)."""

    def __init__(self, model: Model, params, n_slots: int = 4, max_len: int = 256, *,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"the parameters are on {params['embed'].device}, the batcher on {self.device}"
            )
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self._cache = model.init_cache(n_slots, max_len, device=self.device)
        self.reset()

    def reset(self):
        """Clear all slots (the cache's tensors are kept and zeroed)."""
        self.requests: List[Optional[Request]] = [None] * self.n_slots
        self._last_tok = torch.zeros((self.n_slots, 1), dtype=torch.int32, device=self.device)
        for t in _slot_tensors(self._cache):
            t.zero_()
        self._cache.index = torch.zeros(self.n_slots, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------------ admin
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    def active(self) -> List[Request]:
        return [r for r in self.requests if r is not None]

    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        free = self.free_slots()
        if not free:
            return False
        slot = free[0]
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                 device=self.device)[None, :]
        cache1 = self.model.init_cache(1, self.max_len, device=self.device)
        logits, cache1 = self.model.prefill(self.params, {"tokens": tokens}, cache1)
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        req.generated.append(int(tok[0]))

        for t, one in zip(_slot_tensors(self._cache), _slot_tensors(cache1)):
            t[:, slot] = one[:, 0]
        self._cache.index[slot] = cache1.index
        self._last_tok[slot] = tok
        self.requests[slot] = req
        return True

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self):
        """One lock-step decode across all slots (one ``decode_step``)."""
        if not self.active():
            return
        logits, self._cache = self.model.decode_step(self.params, self._last_tok, self._cache)
        self._last_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        nxt = self._last_tok[:, 0].tolist()  # the step's one read back to the host
        for i, r in enumerate(self.requests):
            if r is None or r.done:
                continue
            r.generated.append(nxt[i])
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
                self.requests[i] = None  # vacate; the slot's cache is reusable

    # ------------------------------------------------------------------ drive
    def run(self, incoming: List[Request], max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Serve a queue to completion; admits whenever slots free up."""
        queue = list(incoming)
        out: Dict[int, List[int]] = {}
        steps = 0
        pending = {r.rid: r for r in queue}
        while (queue or self.active()) and steps < max_steps:
            while queue and self.free_slots():
                self.admit(queue.pop(0))
            self.step()
            steps += 1
            for rid, r in list(pending.items()):
                if r.done:
                    out[rid] = r.generated
                    del pending[rid]
        # collect any still-active at step limit
        for r in self.active():
            out.setdefault(r.rid, r.generated)
        return out
