"""The one traffic generator: a closed loop of batches, read from a mix's file.

A mix (``bench/traffic/<name>.json``) gives:

  batch         prompts a batch (one caller sends batches back to back)
  lengths       the prompt lengths, in tokens
  per_cycle     how many batches of each length one cycle holds
  new_tokens    greedy tokens generated for each prompt
  trace_seconds the traced window of a ``--trace 1`` run, at most the run's

Every seed gets the same multiset of lengths in each cycle, in an order of
its own, so that seeds change the order of the work and not its amount.
Token ids are uniform over the configuration's vocabulary, drawn on the
device, batch by batch, from streams of the seed.
"""
from __future__ import annotations

from typing import List

import torch

from .seeds import derive, numpy_rng

__all__ = ["Traffic"]


class Traffic:
    def __init__(self, params: dict, seed: int, vocab: int, context: int):
        self.batch = int(params["batch"])
        self.lengths = [int(s) for s in params["lengths"]]
        self.per_cycle = [int(n) for n in params["per_cycle"]]
        self.new_tokens = int(params["new_tokens"])
        self.trace_seconds = float(params["trace_seconds"])
        self.seed, self.vocab = seed, vocab
        if len(self.lengths) != len(self.per_cycle) or min(self.per_cycle) < 1:
            raise ValueError("a mix gives one positive count a cycle for each length")
        if max(self.lengths) + self.new_tokens > context:
            raise ValueError(f"prompts of {max(self.lengths)} tokens and {self.new_tokens} new "
                             f"exceed the context of {context}")
        self.cycle = [s for s, n in zip(self.lengths, self.per_cycle) for _ in range(n)]
        self._order: List[int] = []
        self._gen = None

    def length(self, i: int) -> int:
        """The prompt length of batch ``i``."""
        while len(self._order) <= i:
            c = len(self._order) // len(self.cycle)
            perm = numpy_rng(self.seed, "order", c).permutation(len(self.cycle))
            self._order += [self.cycle[j] for j in perm]
        return self._order[i]

    def tokens(self, i: int, device) -> torch.Tensor:
        """Batch ``i``'s prompts, (batch, length(i)) int32 on ``device``;
        the same ids for the same seed and ``i`` every time they are asked
        for."""
        device = torch.device(device)
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
        self._gen.manual_seed(derive(self.seed, "tokens", i))
        return torch.randint(0, self.vocab, (self.batch, self.length(i)), generator=self._gen,
                             device=device, dtype=torch.int64).to(torch.int32)

    def warmup_tokens(self, length: int, device) -> torch.Tensor:
        """A batch of ``length``-token prompts from a stream of its own,
        for the warm-up of that shape."""
        g = torch.Generator(device=torch.device(device)).manual_seed(
            derive(self.seed, "warmup", length))
        return torch.randint(0, self.vocab, (self.batch, length), generator=g, device=device,
                             dtype=torch.int64).to(torch.int32)
