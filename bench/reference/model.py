"""The reference model: logits of whole sequences, layer by layer.

``logits_at(c, weights, seqs, at, trunk=...)`` runs configuration ``c`` (a
configuration file's dict) over each token sequence of ``seqs`` from its
first token, as one teacher-forced forward with no cache, and returns the
float32 logits at the positions ``at`` of each.  What a served token was
decoded from (a prefill, then decode steps through the cache) has to agree
with this forward.

The embedding lookup, the final RMSNorm and the unembedding are here (with
tied embeddings the unembedding is the embedding's transpose); the layers
between are the family's ``trunk`` (``bench/reference/<family>.py``, which
the harness finds by the configuration's ``family``).  The weights are read
where the benchmark made them (any dtype) and taken to float32 one layer at
a time; the hidden states of all sequences go through a layer before the
next is read, per-token products in blocks of rows, so that the whole fits
beside the weights.  TF32 is switched off for the call.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import torch

from .layers import matmul, rms_norm

__all__ = ["logits_at"]


@contextlib.contextmanager
def _full_f32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def logits_at(c: dict, weights: Dict, seqs: Sequence[torch.Tensor],
              at: Sequence[torch.Tensor], precision: str = "f32", *,
              trunk: Callable) -> List[torch.Tensor]:
    """Float32 logits (len(at[j]), V) at positions ``at[j]`` of sequence
    ``seqs[j]`` (1-D token ids), each sequence from its first token, through
    the family's ``trunk(c, weights, hs, precision)``."""
    if c.get("norm", "rmsnorm") != "rmsnorm":
        raise ValueError("the reference computes RMSNorm only")
    with torch.no_grad(), _full_f32():
        hs = trunk(c, weights, [weights["embed"][s.long()].float() for s in seqs], precision)
        head = (weights["embed"].float().T if c["tie_embeddings"]
                else weights["lm_head"].float())
        scale = weights["ln_f"]["scale"].float()
        return [matmul(rms_norm(h[pos.long()], scale, c["norm_eps"]), head, precision)
                for h, pos in zip(hs, at)]
