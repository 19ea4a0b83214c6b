"""Whether what the timed path served is right: served tokens against the
plain reference.

Once the window has closed, a sample of the requests it finished is drawn
from the seed, with one prompt of each length in it, the longest among
them (``sample_requests``).  The reference runs once over each sampled
prompt followed by its served tokens, and for every served token reads the
gap by which the reference's logit of that token lies below the
reference's best logit at that position.  The number compared is the
widest gap over the sample; greedy tokens served by a correct program in
bf16 lie within rounding of the reference's best.

The control puts the reference computed in float8 e4m3 in the program's
place: at the same positions of the same sequences, the gap of the token
that the float8 logits put first.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .seeds import numpy_rng

__all__ = ["sample_requests", "compared_sequences", "widest_gaps"]


def sample_requests(batches, n: int, seed: int, rest: str = "any") -> List[Tuple[int, int]]:
    """``n`` (batch position, row) pairs of the finished batches, drawn
    from the seed: first one row of a batch of each prompt length, the
    longest first; then rows drawn without repeats from the batches of the
    shortest length (``rest="shortest"``, where the reference's cost has to
    stay beside the window) or from all batches (``rest="any"``)."""
    if rest not in ("any", "shortest"):
        raise ValueError(f"unknown sample rule {rest!r}")
    rng = numpy_rng(seed, "sample")
    pool = [(i, r) for i, b in enumerate(batches) for r in range(b.batch)]
    picks = []
    for length in sorted({b.length for b in batches}, reverse=True)[:n]:
        of = [p for p in pool if batches[p[0]].length == length]
        picks.append(of[int(rng.integers(len(of)))])
    shortest = min(b.length for b in batches)
    left = [p for p in pool if p not in picks
            and (rest == "any" or batches[p[0]].length == shortest)]
    more = rng.choice(len(left), size=min(n - len(picks), len(left)), replace=False)
    return picks + [left[int(j)] for j in sorted(more)]


def compared_sequences(batches, picks, traffic, device):
    """(sequences, positions, served tokens) of the sampled requests: each
    prompt followed by its served tokens but the last, the positions whose
    next token was served, and those tokens."""
    seqs, at, served = [], [], []
    for i, r in picks:
        b = batches[i]
        prompt = traffic.tokens(b.index, device)[r].long()
        tok = torch.as_tensor(np.asarray(b.tokens[r]), device=device).long()
        seqs.append(torch.cat([prompt, tok[:-1]]))
        at.append(torch.arange(b.length - 1, b.length - 1 + len(tok), device=device))
        served.append(tok)
    return seqs, at, served


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return ref.max(-1).values - ref.gather(-1, tokens[:, None]).squeeze(-1)


def widest_gaps(reference: Sequence[torch.Tensor], served: Sequence[torch.Tensor],
                control: Sequence[torch.Tensor] = None) -> Tuple[float, float, int]:
    """(widest gap of the served tokens, widest gap of the control's first
    tokens or nan, tokens compared) against the reference's logits."""
    got = max(float(_gaps(r, t).max()) for r, t in zip(reference, served))
    ctl = float("nan")
    if control is not None:
        ctl = max(float(_gaps(r, c.argmax(-1)).max()) for r, c in zip(reference, control))
    return got, ctl, sum(len(t) for t in served)
