"""Model FLOPs of the served work, from the configuration's sizes and its
family's counts (``bench/families/<family>.py``).

Per prompt token, 2 FLOPs for every weight of a matrix product it passes
(the family's ``matmul_weights``); the unembedding at the one position each
prefill and decode step reads logits at; causal attention as its causal
half, 4 hd FLOPs for each (query, key) pair a head scores (the scores and
the weighted sum) at each of the family's attention sites; the chunked SSD
products of each of its ``ssd_scan`` blocks (``ssd_flops``) and in decode
their state update and read-out.  Norms, activations and other elementwise
work count nothing."""
from __future__ import annotations

from bench.harness.manifest import family


def attention_sites(c: dict) -> int:
    """The causal-attention launches of one prefill."""
    return family(c).model.attention(c)[0]


def matmul_weights(c: dict) -> int:
    """Weights of the products one token passes, the unembedding left out."""
    return family(c).model.matmul_weights(c)


def _ssm_dims(c: dict):
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_headdim"], c["ssm_headdim"], c["ssm_ngroups"], c["ssm_state"]


def ssd_flops(c: dict, S: int) -> int:
    """The chunked SSD of one sequence of S tokens in one block: per chunk
    of l tokens, C B^T over its causal half for each group, its weighted
    product with x for each head, and y from the carried state plus the
    chunk's own state, 2 N P FLOPs a token and head each."""
    di, H, P, G, N = _ssm_dims(c)
    Q = c["ssd_chunk"]
    total = 0
    for start in range(0, S, Q):
        l = min(Q, S - start)
        total += G * N * l * (l + 1) + H * (P * l * (l + 1) + 4 * N * P * l)
    return total


def batch_flops(c: dict, B: int, S: int, new: int) -> int:
    """A batch of B prompts of S tokens, then ``new`` - 1 decode steps."""
    fam = family(c).model
    d, V = c["d_model"], c["vocab_size"]
    w = fam.matmul_weights(c)
    sites, H, _, hd = fam.attention(c)
    pair = 4 * hd * H  # a (query, key) pair, all heads
    blocks = fam.ssd_blocks(c)
    f = B * S * 2 * w + B * 2 * d * V + sites * B * pair * (S * (S + 1) // 2)
    if blocks:
        f += blocks * B * ssd_flops(c, S)
    for j in range(1, new):
        f += B * (2 * w + 2 * d * V) + sites * B * pair * (S + j)
        if blocks:
            _, Hs, P, _, N = _ssm_dims(c)
            f += blocks * B * 4 * Hs * N * P
    return f


def window_flops(run) -> int:
    return sum(batch_flops(run.cfg, b.batch, b.length, b.new) for b in run.batches)
