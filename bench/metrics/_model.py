"""Model FLOPs of the served work, from the configuration's sizes.

Per prompt token, 2 FLOPs for every weight of a matrix product it passes;
the unembedding at
the one position each prefill and decode step reads logits at; causal
attention as its causal half, 4 hd FLOPs for each (query, key) pair a head
scores (the scores and the weighted sum); for the Mamba-2 family (``ssm``),
the chunked SSD products of each block (``ssd_flops``) and in decode its
state update and read-out.  Norms, activations and other elementwise work count
nothing."""
from __future__ import annotations


def attention_sites(c: dict) -> int:
    return c["num_layers"] if c["family"] == "dense" else 0


def _attn_block_weights(c: dict) -> int:
    d, H, KV, hd, f = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f


def _ssm_dims(c: dict):
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_headdim"], c["ssm_headdim"], c["ssm_ngroups"], c["ssm_state"]


def matmul_weights(c: dict) -> int:
    """Weights of the products one token passes, the unembedding left out."""
    if c["family"] == "dense":
        return c["num_layers"] * _attn_block_weights(c)
    di, H, P, G, N = _ssm_dims(c)
    return c["num_layers"] * (c["d_model"] * (2 * di + 2 * G * N + H) + di * c["d_model"])


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
    d, V = c["d_model"], c["vocab_size"]
    w = matmul_weights(c)
    sites = attention_sites(c)
    pair = 4 * c["head_dim"] * c["num_heads"] if sites else 0  # a (query, key) pair, all heads
    mamba = c["family"] == "ssm"
    f = B * S * 2 * w + B * 2 * d * V + sites * B * pair * (S * (S + 1) // 2)
    if mamba:
        f += c["num_layers"] * B * ssd_flops(c, S)
    for j in range(1, new):
        f += B * (2 * w + 2 * d * V) + sites * B * pair * (S + j)
        if mamba:
            _, Hs, P, _, N = _ssm_dims(c)
            f += c["num_layers"] * B * 4 * Hs * N * P
    return f


def window_flops(run) -> int:
    return sum(batch_flops(run.cfg, b.batch, b.length, b.new) for b in run.batches)
