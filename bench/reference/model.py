"""The reference model: logits of whole sequences, layer by layer.

``logits_at(c, weights, seqs, at)`` runs configuration ``c`` (a
configuration file's dict) over each token sequence of ``seqs`` from its
first token, as one teacher-forced forward with no cache, and returns the
float32 logits at the positions ``at`` of each.  What a served token was
decoded from (a prefill, then decode steps through the cache) has to agree
with this forward.

The weights are read where the benchmark made them (any dtype) and taken
to float32 one layer at a time; the hidden states of all sequences go
through a layer before the next is read, per-token products in blocks of
rows, so that the whole fits beside the weights.  TF32 is switched off for
the call.

Families: ``dense`` (pre-norm GQA decoder: attention, then the gated MLP)
and ``ssm`` (pre-norm Mamba-2 blocks, arXiv:2405.21060).  With tied
embeddings the unembedding is the embedding's transpose.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

from .layers import act, causal_attention, mamba_mixer, matmul, rms_norm, rope

__all__ = ["logits_at"]

#: rows of one per-token product
ROWS = 16384


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


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _rows(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of x (n, d) in blocks of :data:`ROWS` rows."""
    if x.shape[0] <= ROWS:
        return fn(x)
    return torch.cat([fn(x[i:i + ROWS]) for i in range(0, x.shape[0], ROWS)])


def _attn_block(p, hs: List[torch.Tensor], c: dict, precision: str) -> List[torch.Tensor]:
    """Pre-norm attention then the gated MLP, with residuals, over each
    sequence's hidden states (S, d)."""
    d, H, KV, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    eps = c["norm_eps"]
    w_qkv = torch.cat([p["attn"]["w_q"].reshape(d, H * hd), p["attn"]["w_k"].reshape(d, KV * hd),
                       p["attn"]["w_v"].reshape(d, KV * hd)], dim=1)
    w_o = p["attn"]["w_o"].reshape(H * hd, d)
    lens = [h.shape[0] for h in hs]
    qkv = _rows(lambda x: matmul(rms_norm(x, p["ln1"]["scale"], eps), w_qkv, precision),
                torch.cat(hs))
    ys = []
    for part in torch.split(qkv, lens):
        q, k, v = torch.split(part, [H * hd, KV * hd, KV * hd], dim=-1)
        S = part.shape[0]
        q = rope(q.reshape(S, H, hd), c["rope_theta"])
        k = rope(k.reshape(S, KV, hd), c["rope_theta"])
        ys.append(causal_attention(q, k, v.reshape(S, KV, hd)).reshape(S, H * hd))
    del qkv
    h = torch.cat(hs) + _rows(lambda y: matmul(y, w_o, precision), torch.cat(ys))
    del ys
    mlp = p["mlp"]

    def ffn(x):
        x = rms_norm(x, p["ln2"]["scale"], eps)
        g = act(c["activation"], matmul(x, mlp["w_gate"], precision))
        return matmul(g * matmul(x, mlp["w_up"], precision), mlp["w_down"], precision)

    h = h + _rows(ffn, h)
    return list(torch.split(h, lens))


def logits_at(c: dict, weights: Dict, seqs: Sequence[torch.Tensor],
              at: Sequence[torch.Tensor], precision: str = "f32") -> List[torch.Tensor]:
    """Float32 logits (len(at[j]), V) at positions ``at[j]`` of sequence
    ``seqs[j]`` (1-D token ids), each sequence from its first token."""
    if c["family"] not in ("dense", "ssm"):
        raise ValueError(f"the reference has no family {c['family']!r}")
    if not (c.get("gated_mlp", True) and c.get("norm", "rmsnorm") == "rmsnorm"):
        raise ValueError("the reference computes the gated MLP and RMSNorm only")
    with torch.no_grad(), _full_f32():
        hs = [weights["embed"][s.long()].float() for s in seqs]
        for i, lp in enumerate(weights["layers"]):
            if c["family"] == "dense":
                hs = _attn_block(_f32(lp), hs, c, precision)
                continue
            p = _f32(lp)
            hs = [h + mamba_mixer(p["mamba"], rms_norm(h, p["ln"]["scale"], c["norm_eps"]), c,
                                  precision) for h in hs]
        head = (weights["embed"].float().T if c["tie_embeddings"]
                else weights["lm_head"].float())
        scale = weights["ln_f"]["scale"].float()
        return [matmul(rms_norm(h[pos.long()], scale, c["norm_eps"]), head, precision)
                for h, pos in zip(hs, at)]
