"""The ``dense`` family's trunk: pre-norm layers of grouped-query causal
attention with RoPE, then the gated MLP, each with its residual."""
from __future__ import annotations

from typing import List

import torch

from .layers import act, causal_attention, in_rows, matmul, rms_norm, rope, to_f32

__all__ = ["trunk", "attn_block"]


def attn_block(p, hs: List[torch.Tensor], c: dict, precision: str) -> List[torch.Tensor]:
    """Pre-norm attention then the gated MLP, with residuals, over each
    sequence's hidden states (S, d)."""
    d, H, KV, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    eps = c["norm_eps"]
    w_qkv = torch.cat([p["attn"]["w_q"].reshape(d, H * hd), p["attn"]["w_k"].reshape(d, KV * hd),
                       p["attn"]["w_v"].reshape(d, KV * hd)], dim=1)
    w_o = p["attn"]["w_o"].reshape(H * hd, d)
    lens = [h.shape[0] for h in hs]
    qkv = in_rows(lambda x: matmul(rms_norm(x, p["ln1"]["scale"], eps), w_qkv, precision),
                  torch.cat(hs))
    ys = []
    for part in torch.split(qkv, lens):
        q, k, v = torch.split(part, [H * hd, KV * hd, KV * hd], dim=-1)
        S = part.shape[0]
        q = rope(q.reshape(S, H, hd), c["rope_theta"])
        k = rope(k.reshape(S, KV, hd), c["rope_theta"])
        ys.append(causal_attention(q, k, v.reshape(S, KV, hd)).reshape(S, H * hd))
    del qkv
    h = torch.cat(hs) + in_rows(lambda y: matmul(y, w_o, precision), torch.cat(ys))
    del ys
    mlp = p["mlp"]

    def ffn(x):
        x = rms_norm(x, p["ln2"]["scale"], eps)
        g = act(c["activation"], matmul(x, mlp["w_gate"], precision))
        return matmul(g * matmul(x, mlp["w_up"], precision), mlp["w_down"], precision)

    h = h + in_rows(ffn, h)
    return list(torch.split(h, lens))


def trunk(c: dict, weights, hs: List[torch.Tensor], precision: str) -> List[torch.Tensor]:
    """Every layer over each sequence's embedded states (S, d) in float32."""
    if not c.get("gated_mlp", True):
        raise ValueError("the reference computes the gated MLP only")
    for lp in weights["layers"]:
        hs = attn_block(to_f32(lp), hs, c, precision)
    return hs
