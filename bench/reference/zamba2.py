"""The ``zamba2`` family's trunk: Zamba2's Mamba-2 layers and shared
transformer blocks (arXiv:2411.15242), as transformers 4.57's
``models/zamba2/modeling_zamba2.py`` writes them.

Layer i is a Mamba-2 block with its pre-norm and residual.  Where i is the
j-th of ``hybrid_layer_ids`` (a hybrid layer), the shared block
``j mod num_mem_blocks`` runs first over ``concat([h, embedding])``:
RMSNorm over the 2 d_model wide input, causal attention of
``num_attention_heads`` heads of ``attention_head_dim`` with RoPE over the
whole head and the softmax scale ``(head_dim / 2) ** -0.5``, the output
projection, RMSNorm, and the gated MLP ``gelu(gate) * up`` (exact-erf
GELU) whose gate/up product gains site j's adapter (``lora_a`` then
``lora_b``); no residual inside the block.  Site j's linear takes the
block's output, which is added to the Mamba-2 block's input before its
norm; the residual adds the block's output to h as it was.  The Mamba-2
block is ``Zamba2MambaMixer``'s: the input projection to z, x, B, C, dt;
the depthwise causal conv with bias and SiLU; the scan plus D x; the gated
RMSNorm of y * SiLU(z) taken per group (``Zamba2RMSNormGated``, group size
d_inner / ngroups); the output projection.

Departures from ``modeling_zamba2.py``:

- dt = softplus(dt + dt_bias) is not clamped below at ``time_step_min``:
  the published config's ``time_step_limit`` is null, so the model's CUDA
  path (the ``mamba_ssm`` kernels, ``dt_limit`` (0, inf)) takes dt as it
  is; the file's pure-PyTorch fallback alone clamps it;
- the scan is ``layers.ssd``, exact in its chunked dual form (chunks of
  64; the published ``chunk_size`` is 256: the same scan blocked
  otherwise), from a zero state;
- attention is ``layers.causal_attention`` (scores over sqrt(head_dim))
  with q taken times sqrt(2), which gives the published scale; softmax and
  P.V in float32 where the published eager path casts the weights to q's
  dtype (float32 here too);
- the weights are the program's layout (q, k, v (2 d, H, hd), o (H, hd,
  d), the gate and up products apart, each matrix as input x output), and
  the whole computation is in float32 (``precision="fp8"`` rounds both
  operands of every weight product, as ``layers.matmul`` does).
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from .layers import (causal_attention, in_rows, matmul, rms_norm, rope, softplus, ssd,
                     to_f32)

__all__ = ["trunk", "shared_block", "mixer"]


def shared_block(p, s, hs: List[torch.Tensor], es: List[torch.Tensor], c: dict,
                 precision: str) -> List[torch.Tensor]:
    """Shared block ``p`` at a site with adapter and linear ``s``, over each
    sequence's hidden states (S, d) and embedded tokens (S, d): what the
    site adds to its layer's Mamba-2 input."""
    d, H, KV, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    eps = c["norm_eps"]
    din = 2 * d
    attn = p["attn"]
    w_qkv = torch.cat([attn["w_q"].reshape(din, H * hd), attn["w_k"].reshape(din, KV * hd),
                       attn["w_v"].reshape(din, KV * hd)], dim=1)
    w_o = attn["w_o"].reshape(H * hd, d)
    lens = [h.shape[0] for h in hs]
    qkv = in_rows(lambda x: matmul(rms_norm(x, p["ln1"]["scale"], eps), w_qkv, precision),
                  torch.cat([torch.cat(hs), torch.cat(es)], dim=-1))
    ys = []
    for part in torch.split(qkv, lens):
        q, k, v = torch.split(part, [H * hd, KV * hd, KV * hd], dim=-1)
        S = part.shape[0]
        q = rope(q.reshape(S, H, hd), c["rope_theta"]) * math.sqrt(2.0)
        k = rope(k.reshape(S, KV, hd), c["rope_theta"])
        ys.append(causal_attention(q, k, v.reshape(S, KV, hd)).reshape(S, H * hd))
    del qkv
    a = in_rows(lambda y: matmul(y, w_o, precision), torch.cat(ys))
    del ys
    mlp = p["mlp"]

    def ffn(x):
        x = rms_norm(x, p["ln2"]["scale"], eps)
        gate = matmul(x, mlp["w_gate"], precision)
        up = matmul(x, mlp["w_up"], precision)
        lo_g, lo_u = matmul(matmul(x, s["lora_a"], precision), s["lora_b"], precision).chunk(2, -1)
        y = matmul(F.gelu(gate + lo_g) * (up + lo_u), mlp["w_down"], precision)
        return matmul(y, s["linear"], precision)

    return list(torch.split(in_rows(ffn, a), lens))


def mixer(p, x: torch.Tensor, c: dict, precision: str) -> torch.Tensor:
    """``Zamba2MambaMixer`` of x (S, d) (its input already normed)."""
    S, d = x.shape
    di = c["ssm_expand"] * d
    P, G, N = c["ssm_headdim"], c["ssm_ngroups"], c["ssm_state"]
    H = di // P
    z, xbc, dt = torch.split(matmul(x, p["in_proj"], precision), [di, di + 2 * G * N, H],
                             dim=-1)
    w = p["conv_w"]                                              # (W, ch)
    xp = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
    xbc = F.silu(p["conv_b"] + sum(xp[i:i + S] * w[i] for i in range(w.shape[0])))
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(S, H, P)
    y = ssd(xs, softplus(dt + p["dt_bias"]), -torch.exp(p["A_log"]), Bm.reshape(S, G, N),
            Cm.reshape(S, G, N))
    y = (y + p["D"][:, None] * xs).reshape(S, di)
    y = rms_norm((y * F.silu(z)).reshape(S, G, di // G), 1.0, c["norm_eps"])
    return matmul(y.reshape(S, di) * p["norm_scale"], p["out_proj"], precision)


def trunk(c: dict, weights, hs: List[torch.Tensor], precision: str) -> List[torch.Tensor]:
    """Every layer over each sequence's embedded states (S, d) in float32,
    the shared blocks at their sites."""
    es = list(hs)
    site = {layer: j for j, layer in enumerate(c["hybrid_layer_ids"])}
    blocks = [to_f32(b) for b in weights["shared_blocks"]]
    eps = c["norm_eps"]
    for i, lp in enumerate(weights["layers"]):
        p = to_f32(lp)
        xs = hs
        if i in site:
            j = site[i]
            ts = shared_block(blocks[j % c["num_mem_blocks"]], to_f32(weights["sites"][j]), hs,
                              es, c, precision)
            xs = [h + t for h, t in zip(hs, ts)]
        hs = [h + mixer(p["mamba"], rms_norm(x, p["ln"]["scale"], eps), c, precision)
              for h, x in zip(hs, xs)]
    return hs
