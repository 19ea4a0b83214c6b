"""Core layers: declarative params, norms, RoPE, GQA attention, MLP.

The port's counterpart of ``repro/models/layers.py``.  Params are plain
nested dicts of tensors; every parameter is declared once (shape + init
kind) in a decl tree, and :func:`init_leaf` draws it from a
``torch.Generator`` on the target device.  The reference's ``shard(...)``
annotations and logical axes are single-device no-ops here and are dropped.

Attention in causal mode goes through ``kernels.ops.flash_attention`` and
decode through ``kernels.ops.decode_attention``: the Hopper kernels on CUDA
tensors, their plain versions on CPU tensors.  ``mode="cross"`` and
``"bidir"`` (the encoder-decoder family's cross attention and encoder) keep
the plain :func:`_sdpa` math, as the reference never sends them to its
flash kernel.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops

__all__ = [
    "ParamDecl",
    "init_leaf",
    "norm_decl",
    "apply_norm",
    "mlp_decl",
    "apply_mlp",
    "attn_decl",
    "apply_attention",
    "rope",
    "make_positions",
    "ring_valid",
]


# ---------------------------------------------------------------------------
# Declarative params
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    init: str = "fan_in"     # fan_in | zeros | ones | normal | a_log | dt_bias
    scale: float = 1.0


def init_leaf(d: ParamDecl, dtype: torch.dtype, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """One leaf, drawn in f32 on ``device`` and cast to ``dtype`` — the
    distributions of the reference's ``_leaf_init`` (``jax.random`` draws
    cannot be reproduced; parity goes through the weight carry).

    As written there, a fan-in leaf of 3 or more dimensions takes
    ``shape[-2]`` as its fan-in (meant for stacked expert weights), so
    ``w_q`` (d, H, hd) is scaled by 1/sqrt(H), ``w_k``/``w_v`` by
    1/sqrt(KV) and ``w_o`` (H, hd, d) by 1/sqrt(hd).
    """
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init in ("a_log", "dt_bias"):
        u = torch.rand(d.shape, generator=generator, dtype=torch.float32, device=device)
        if d.init == "a_log":  # mamba: A in [1, 16) -> log
            return torch.log(u * 15.0 + 1.0).to(dtype)
        # mamba: dt ~ logU[1e-3, 1e-1], inverse softplus
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=device)
    if d.init == "normal":
        return x.mul_(d.scale).to(dtype)
    fan_in = d.shape[0]
    if len(d.shape) >= 3:
        fan_in = d.shape[-2]
    return x.mul_(d.scale / math.sqrt(max(fan_in, 1))).to(dtype)


def init_tree(decl: Dict[str, Any], dtype, generator, device) -> Dict[str, Any]:
    """Materialize a decl tree, leaf by leaf in insertion order."""
    return {
        name: init_leaf(d, dtype, generator, device) if isinstance(d, ParamDecl)
        else init_tree(d, dtype, generator, device)
        for name, d in decl.items()
    }


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_decl(cfg: ModelConfig, dim: Optional[int] = None) -> Dict[str, ParamDecl]:
    dim = dim or cfg.d_model
    d = {"scale": ParamDecl((dim,), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDecl((dim,), "zeros")
    return d


def apply_norm(p, x, cfg: ModelConfig):
    """RMSNorm or LayerNorm (population variance), computed in f32 and cast
    back to x's dtype."""
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    else:
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def make_positions(batch: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, device=device)[None, :].expand(batch, seq)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, rotary_pct: float = 1.0):
    """x: (B, S, H, hd); positions: (B, S).  Rotates the first
    ``rot = even(hd * rotary_pct)`` channels (stablelm-2: 25%), angles in f32."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, :, None, None].to(torch.float32) * freqs  # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_decl(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamDecl]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    decl = {"w_up": ParamDecl((d, f)), "w_down": ParamDecl((f, d))}
    if cfg.gated_mlp:
        decl["w_gate"] = ParamDecl((d, f))
    if cfg.mlp_bias:
        decl["b_up"] = ParamDecl((f,), "zeros")
        decl["b_down"] = ParamDecl((d,), "zeros")
        if cfg.gated_mlp:
            decl["b_gate"] = ParamDecl((f,), "zeros")
    return decl


def _act(cfg: ModelConfig, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.activation == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg: ModelConfig):
    u = x @ p["w_up"]
    if cfg.mlp_bias:
        u = u + p["b_up"]
    if cfg.gated_mlp:
        g = x @ p["w_gate"]
        if cfg.mlp_bias:
            g = g + p["b_gate"]
        h = _act(cfg, g) * u
    else:
        h = _act(cfg, u)
    y = h @ p["w_down"]
    if cfg.mlp_bias:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window, optional cross-attention, caching)
# ---------------------------------------------------------------------------

def attn_decl(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    decl = {
        "w_q": ParamDecl((d, H, hd)),
        "w_k": ParamDecl((d, KV, hd)),
        "w_v": ParamDecl((d, KV, hd)),
        "w_o": ParamDecl((H, hd, d)),
    }
    if cfg.qkv_bias:
        decl["b_q"] = ParamDecl((H, hd), "zeros")
        decl["b_k"] = ParamDecl((KV, hd), "zeros")
        decl["b_v"] = ParamDecl((KV, hd), "zeros")
    if cfg.attn_out_bias:
        decl["b_o"] = ParamDecl((d,), "zeros")
    return decl


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _project_qkv(p, x, cfg: ModelConfig, kv_input=None):
    kv_input = x if kv_input is None else kv_input
    q = _project(x, p["w_q"])
    k = _project(kv_input, p["w_k"])
    v = _project(kv_input, p["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    return q, k, v


def _sdpa(q, k, v, mask):
    """Plain scaled-dot-product GQA attention (the reference's ``_sdpa``).
    q: (B,S,H,hd), k/v: (B,T,KV,hd), mask: (B,1,S,T) or (S,T) bool."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qg.float(), k.float()) / math.sqrt(hd)
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkrst,btkh->bskrh", w, v).reshape(B, S, H, hd)


@functools.lru_cache(maxsize=8)
def ring_valid(index: int, W: int, window: Optional[int], device: torch.device) -> torch.Tensor:
    """(1, W) bool validity of a ring-buffer cache after the token at
    position ``index`` is written into slot ``index % W``: the slot at age
    ``(slot - pos) % W`` holds token ``index - age``, valid iff
    ``age <= min(index, W - 1)`` (and ``age < window`` with a window).
    Cached: every layer of one decode step asks for the same mask."""
    slot = index % W
    age = (slot - torch.arange(W, device=device)) % W
    valid = age <= min(index, W - 1)
    if window is not None:
        valid &= age < window
    return valid[None]


def apply_attention(
    p,
    x,
    cfg: ModelConfig,
    *,
    positions,
    mode: str = "causal",          # causal | bidir | cross
    kv_input=None,                  # encoder memory for cross-attention
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    window: Optional[int] = None,
):
    """Returns (y, kv).  Caching protocol, as the reference's:

    * prefill/train: ``cache=None`` -> full attention over x; returns the
      new ``{'k', 'v'}`` (B, S, KV, hd) to seed a cache.
    * decode: ``cache={'k','v'}`` ring buffers (B, W, KV, hd) and
      ``cache_index`` = #tokens consumed so far; x is (B, 1, D).  The new
      token's k/v are written into slot ``cache_index % W`` in place (the
      reference's ``dynamic_update_slice`` returns a copy) and the same
      dict is returned.
    """
    window = window if window is not None else cfg.sliding_window
    q, k, v = _project_qkv(p, x, cfg, kv_input)
    if mode != "cross":
        # `positions` carries absolute positions for both q and the new k
        # (decode passes the current position for the single new token)
        q = rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = rope(k, positions, cfg.rope_theta, cfg.rotary_pct)

    if cache is not None and mode != "cross":
        ck, cv = cache["k"], cache["v"]
        W = ck.shape[1]
        slot = cache_index % W
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        valid = ring_valid(cache_index, W, window, ck.device).expand(x.shape[0], W)
        y = kops.decode_attention(q[:, 0], ck, cv, valid)[:, None]
        new_cache = cache
    elif mode == "cross":
        if cache is not None:  # pre-projected encoder memory
            k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v}
        y = _sdpa(q, k, v, torch.ones((x.shape[1], k.shape[1]), dtype=torch.bool, device=x.device))
    else:
        if mode == "causal":
            y = kops.flash_attention(q, k, v, causal=True, window=window)
        else:
            S = x.shape[1]
            y = _sdpa(q, k, v, torch.ones((S, S), dtype=torch.bool, device=x.device))
        new_cache = {"k": k, "v": v}

    out = y.flatten(2) @ p["w_o"].flatten(0, 1)
    if cfg.attn_out_bias:
        out = out + p["b_o"]
    return out, new_cache
