"""Core layers: declarative params, norms, RoPE, GQA attention, MLP.

The port's counterpart of ``repro/models/layers.py``.  Params are plain
nested dicts of tensors; every parameter is declared once (shape + init
kind) in a decl tree, and :func:`init_leaf` draws it from a
``torch.Generator`` on the target device.  Each declaration names the
logical axes of its dimensions (:func:`specs_from_decl`), and activations
carry the reference's ``shard(...)`` annotations: no-ops outside
``sharding.use_sharding``, a DTensor redistribution inside it
(``launch/steps.py``).

Attention in causal mode goes through ``kernels.ops.flash_attention`` and
decode through ``kernels.ops.decode_attention``: the Hopper kernels on CUDA
tensors, their plain versions on CPU tensors.  ``mode="cross"`` and
``"bidir"`` (the encoder-decoder family's cross attention and encoder) keep
the plain :func:`_sdpa` math, as the reference never sends them to its
flash kernel.  With ``attn_impl="chunked"`` the prefill and train paths
that do not launch the flash kernel take :func:`_sdpa_chunked`, the
reference's rule (flash where its kernel runs, else chunked, else plain).

With ``kv_cache_dtype="int8"`` the ring holds int8 values and f32 scales
(``models/quant.py``); decode quantizes the new token's k and v, writes
them in place, and hands the decode kernel the whole ring dequantized to
the activation dtype, as the reference hands its Pallas kernel.

Decode takes ``cache_index`` as an ``int`` (every row at the same
position: ``ServingEngine``) or as a ``(B,)`` integer tensor on the
device (each row its own position: ``ContinuousBatcher``), with no host
sync on the second path.

Under a recording ``torch.profiler`` profile the passes are spans
(``obs.profiler.annotate``): ``norm`` (each norm; its parent span tells
which), ``mlp``, and attention's ``attn/qkv`` (the projections and their
biases), ``attn/rope``, ``attn/core`` (the attention kernel or its plain
form; in decode with the ring's validity and, for an int8 cache, its
dequantization), ``attn/out`` (the output projection), and in decode
``cache/write`` (the new token's k and v into the ring).

The ``zamba2`` family's shared block (``configs/zamba2.py``) runs on these
layers through its configuration: attention reads ``cfg.attn_in`` wide
inputs (:func:`attn_decl`) at the softmax scale ``cfg.attn_scale``
(:func:`apply_attention`), the MLP takes the exact-erf GELU
(``activation="gelu_exact"``), and :func:`apply_mlp` adds a site's
low-rank adapter on the gate/up product where ``p`` carries one
(``lora_a``, ``lora_b``; span ``shared/lora``).  Other configurations have
no such attributes and keep ``d_model`` and ``1/sqrt(head_dim)``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..kernels.common import resolve_model_backend
from ..obs.profiler import annotate
from ..sharding import current_ctx, placements_for, shard
from .quant import dequantize_kv, quantize_kv

__all__ = [
    "ParamDecl",
    "init_leaf",
    "specs_from_decl",
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
    logical: Tuple[Optional[str], ...]   # one logical axis name a dimension (sharding.py)
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


def specs_from_decl(decl: Dict[str, Any], stack: bool = False):
    """The logical axes of every leaf of a decl tree, in its layout;
    ``stack=True`` prepends the reference's stacked ``"layers"`` axis."""
    if isinstance(decl, ParamDecl):
        return ("layers",) + decl.logical if stack else decl.logical
    return {k: specs_from_decl(v, stack) for k, v in decl.items()}


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
    d = {"scale": ParamDecl((dim,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDecl((dim,), ("embed",), "zeros")
    return d


def apply_norm(p, x, cfg: ModelConfig):
    """RMSNorm or LayerNorm (population variance), computed in f32 and cast
    back to x's dtype."""
    with annotate("norm"):
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

def make_positions(batch: int, seq: int, offset=0, *, device=None) -> torch.Tensor:
    """(batch, seq) positions ``offset .. offset + seq - 1`` on ``device``
    (``offset`` an int, or a tensor that broadcasts against (batch, seq))."""
    return (torch.arange(seq, device=device)[None, :] + offset).expand(batch, seq)


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
    decl = {
        "w_up": ParamDecl((d, f), ("embed", "ff")),
        "w_down": ParamDecl((f, d), ("ff", "embed")),
    }
    if cfg.gated_mlp:
        decl["w_gate"] = ParamDecl((d, f), ("embed", "ff"))
    if cfg.mlp_bias:
        decl["b_up"] = ParamDecl((f,), ("ff",), "zeros")
        decl["b_down"] = ParamDecl((d,), ("embed",), "zeros")
        if cfg.gated_mlp:
            decl["b_gate"] = ParamDecl((f,), ("ff",), "zeros")
    return decl


def _act(cfg: ModelConfig, x):
    if cfg.activation == "silu":
        return F.silu(x)
    if cfg.activation == "gelu_exact":
        return F.gelu(x)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg: ModelConfig):
    """The MLP; where ``p`` carries a low-rank adapter (``lora_a`` (d, r),
    ``lora_b`` (r, 2 d_ff): the ``zamba2`` family's per-site adapter), its
    product is added to the gate (first d_ff columns) and up (the rest)
    products before the activation."""
    with annotate("mlp"):
        u = x @ p["w_up"]
        if cfg.mlp_bias:
            u = u + p["b_up"]
        if "lora_a" in p:
            with annotate("shared/lora"):
                lo_g, lo_u = ((x @ p["lora_a"]) @ p["lora_b"]).chunk(2, dim=-1)
            u = u + lo_u
        if cfg.gated_mlp:
            g = x @ p["w_gate"]
            if cfg.mlp_bias:
                g = g + p["b_gate"]
            if "lora_a" in p:
                g = g + lo_g
            h = _act(cfg, g) * u
        else:
            h = _act(cfg, u)
        h = shard(h, "batch", None, "ff")
        y = h @ p["w_down"]
        if cfg.mlp_bias:
            y = y + p["b_down"]
        return y


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window, optional cross-attention, caching)
# ---------------------------------------------------------------------------

def attn_decl(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamDecl]:
    """The attention block's parameters; ``cross`` is inert (the
    reference's: a cross-attention block declares the same leaves).  q, k
    and v read ``cfg.attn_in`` wide inputs (``d_model``, but for ``zamba2``)."""
    d, hd = cfg.d_model, cfg.head_dim
    d_in = cfg.attn_in
    H, KV = cfg.num_heads, cfg.num_kv_heads
    decl = {
        "w_q": ParamDecl((d_in, H, hd), ("embed", "heads", "head_dim")),
        "w_k": ParamDecl((d_in, KV, hd), ("embed", "kv_heads", "head_dim")),
        "w_v": ParamDecl((d_in, KV, hd), ("embed", "kv_heads", "head_dim")),
        "w_o": ParamDecl((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        decl["b_q"] = ParamDecl((H, hd), ("heads", "head_dim"), "zeros")
        decl["b_k"] = ParamDecl((KV, hd), ("kv_heads", "head_dim"), "zeros")
        decl["b_v"] = ParamDecl((KV, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.attn_out_bias:
        decl["b_o"] = ParamDecl((d,), ("embed",), "zeros")
    return decl


def _flatten(t, start: int, end: int):
    """``t.flatten(start, end)``; a DTensor is flattened on each rank's
    shard and wrapped again, so that neither the view nor, in the backward,
    its gradient splits a sharded dimension anew (a gradient may come back
    sharded where the merged dimension would cut a head).  The rules shard
    at most the first merged dimension, whole; a partial sum is reduced
    first."""
    if not isinstance(t, DTensor):
        return t.flatten(start, end)
    if any(not isinstance(p, (Shard, Replicate)) for p in t.placements):
        t = t.redistribute(t.device_mesh, [p if isinstance(p, Shard) else Replicate()
                                           for p in t.placements])
    pl = []
    for p in t.placements:
        if isinstance(p, Shard) and start < p.dim <= end:
            raise ValueError(f"cannot merge dimensions {start}..{end} of a tensor sharded on "
                             f"dimension {p.dim}")
        pl.append(Shard(p.dim - (end - start)) if isinstance(p, Shard) and p.dim > end else p)
    return DTensor.from_local(t.to_local().flatten(start, end), t.device_mesh, pl,
                              run_check=False)


def _project(x, w, heads: str):
    """einsum("bsd,dhk->bshk") as one matrix product.  Under
    ``use_sharding`` the product (B, S, H * hd) is first laid out as its
    (B, S, H, hd) view will be, with the heads on the mesh axes of the
    logical axis ``heads`` (or gathered where those cannot split H), so
    that the split into heads stays local."""
    y = x @ _flatten(w, 1, 2)
    if isinstance(y, DTensor) and current_ctx()[0] is not None:
        H = w.shape[1]
        pl = placements_for((y.shape[0], y.shape[1], H, y.shape[2] // H),
                            ("batch", None, heads, None), y.device_mesh, current_ctx()[1])
        pl = tuple(Shard(2) if isinstance(q, Shard) and q.dim == 2 else q for q in pl)
        if tuple(y.placements) != pl:
            y = y.redistribute(y.device_mesh, pl)
    return y.unflatten(-1, w.shape[1:])


def _project_qkv(p, x, cfg: ModelConfig, kv_input=None):
    kv_input = x if kv_input is None else kv_input
    q = _project(x, p["w_q"], "heads")
    k = _project(kv_input, p["w_k"], "kv_heads")
    v = _project(kv_input, p["w_v"], "kv_heads")
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    return q, k, v


def _sdpa(q, k, v, mask):
    """Plain scaled-dot-product GQA attention (the reference's ``_sdpa``).
    q: (B,S,H,hd), k/v: (B,T,KV,hd), mask: (B,1,S,T) or (S,T) bool.

    DTensors (mask (S,T), the same on every rank) run on each rank's shards
    of the batch and the heads, as the attention kernels do
    (``kernels.ops.on_local_heads``): torch 2.11's DTensor cannot fold the
    einsum's batch dimensions where the batch and the heads are sharded on
    two mesh axes.  On one device it is the same arithmetic, bit for bit."""
    if isinstance(q, DTensor):
        return kops.on_local_heads(lambda a, b, c: _sdpa(a, b, c, mask), q, k, v, name="_sdpa")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qg.float(), k.float()) / math.sqrt(hd)
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkrst,btkh->bskrh", w, v).reshape(B, S, H, hd)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, *, causal: bool, window: Optional[int]):
    """The reference's ``_sdpa_chunked``, op for op: q in chunks of
    ``min(cfg.attn_block, S)`` rows, each against a static k range
    ``[lo, hi)`` (causal: up to the chunk's last row; causal with a window:
    from its first row's window), f32 scores and softmax, the weights cast
    to q's dtype before ``P.V``.  Never materializes the (S, T) scores.
    The scores over sqrt(hd), or times ``cfg.attn_scale`` where it is not
    ``None`` (``zamba2``).  DTensors run on each rank's
    shards, as :func:`_sdpa`."""
    if isinstance(q, DTensor):
        return kops.on_local_heads(
            lambda a, b, c: _sdpa_chunked(a, b, c, cfg, causal=causal, window=window),
            q, k, v, name="_sdpa_chunked")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    blk = max(min(cfg.attn_block, S), 1)
    scale = cfg.attn_scale
    outs = []
    for i in range(0, S, blk):
        b = min(blk, S - i)
        qb = q[:, i:i + b].reshape(B, b, KV, rep, hd)
        hi = min(i + b, T) if causal else T
        lo = max(0, i + 1 - (window or T)) if (causal and window) else 0
        kb, vb = k[:, lo:hi], v[:, lo:hi]
        logits = torch.einsum("bskrh,btkh->bkrst", qb.float(), kb.float())
        logits = logits / math.sqrt(hd) if scale is None else logits * scale
        qi = (i + torch.arange(b, device=q.device))[:, None]
        kj = (lo + torch.arange(hi - lo, device=q.device))[None, :]
        m = torch.ones((b, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            m &= kj <= qi
        if window is not None:
            m &= kj > qi - window
        logits = torch.where(m, logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkrst,btkh->bskrh", w, vb).reshape(B, b, H, hd))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


@functools.lru_cache(maxsize=8)
def _ring_valid_at(index: int, W: int, window: Optional[int], device: torch.device):
    slot = index % W
    age = (slot - torch.arange(W, device=device)) % W
    valid = age <= min(index, W - 1)
    if window is not None:
        valid &= age < window
    return valid[None]


def ring_valid(index, W: int, window: Optional[int], device: torch.device) -> torch.Tensor:
    """Validity of a ring-buffer cache after the token at position
    ``index`` is written into slot ``index % W``: the slot at age
    ``(slot - pos) % W`` holds token ``index - age``, valid iff
    ``age <= min(index, W - 1)`` (and ``age < window`` with a window).

    ``index`` an ``int``: a (1, W) mask, cached (every layer of one decode
    step asks for the same one).  ``index`` a (B,) integer tensor (each row
    at its own position): a (B, W) mask computed on its device, row by
    row, with no host sync."""
    if not isinstance(index, torch.Tensor):
        return _ring_valid_at(index, W, window, device)
    age = (index[:, None] % W - torch.arange(W, device=index.device)) % W
    valid = age <= torch.clamp(index, max=W - 1)[:, None]
    if window is not None:
        valid &= age < window
    return valid


def _flash_launches(q: torch.Tensor) -> bool:
    """Whether a causal prefill call on q's device launches the flash
    kernel: a CUDA tensor whose model backend resolves to ``"cuda"`` (the
    reference's ``use_pallas``)."""
    return q.device.type == "cuda" and resolve_model_backend(None, q.device) == "cuda"


def apply_attention(
    p,
    x,
    cfg: ModelConfig,
    *,
    positions,
    mode: str = "causal",          # causal | bidir | cross
    kv_input=None,                  # encoder memory for cross-attention
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index=None,
    window: Optional[int] = None,
):
    """Returns (y, kv).  Caching protocol, as the reference's:

    * prefill/train: ``cache=None`` -> full attention over x; returns the
      new ``{'k', 'v'}`` (B, S, KV, hd) to seed a cache.
    * decode: ``cache={'k','v'}`` ring buffers (B, W, KV, hd) (int8, with
      f32 ``'k_scale'``/``'v_scale'`` (B, W, KV, 1) for an int8 cache) and
      ``cache_index`` = #tokens consumed so far, an ``int`` or a (B,)
      integer tensor (one position a row); x is (B, 1, D).  The new
      token's k/v are written into slot ``cache_index % W`` of each row in
      place (the reference's ``dynamic_update_slice`` returns a copy) and
      the same dict is returned.

    The softmax scale is ``cfg.attn_scale`` where it is not ``None``
    (``zamba2``), else 1/sqrt(head_dim).
    """
    window = window if window is not None else cfg.sliding_window
    scale = cfg.attn_scale
    with annotate("attn/qkv"):
        q, k, v = _project_qkv(p, x, cfg, kv_input)
    if mode != "cross":
        # `positions` carries absolute positions for both q and the new k
        # (decode passes the current position for the single new token)
        with annotate("attn/rope"):
            q = rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
            k = rope(k, positions, cfg.rope_theta, cfg.rotary_pct)

    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)

    if cache is not None and mode != "cross":
        B, W = x.shape[0], cache["k"].shape[1]
        with annotate("cache/write"):
            if isinstance(cache_index, torch.Tensor):  # one position a row
                at = (torch.arange(B, device=x.device), cache_index % W)
            else:
                at = (slice(None), cache_index % W)
            if "k_scale" in cache:  # int8 cache: quantize and write; the ring is read below
                for name, t in (("k", k), ("v", v)):
                    tq, ts = quantize_kv(t[:, 0])
                    cache[name][at] = tq
                    cache[name + "_scale"][at] = ts
            else:
                cache["k"][at] = k[:, 0].to(cache["k"].dtype)
                cache["v"][at] = v[:, 0].to(cache["v"].dtype)
        with annotate("attn/core"):
            if "k_scale" in cache:
                ck = dequantize_kv(cache["k"], cache["k_scale"], k.dtype)
                cv = dequantize_kv(cache["v"], cache["v_scale"], v.dtype)
            else:
                ck, cv = cache["k"], cache["v"]
            valid = ring_valid(cache_index, W, window, ck.device).expand(B, W)
            y = kops.decode_attention(q[:, 0], ck, cv, valid, scale=scale)[:, None]
        new_cache = cache
    elif mode == "cross":
        if cache is not None:  # pre-projected encoder memory
            k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v}
        with annotate("attn/core"):
            y = _sdpa(q, k, v, torch.ones((x.shape[1], k.shape[1]), dtype=torch.bool,
                                          device=x.device))
    else:
        with annotate("attn/core"):
            if mode == "causal" and (cfg.attn_impl != "chunked" or _flash_launches(q)):
                y = kops.flash_attention(q, k, v, causal=True, window=window, scale=scale)
            elif cfg.attn_impl == "chunked":
                y = _sdpa_chunked(q, k, v, cfg, causal=mode == "causal", window=window)
            else:
                S = x.shape[1]
                y = _sdpa(q, k, v, torch.ones((S, S), dtype=torch.bool, device=x.device))
        new_cache = {"k": k, "v": v}

    with annotate("attn/out"):
        y = shard(y, "batch", None, "heads", None)
        out = _flatten(y, 2, 3) @ _flatten(p["w_o"], 0, 1)
        if cfg.attn_out_bias:
            out = out + p["b_o"]
    return out, new_cache
