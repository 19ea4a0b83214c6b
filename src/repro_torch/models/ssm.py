"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) layer.

The port's counterpart of ``repro/models/ssm.py``: the chunked SSD form for
teacher forcing and prefill, routed through ``kernels.ops.ssd`` (the Hopper
kernel on CUDA tensors, its plain version on CPU tensors), and the O(1)
recurrent update for decode.  Where the reference's prefill
(``return_state=True``) leaves its Pallas kernel for the plain
``ssd_reference``, the port's kernel writes out the final state, so
prefill runs on the kernel too.

Block layout (mamba2-130m / zamba2 style):
  in_proj : d -> [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
  conv1d  : depthwise causal width-w over the (x | B | C) channels
  SSD     : y = SSD(x, dt, A, B, C) + D * x
  gate    : y = RMSNormGated(y * silu(z))
  out_proj: d_inner -> d

The gated RMSNorm normalises over all of d_inner, as the reference's; a
configuration with ``norm_groups`` above 1 (``zamba2``: Zamba2RMSNormGated's
``group_size = d_inner / ngroups``) normalises each group on its own.

The causal conv with its bias and SiLU goes through ``kops.causal_conv``:
one Hopper kernel for CUDA tensors on the ``"cuda"`` model backend (on
each rank's shards for DTensors), else the plain expression
(``_causal_conv``, then ``F.silu``).

Under a recording ``torch.profiler`` profile :func:`apply_mamba`'s passes
are spans (``obs.profiler.annotate``): ``ssm/in_proj``, ``ssm/conv`` (the
causal conv, its bias and the SiLU: the kernel's launch, or the plain
version's pad, concatenation, taps, bias and SiLU),
``ssm/dt`` (softplus(dt + bias) and A), ``ssm/scan`` (the SSD kernel or
its plain form), ``ssm/gated_norm`` and ``ssm/out_proj``; the D skip
between the scan and the gated norm is the enclosing span's own.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..kernels.causal_conv import causal_conv_ref as _causal_conv  # noqa: F401
from ..kernels.ssd_scan import ssd_reference
from ..obs.profiler import annotate
from ..sharding import shard
from .layers import ParamDecl

__all__ = [
    "mamba_decl",
    "apply_mamba",
    "mamba_decode_step",
    "init_ssm_state",
    "ssd_reference",
]


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    H = cfg.ssm_nheads
    P = cfg.ssm_headdim
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    return di, H, P, G, N


def mamba_decl(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    di, H, P, G, N = _dims(cfg)
    conv_ch = di + 2 * G * N
    return {
        "in_proj": ParamDecl((d, 2 * di + 2 * G * N + H), ("embed", "d_inner")),
        "conv_w": ParamDecl((cfg.ssm_conv, conv_ch), ("conv", "d_inner"), "normal", 0.2),
        "conv_b": ParamDecl((conv_ch,), ("d_inner",), "zeros"),
        "A_log": ParamDecl((H,), ("ssm_heads",), "a_log"),
        "dt_bias": ParamDecl((H,), ("ssm_heads",), "dt_bias"),
        "D": ParamDecl((H,), ("ssm_heads",), "ones"),
        "norm_scale": ParamDecl((di,), ("d_inner",), "ones"),
        "out_proj": ParamDecl((di, d), ("d_inner", "embed")),
    }


# ---------------------------------------------------------------------------
# Layer forward (train / prefill)
# ---------------------------------------------------------------------------

def _split_proj(z_all, cfg: ModelConfig):
    di, H, P, G, N = _dims(cfg)
    return torch.split(z_all, [di, di + 2 * G * N, H], dim=-1)


def _gated_rmsnorm(y, z, scale, eps, groups: int = 1):
    """RMSNorm of y * silu(z) over the last axis, or over each of its
    ``groups`` equal parts, times ``scale``."""
    y = y * F.silu(z)
    y32 = y.float()
    if groups == 1:
        var = y32.square().mean(-1, keepdim=True)
        return (y32 * torch.rsqrt(var + eps) * scale).to(y.dtype)
    yg = y32.unflatten(-1, (groups, -1))
    var = yg.square().mean(-1, keepdim=True)
    return ((yg * torch.rsqrt(var + eps)).flatten(-2) * scale).to(y.dtype)


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def apply_mamba(p, x, cfg: ModelConfig, conv_state=None, ssm_state=None, return_state=False):
    """Full-sequence forward.  x: (B, S, D) -> y  or  (y, (conv_state,
    ssm_state)) when ``return_state`` (used by prefill to seed the decode
    cache; the SSM state is f32).  ``ssm_state`` (B, H, N, P) is the
    scan's initial state (zero when ``None``), as in the reference's plain
    path; it reaches the SSD kernel on either route."""
    B, S, D = x.shape
    di, H, P, G, N = _dims(cfg)
    with annotate("ssm/in_proj"):
        zall = x @ p["in_proj"]
    z, xBC, dt = _split_proj(zall, cfg)
    with annotate("ssm/conv"):
        xBC, new_conv = kops.causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state,
                                         return_state=return_state)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = shard(xs.unflatten(-1, (H, P)), "batch", None, "ssm_heads", "ssm_headdim")
    Bm = Bm.unflatten(-1, (G, N))
    Cm = Cm.unflatten(-1, (G, N))
    with annotate("ssm/dt"):
        dt = _softplus(dt + p["dt_bias"])                     # (B, S, H)
        A = -torch.exp(p["A_log"].float())

    with annotate("ssm/scan"):
        res = kops.ssd(xs, dt, A, Bm, Cm, chunk=cfg.ssd_chunk, return_final_state=return_state,
                       initial_state=ssm_state)
    y, final_state = res if return_state else (res, None)
    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(B, S, di)
    with annotate("ssm/gated_norm"):
        y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps, cfg.norm_groups)
    with annotate("ssm/out_proj"):
        out = y @ p["out_proj"]
    if return_state:
        return out, (new_conv, final_state)
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    di, H, P, G, N = _dims(cfg)
    conv_ch = di + 2 * G * N
    return (
        torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        torch.zeros((batch, H, N, P), dtype=dtype, device=device),
    )


def mamba_decode_step(p, x, cfg: ModelConfig, conv_state, ssm_state):
    """Single-token recurrent update.  x: (B, 1, D).
    conv_state: (B, W-1, Ch); ssm_state: (B, H, N, P).  The state is updated
    in f32 and returned in ``ssm_state``'s dtype."""
    B = x.shape[0]
    di, H, P, G, N = _dims(cfg)
    zall = x @ p["in_proj"]
    z, xBC, dt = _split_proj(zall, cfg)
    xBC, new_conv = kops.causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, P)
    Bm = Bm.reshape(B, G, N)
    Cm = Cm.reshape(B, G, N)
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1)                     # (B, H, N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    dt1 = _softplus(dt[:, 0] + p["dt_bias"])                  # (B, H)
    A = -torch.exp(p["A_log"].float())

    decay = torch.exp(dt1 * A)[..., None, None]               # (B, H, 1, 1)
    upd = (dt1[..., None, None] * Bh.float()[..., :, None]) * xs.float()[..., None, :]
    new_state = ssm_state.float() * decay + upd               # (B, H, N, P) f32
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), new_state)
    y = y.to(x.dtype) + p["D"][None, :, None].to(x.dtype) * xs
    y = y.reshape(B, 1, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps, cfg.norm_groups)
    out = (y @ p["out_proj"]).to(x.dtype)
    return out, new_conv, new_state.to(ssm_state.dtype)
