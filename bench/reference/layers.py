"""Plain layers of the reference: float32, TF32 off, no kernels, no cache.

Written from the published descriptions (RMSNorm; rotary embeddings on
rotate-half pairs; grouped-query causal attention; the gated MLP; the
Mamba-2 block with its state-space dual form, arXiv:2405.21060), not from
the program.  Every product goes through :func:`matmul`, which in the
``"fp8"`` precision rounds both operands to float8 e4m3 first: the control
that the output check has to fail.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["PRECISIONS", "ROWS", "to_f32", "in_rows", "matmul", "rms_norm", "rope",
           "causal_attention", "act", "ssd", "mamba_mixer", "softplus"]

PRECISIONS = ("f32", "fp8")
#: rows of one per-token product
ROWS = 16384

#: the largest finite float8 e4m3 value
_E4M3_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for each slice along
    ``dim`` (its absolute maximum onto 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / _E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def to_f32(tree):
    """A layer's nested dict of weights, each taken to float32."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    return tree.float()


def in_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of x (n, d) in blocks of :data:`ROWS` rows."""
    if x.shape[0] <= ROWS:
        return fn(x)
    return torch.cat([fn(x[i:i + ROWS]) for i in range(0, x.shape[0], ROWS)])


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """x (n, k) @ w (k, m) in float32; ``"fp8"`` rounds x per row and w
    per column to float8 e4m3 first (what an fp8 inference path does)."""
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, heads, hd) at positions 0 .. S-1: channel
    i is paired with channel i + hd/2, rotated by pos * theta^(-2i/hd)."""
    S, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 256) -> torch.Tensor:
    """Causal softmax attention of q (S, H, hd) over k, v (S, KV, hd),
    query head h reading KV head h // (H / KV); queries in blocks of
    ``block`` rows, each against the keys up to its last row."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)       # (H, S, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty_like(qh)
    for i in range(0, S, block):
        j = min(i + block, S)
        s = qh[:, i:j] @ k[:, :j].transpose(1, 2)               # (H, j-i, j)
        rows = torch.arange(i, j, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(j, device=q.device)[None, :] > rows, float("-inf"))
        out[:, i:j] = torch.softmax(s, dim=-1) @ v[:, :j]
    return out.transpose(0, 1)


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":  # the tanh form
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    raise ValueError(f"unknown activation {name!r}")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), exactly, at every x."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def ssd(x, dt, A, B, C, chunk: int = 64) -> torch.Tensor:
    """The Mamba-2 scan y_t = C_t . h_t, h_t = exp(dt_t A) h_{t-1} +
    dt_t B_t x_t^T from a zero state, computed exactly in its chunked
    quadratic form.  x (S, H, P), dt (S, H), A (H,), B/C (S, G, N); head h
    reads group h // (H / G)."""
    S, H, P = x.shape
    G, N = B.shape[1], B.shape[2]
    pad = -S % chunk
    if pad:  # dt = 0 past the end: no decay, no input
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[0] // chunk
    rep = H // G
    x = x.view(nc, chunk, H, P)
    dt = dt.view(nc, chunk, H)
    Bh = B.view(nc, chunk, G, N).repeat_interleave(rep, dim=2)   # (nc, l, H, N)
    Ch = C.view(nc, chunk, G, N).repeat_interleave(rep, dim=2)
    cum = torch.cumsum(dt * A, dim=1)                            # (nc, l, H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]                # (nc, t, s, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, :, :, None], float("-inf")))
    scores = torch.einsum("cthn,cshn->ctsh", Ch, Bh)
    w = scores * decay * dt[:, None, :, :]                       # (nc, t, s, H)
    y = torch.einsum("ctsh,cshp->cthp", w, x)
    # each chunk's own state, then the states carried across chunks
    tail = torch.exp(cum[:, -1:, :] - cum) * dt                  # (nc, s, H)
    own = torch.einsum("csh,cshn,cshp->chnp", tail, Bh, x)
    h = torch.zeros(H, N, P, dtype=x.dtype, device=x.device)
    carried = []
    for c in range(nc):
        carried.append(h)
        h = torch.exp(cum[c, -1])[:, None, None] * h + own[c]
    carried = torch.stack(carried)                               # (nc, H, N, P)
    y = y + torch.einsum("cthn,chnp->cthp", Ch * torch.exp(cum)[..., None], carried)
    return y.reshape(nc * chunk, H, P)[:S]


def mamba_mixer(p, x, c: dict, precision: str = "f32") -> torch.Tensor:
    """The Mamba-2 block of x (S, d): input projection to z, x, B, C, dt;
    depthwise causal conv over (x, B, C) and SiLU; the scan plus D x; the
    gated RMSNorm of y * SiLU(z); the output projection."""
    S, d = x.shape
    di = c["ssm_expand"] * d
    P, G, N = c["ssm_headdim"], c["ssm_ngroups"], c["ssm_state"]
    H = di // P
    zxbcdt = matmul(x, p["in_proj"], precision)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    w = p["conv_w"]                                              # (W, ch)
    xp = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
    conv = p["conv_b"] + sum(xp[i:i + S] * w[i] for i in range(w.shape[0]))
    xbc = F.silu(conv)
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xs = xs.reshape(S, H, P)
    y = ssd(xs, dt, A, Bm.reshape(S, G, N), Cm.reshape(S, G, N))
    y = (y + p["D"][:, None] * xs).reshape(S, di)
    y = rms_norm(y * F.silu(z), p["norm_scale"], c["norm_eps"])
    return matmul(y, p["out_proj"], precision)
