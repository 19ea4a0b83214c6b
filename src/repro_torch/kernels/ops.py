"""Model-layout adapters for the model kernels (attention, SSD).

The port's counterpart of ``repro/kernels/ops.py``: the model keeps q
``(B, S, H, hd)`` and k/v ``(B, T, KV, hd)``; the attention kernels take
``(B, H, S, hd)`` and ``(B, KV, T, hd)``.  The SSD adapter likewise turns
x ``(B, S, H, P)``, dt ``(B, S, H)`` and B/C ``(B, S, G, N)`` into the
kernel's head-major layout.  Every kernel reads through strides, so the
adapters pass transposed views (and an output view) instead of copies;
decode's k/v are the layer's slice of the ring-buffer cache, read in place.

Unlike the reference's ``ops.ssd``, the SSD adapter neither repeats B and
C over heads (the kernel reads group ``h // (H // G)`` by index) nor falls
back to the plain version when ``S % chunk != 0`` (the kernel takes a
ragged last chunk itself, by the reference's dt = 0 padding rule).
"""
from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .ssd_scan import ssd_scan as _ssd_kernel

__all__ = ["flash_attention", "decode_attention", "ssd"]


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    backend: Optional[str] = None):
    """Model layout: q (B, S, H, hd); k/v (B, T, KV, hd) -> (B, S, H, hd)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash_kernel(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, backend=backend, out=out.transpose(1, 2),
    )
    return out


def decode_attention(q, k, v, valid, *, backend: Optional[str] = None):
    """Model layout: q (B, H, hd) one token, head ``g * rep + r`` serving
    KV group g; k/v cache (B, T, KV, hd); valid (B, T) bool -> (B, H, hd)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _decode_kernel(
        q.unflatten(1, (KV, H // KV)), k.transpose(1, 2), v.transpose(1, 2), valid,
        backend=backend, out=out.unflatten(1, (KV, H // KV)),
    )
    return out


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128, return_final_state: bool = False,
        backend: Optional[str] = None):
    """Model layout: x (B, S, H, P), dt (B, S, H), A (H,) f32, Bm/Cm
    (B, S, G, N) -> y (B, S, H, P) [, final state (B, H, N, P) f32]."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    res = _ssd_kernel(
        x.transpose(1, 2), dt.transpose(1, 2), A, Bm.transpose(1, 2), Cm.transpose(1, 2),
        chunk=chunk, return_final_state=return_final_state,
        backend=backend, out=y.transpose(1, 2),
    )
    return (y, res[1]) if return_final_state else y
