"""Model-layout adapters for the attention kernels.

The port's counterpart of the flash and decode adapters in
``repro/kernels/ops.py``: the model keeps q ``(B, S, H, hd)`` and k/v
``(B, T, KV, hd)``; the kernels take ``(B, H, S, hd)`` and
``(B, KV, T, hd)``.  Both kernels read through strides, so the adapters pass
transposed views (and an output view) instead of copies; decode's k/v are
the layer's slice of the ring-buffer cache, read in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel

__all__ = ["flash_attention", "decode_attention"]


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
