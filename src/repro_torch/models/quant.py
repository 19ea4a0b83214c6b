"""INT8 KV-cache quantization (symmetric, one scale per token and KV head).

The port's counterpart of ``repro/models/quant.py``, op for op: the scale
of a (token, kv head) vector is its largest magnitude over 127 (1 where
the vector is all zeros), the values are ``x / scale`` rounded half to
even (``torch.round``, as ``jnp.round``) and clipped to [-127, 127].
Enabled per config with ``kv_cache_dtype="int8"``; the decode path
dequantizes the whole ring before the decode kernel reads it, as the
reference does before its Pallas kernel.  Both functions are plain
PyTorch: the reference has no kernel for them.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_kv", "dequantize_kv"]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 values, f32 scale (..., 1) over the trailing dim)."""
    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones((), device=x.device))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`; ``scale`` broadcasts over the trailing dim."""
    return (q.float() * scale).to(dtype)
