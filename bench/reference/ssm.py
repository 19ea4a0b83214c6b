"""The ``ssm`` family's trunk: pre-norm Mamba-2 blocks, each with its
residual (arXiv:2405.21060)."""
from __future__ import annotations

from typing import List

import torch

from .layers import mamba_mixer, rms_norm, to_f32

__all__ = ["trunk"]


def trunk(c: dict, weights, hs: List[torch.Tensor], precision: str) -> List[torch.Tensor]:
    """Every block over each sequence's embedded states (S, d) in float32."""
    for lp in weights["layers"]:
        p = to_f32(lp)
        hs = [h + mamba_mixer(p["mamba"], rms_norm(h, p["ln"]["scale"], c["norm_eps"]), c,
                              precision) for h in hs]
    return hs
