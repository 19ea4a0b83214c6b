"""User-Satisfaction (US) metric — Eq. (1) of the paper, in PyTorch.

US_{ijkl} = w_a * (a_{ijkl} - A_i) / Max_as  +  w_c * (C_i - c_{ijkl}) / Max_cs

Op for op the same as ``repro.core.satisfaction``: two IEEE divisions, two
rounded products and one rounded add per candidate, so ``us_tensor`` is
bit-equal to the reference on the CPU.  ``mean_us``'s row mean is a
reduction whose summation order PyTorch and XLA choose differently, so it
agrees with the reference only to a stated tolerance (see the fleet tests).
"""
from __future__ import annotations

import torch

from .instance import FlatInstance

__all__ = ["us_tensor", "hard_feasible", "mean_us", "satisfied_mask"]


def us_tensor(inst: FlatInstance) -> torch.Tensor:
    """(..., N, M, L) user satisfaction for every candidate assignment."""
    max_as = inst.max_as[..., None, None, None]
    max_cs = inst.max_cs[..., None, None, None]
    acc_term = (inst.acc - inst.A[..., :, None, None]) / max_as
    time_term = (inst.C[..., :, None, None] - inst.ctime) / max_cs
    return (
        inst.w_a[..., :, None, None] * acc_term
        + inst.w_c[..., :, None, None] * time_term
    )


def hard_feasible(inst: FlatInstance) -> torch.Tensor:
    """(..., N, M, L) bool: placement + accuracy floor + deadline (2b), (2c)."""
    return (
        inst.avail
        & (inst.acc >= inst.A[..., :, None, None])
        & (inst.ctime <= inst.C[..., :, None, None])
    )


def _pick(x: torch.Tensor, j: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """``x[..., i, j_i, l_i]`` for every request row i."""
    L = x.shape[-1]
    flat = (j * L + l).long()
    return torch.gather(x.flatten(-2), -1, flat[..., None])[..., 0]


def satisfied_mask(inst: FlatInstance, assign_j, assign_l) -> torch.Tensor:
    """(..., N) bool: request i assigned (assign_j >= 0) and QoS met."""
    served = assign_j >= 0
    j = assign_j.clamp_min(0)
    l = assign_l.clamp_min(0)
    acc = _pick(inst.acc, j, l)
    ct = _pick(inst.ctime, j, l)
    return served & (acc >= inst.A) & (ct <= inst.C)


def mean_us(inst: FlatInstance, assign_j, assign_l) -> torch.Tensor:
    """Objective (2): mean US over all |N| requests (dropped contribute 0).

    Gathers the chosen (j, l) cell first and evaluates Eq. (1) only there —
    the same elementwise operations, in the same order, as picking out of
    :func:`us_tensor`.
    """
    served = assign_j >= 0
    j = assign_j.clamp_min(0)
    l = assign_l.clamp_min(0)
    acc_term = (_pick(inst.acc, j, l) - inst.A) / inst.max_as[..., None]
    time_term = (inst.C - _pick(inst.ctime, j, l)) / inst.max_cs[..., None]
    picked = inst.w_a * acc_term + inst.w_c * time_term
    return torch.where(served, picked, torch.zeros_like(picked)).mean(dim=-1)
