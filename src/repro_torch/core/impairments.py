"""Resilience configuration — the reference's switches, at their defaults.

Only the two configuration dataclasses of ``repro.core.impairments`` are
ported in this slice, so a :class:`~repro_torch.core.simulator.SimConfig`
carries the same fields as the reference's.  The link traces, outage
streams and admission control are not ported yet (ROADMAP.md §1, still to
port: resilience): ``simulate`` and ``simulate_fleet`` raise
``NotImplementedError`` when either switch is on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

__all__ = ["ImpairmentConfig", "AdmissionConfig"]


@dataclasses.dataclass(frozen=True)
class ImpairmentConfig:
    """Network/server fault injection (``enabled=False``: off)."""

    enabled: bool = False
    amplitude: float = 1.0
    link_profiles: Tuple = ()
    seed: int = 0
    outage_mtbf_frames: float = 0.0
    outage_mttr_frames: float = 3.0
    outage_servers: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission control: queue caps and deadline shedding (``enabled=False``:
    off)."""

    enabled: bool = False
    queue_cap_mult: float = math.inf
    shed: bool = False
