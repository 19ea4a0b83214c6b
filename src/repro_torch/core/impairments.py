"""Resilience layer — link impairments, stochastic outages, admission control.

The PyTorch counterpart of ``repro.core.impairments``.  Three mechanisms
sit behind the same switch discipline as
:class:`~repro_torch.core.queueing.CongestionConfig` — **bit-identical
results when disabled**, deterministic given a seed when enabled:

* **Link-quality traces** — each edge carries a :class:`LinkTrace`, a
  frame-indexed sequence of ``(bandwidth_scale, extra_latency_ms)`` pairs
  drawn from a composable :class:`LinkProfile` (intermittent connectivity,
  bursty loss, handoff gaps, satellite latency).  The trace modulates the
  scheduler-visible transfer times (through the frame's ``ctime``) and the
  realized channel of the sequential testbed; the per-edge scale rides the
  carry (``carry.link_bw``).
* **Server outage/recovery events** — a per-server up/down Markov chain
  parameterized by MTBF/MTTR in frames (:class:`OutageTrace`).  The
  engine's capacity mask multiplies into the frame budgets like a
  scenario's ``capacity_scale``, and the up vector rides the carry
  (``carry.server_up``).
* **Admission control** — :class:`AdmissionConfig`: per-server queue caps
  (:func:`apply_queue_cap`) and deadline shedding against the pre-frame
  inflation estimate (:func:`predicted_inflation`, :func:`admission_keep`).

The host part (profiles, traces, engine) is numpy, line for line the
reference's: every trace owns a ``np.random.default_rng(seed)`` and draws
in frame order with the reference's seeds (``seed * 1_000_003 + e`` per
edge, ``seed * 2_000_003 + j`` per server), so the sequences are the same
bit for bit, and a value depends only on ``(profile, seed, frame)``,
never on how the frames were pulled.  The admission primitives are
elementwise PyTorch on tensors with optional leading batch axes, one
rounded operation per call, so they give the same bits on the CPU and on
the card.

The amplitude blend is an exact identity at zero: a trace value
``(raw_bw, raw_lat)`` is applied as ``bw = 1 + amplitude * (raw_bw - 1)``
and ``lat = amplitude * raw_lat``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .instance import FlatInstance
from .queueing import CongestionConfig, comm_inflation, compute_inflation, congested_ctime

__all__ = [
    "LinkProfile",
    "IdealLink",
    "IntermittentLink",
    "BurstyLossLink",
    "HandoffLink",
    "SatelliteLink",
    "ComposedLink",
    "LinkTrace",
    "OutageTrace",
    "ImpairmentConfig",
    "AdmissionConfig",
    "ResilienceEngine",
    "MIN_BW_SCALE",
    "predicted_inflation",
    "admission_keep",
    "apply_queue_cap",
]

#: floor on any profile's bandwidth scale: a "down" link is slow, not a
#: division by zero
MIN_BW_SCALE = 1e-3


# ---------------------------------------------------------------------------
# Link-quality profiles (composable trace generators)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Base profile: the ideal link.  A subclass defines a per-frame Markov
    process emitting ``(bandwidth_scale, extra_latency_ms)`` by overriding
    :meth:`init_state` and :meth:`sample`; profiles are frozen (hashable)."""

    def init_state(self, rng: np.random.Generator):
        return 0

    def sample(self, state, rng: np.random.Generator):
        """One frame: ``(next_state, bandwidth_scale, extra_latency_ms)``,
        called once per frame in frame order."""
        return state, 1.0, 0.0


@dataclasses.dataclass(frozen=True)
class IdealLink(LinkProfile):
    """No impairment: scale 1, zero extra latency."""


@dataclasses.dataclass(frozen=True)
class IntermittentLink(LinkProfile):
    """An up/down Markov chain; while down the link runs at ``down_bw`` of
    nominal bandwidth plus ``down_lat`` ms of retry latency."""

    p_down: float = 0.15   # P(up -> down) per frame
    p_up: float = 0.5      # P(down -> up) per frame
    down_bw: float = 0.05
    down_lat: float = 400.0

    def sample(self, state, rng):
        u = rng.random()
        if state == 0:  # up
            state = 1 if u < self.p_down else 0
        else:
            state = 0 if u < self.p_up else 1
        if state:
            return state, self.down_bw, self.down_lat
        return state, 1.0, 0.0


@dataclasses.dataclass(frozen=True)
class BurstyLossLink(LinkProfile):
    """Gilbert-Elliott bursty loss: a good/bad chain whose bad state cuts
    goodput and adds latency."""

    p_enter: float = 0.2   # P(good -> bad)
    p_exit: float = 0.5    # P(bad -> good)
    bad_bw: float = 0.4
    bad_lat: float = 120.0

    def sample(self, state, rng):
        u = rng.random()
        if state == 0:
            state = 1 if u < self.p_enter else 0
        else:
            state = 0 if u < self.p_exit else 1
        if state:
            return state, self.bad_bw, self.bad_lat
        return state, 1.0, 0.0


@dataclasses.dataclass(frozen=True)
class HandoffLink(LinkProfile):
    """Handoff: roughly every ``period_frames`` (jittered) the link stalls
    for ``gap_frames``.  The state is the countdown to the next handoff
    (0, -1, ... inside the gap)."""

    period_frames: int = 20
    period_jitter: int = 4
    gap_frames: int = 1
    gap_bw: float = 0.1
    gap_lat: float = 250.0

    def _next_period(self, rng) -> int:
        lo = max(1, self.period_frames - self.period_jitter)
        hi = self.period_frames + self.period_jitter
        return int(rng.integers(lo, hi + 1))

    def init_state(self, rng):
        return self._next_period(rng)

    def sample(self, state, rng):
        if state > 0:  # connected; count down to the handoff
            return state - 1, 1.0, 0.0
        if state <= -(self.gap_frames - 1):  # last gap frame: re-arm the timer
            return self._next_period(rng), self.gap_bw, self.gap_lat
        return state - 1, self.gap_bw, self.gap_lat


@dataclasses.dataclass(frozen=True)
class SatelliteLink(LinkProfile):
    """Satellite backhaul: a high propagation delay with Gaussian jitter and
    a mildly reduced goodput, every frame."""

    bw: float = 0.8
    lat: float = 550.0
    lat_jitter: float = 40.0

    def sample(self, state, rng):
        lat = self.lat + self.lat_jitter * rng.standard_normal()
        return state, self.bw, max(lat, 0.0)


@dataclasses.dataclass(frozen=True)
class ComposedLink(LinkProfile):
    """Profiles in series: bandwidth scales multiply, latencies add."""

    parts: Tuple[LinkProfile, ...] = ()

    def init_state(self, rng):
        return tuple(p.init_state(rng) for p in self.parts)

    def sample(self, state, rng):
        new_states: List = []
        bw, lat = 1.0, 0.0
        for p, s in zip(self.parts, state):
            s2, b, t = p.sample(s, rng)
            new_states.append(s2)
            bw *= b
            lat += t
        return tuple(new_states), bw, lat


class LinkTrace:
    """One edge's frame-indexed link trace, drawn lazily and memoized in
    frame order from a private generator: ``value(t)`` depends only on
    ``(profile, seed, t)``, whatever the pull pattern."""

    def __init__(self, profile: LinkProfile, seed: int = 0):
        self.profile = profile
        self._rng = np.random.default_rng(seed)
        self._state = profile.init_state(self._rng)
        self._bw: List[float] = []
        self._lat: List[float] = []

    def __len__(self) -> int:
        return len(self._bw)

    def _extend_to(self, t: int) -> None:
        while len(self._bw) <= t:
            self._state, bw, lat = self.profile.sample(self._state, self._rng)
            self._bw.append(min(max(float(bw), MIN_BW_SCALE), 1.0))
            self._lat.append(max(float(lat), 0.0))

    def value(self, t: int) -> Tuple[float, float]:
        """``(bandwidth_scale, extra_latency_ms)`` for frame ``t``."""
        self._extend_to(t)
        return self._bw[t], self._lat[t]

    def values(self, t0: int, t1: int) -> Tuple[np.ndarray, np.ndarray]:
        """float64 arrays of (scale, latency) for frames ``[t0, t1)``."""
        if t1 > t0:
            self._extend_to(t1 - 1)
        return (
            np.asarray(self._bw[t0:t1], np.float64),
            np.asarray(self._lat[t0:t1], np.float64),
        )


class OutageTrace:
    """One server's up/down chain: per frame ``P(up -> down) = 1/mtbf`` and
    ``P(down -> up) = 1/mttr`` (frames); starts up, memoized like
    :class:`LinkTrace`."""

    def __init__(self, mtbf_frames: float, mttr_frames: float, seed: int = 0):
        self.p_fail = 1.0 / max(float(mtbf_frames), 1.0)
        self.p_repair = 1.0 / max(float(mttr_frames), 1.0)
        self._rng = np.random.default_rng(seed)
        self._up: List[bool] = []
        self._state = True

    def up(self, t: int) -> bool:
        while len(self._up) <= t:
            u = self._rng.random()
            if self._state:
                self._state = not (u < self.p_fail)
            else:
                self._state = u < self.p_repair
            self._up.append(self._state)
        return self._up[t]


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ImpairmentConfig:
    """Network/server fault injection.

    ``enabled=False`` (the default) builds no engine, and every path is the
    unimpaired one.  ``enabled=True`` with ``amplitude=0.0`` runs the engine
    on exact-identity values, so results are bitwise unchanged.
    """

    enabled: bool = False
    #: link-trace blend: ``bw = 1 + amplitude * (raw - 1)``,
    #: ``lat = amplitude * raw``; 0 is an exact identity
    amplitude: float = 1.0
    #: per-edge profiles, cycled over the edges; empty means IdealLink
    link_profiles: Tuple[LinkProfile, ...] = ()
    #: impairment stream seed, independent of the simulation seed and the
    #: replication: every fleet replication sees the same network weather
    seed: int = 0
    #: mean frames between failures of the outage stream (0 disables it)
    outage_mtbf_frames: float = 0.0
    #: mean frames to repair
    outage_mttr_frames: float = 3.0
    #: servers subject to the outage stream
    outage_servers: Tuple[int, ...] = ()

    @property
    def has_outages(self) -> bool:
        return self.outage_mtbf_frames > 0.0 and len(self.outage_servers) > 0


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission control.  ``enabled=False`` skips it; enabled at the
    defaults it is inert (an ``inf`` cap never refuses, ``shed=False``
    keeps every request)."""

    enabled: bool = False
    #: refuse assignments to a server whose carried backlog reaches this
    #: many frame budgets (compute by the serving server, comm by the
    #: covering edge); ``inf`` never refuses, a finite value also refuses
    #: a zero-budget server
    queue_cap_mult: float = math.inf
    #: drop requests that cannot meet their deadline under the pre-frame
    #: congestion estimate (:func:`admission_keep`)
    shed: bool = False


# ---------------------------------------------------------------------------
# The engine (host-side, deterministic, frame-indexed)
# ---------------------------------------------------------------------------


class ResilienceEngine:
    """The fault-injection state of one run: a pure function of ``(config,
    frame index)``, memoized per trace, the same for every replication.

    Its traces extend as frames are asked for; a caller that builds windows
    on a producer thread asks only from that thread.
    """

    def __init__(self, rcfg: ImpairmentConfig, n_edge: int, n_servers: int):
        self.rcfg = rcfg
        self.n_edge = n_edge
        self.n_servers = n_servers
        profiles = rcfg.link_profiles or (IdealLink(),)
        self._traces = [
            LinkTrace(profiles[e % len(profiles)], seed=rcfg.seed * 1_000_003 + e)
            for e in range(n_edge)
        ]
        self._outages = {
            j: OutageTrace(
                rcfg.outage_mtbf_frames,
                rcfg.outage_mttr_frames,
                seed=rcfg.seed * 2_000_003 + j,
            )
            for j in rcfg.outage_servers
            if 0 <= j < n_servers
        } if rcfg.has_outages else {}

    def link_frame(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """Amplitude-blended per-server float64 ``(bandwidth_scale,
        extra_lat_ms)`` for frame ``t``; the cloud tier stays at identity."""
        amp = self.rcfg.amplitude
        scale = np.ones(self.n_servers, np.float64)
        lat = np.zeros(self.n_servers, np.float64)
        for e, tr in enumerate(self._traces):
            bw, lt = tr.value(t)
            scale[e] = 1.0 + amp * (bw - 1.0)
            lat[e] = amp * lt
        np.clip(scale, MIN_BW_SCALE, None, out=scale)
        return scale, lat

    def server_up(self, t: int) -> np.ndarray:
        """(M,) float32 up vector for frame ``t`` (1.0 = up)."""
        up = np.ones(self.n_servers, np.float32)
        for j, tr in self._outages.items():
            if not tr.up(t):
                up[j] = 0.0
        return up

    def capacity_scale(self, t: int) -> Optional[np.ndarray]:
        """float64 budget multiplier of frame ``t`` from the outage stream,
        or ``None`` when there is none (budgets untouched)."""
        if not self._outages:
            return None
        return self.server_up(t).astype(np.float64)


# ---------------------------------------------------------------------------
# Admission-control primitives (tensors with optional leading batch axes)
# ---------------------------------------------------------------------------


def predicted_inflation(backlog_gamma, backlog_eta, gamma, eta, ccfg: CongestionConfig,
                        *, eager: bool = False):
    """Pre-frame inflation estimate ``phi(backlog)`` against the full frame
    budgets, a lower bound on the realized ``phi(backlog + committed)``;
    all ones when congestion is off.  ``eager`` as for
    :func:`~repro_torch.core.queueing.compute_inflation`."""
    if not ccfg.enabled:
        return torch.ones_like(gamma), torch.ones_like(eta)
    return (
        compute_inflation(backlog_gamma, gamma, ccfg, eager=eager),
        comm_inflation(backlog_eta, eta, ccfg, eager=eager),
    )


def admission_keep(inst: FlatInstance, tq, phi_c, phi_e) -> torch.Tensor:
    """``(..., N)`` bool: the request has a placed candidate meeting its
    accuracy floor and its deadline under the inflation estimate.  The
    completion times go through :func:`congested_ctime`'s separate
    operations, so no multiply-add is contracted on any device."""
    ct = congested_ctime(inst, tq, phi_c, phi_e)
    ok = (
        inst.avail
        & (inst.acc >= inst.A[..., :, None, None])
        & (ct <= inst.C[..., :, None, None])
    )
    return ok.flatten(-2).any(-1)


def apply_queue_cap(assign_j, inst: FlatInstance, backlog_gamma, backlog_eta,
                    acfg: AdmissionConfig):
    """Refuse (-> -1) assignments to servers over their backlog cap:
    ``backlog >= queue_cap_mult * budget``, compute side for the serving
    server, comm side for the covering edge of an offloaded request.
    ``inst.gamma``/``inst.eta`` are the full frame budgets.  At the ``inf``
    cap nothing is refused (``>= inf`` and ``>= nan`` are False)."""
    over_c = backlog_gamma >= acfg.queue_cap_mult * inst.gamma
    over_e = backlog_eta >= acfg.queue_cap_mult * inst.eta
    served = assign_j >= 0
    j = assign_j.clamp_min(0).long()
    refuse = served & (
        torch.gather(over_c, -1, j)
        | ((assign_j != inst.cover) & torch.gather(over_e, -1, inst.cover.long()))
    )
    return torch.where(refuse, -1, assign_j)
