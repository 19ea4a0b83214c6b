"""Congestion subsystem — load-dependent service times and the policy carry.

PyTorch counterpart of ``repro.core.queueing`` (the capacity-overcommit
inflation model; the reference's module docstring gives the model):

* every server carries a **backlog** of unfinished work across frames;
* a frame that commits work ``w`` against budget ``g`` runs at
  utilization ``rho = (b + w) / g``, and realized times inflate by
  ``phi = 1 + slope * max(0, rho - 1) ** power`` (capped);
* the backlog drains at the frame budget: ``b' = max(0, b + w - g * drain)``;
* the scheduler sees only the reduced budget ``max(g - b, 0)``.

Every function is elementwise over tensors with optional leading batch
axes, written one rounded operation per PyTorch call in the reference's
order, so the results are bit-equal to the reference on the CPU and the
same on the card.  Two choices keep that true: the default ``power=2.0``
is a square in both frameworks, and :func:`committed_loads` sums in
request order (see its docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import prng
from .instance import FlatInstance, resolve_device

__all__ = [
    "CongestionConfig",
    "PolicyCarry",
    "init_policy_carry",
    "fleet_policy_carry",
    "compute_inflation",
    "comm_inflation",
    "step_backlog",
    "committed_loads",
    "ema_update",
    "effective_capacity",
    "congested_ctime",
]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class CongestionConfig:
    """Parameters of the capacity-overcommit inflation model.

    ``enabled=False`` (the default) turns the whole subsystem off and the
    fleet's carry is inert.
    """

    enabled: bool = False
    #: inflation slope per unit of compute over-commit (rho - 1)
    compute_slope: float = 4.0
    #: inflation slope per unit of communication over-commit
    comm_slope: float = 4.0
    #: exponent on the over-commit ratio
    power: float = 2.0
    #: fraction of the frame budget available to drain carried backlog
    drain: float = 1.0
    #: hard cap on the inflation factor
    max_inflation: float = 100.0
    #: smoothing of the per-server EMA utilization estimate in the carry
    ema_alpha: float = 0.2


@dataclasses.dataclass(frozen=True)
class PolicyCarry:
    """Policy/simulator state threaded across frames, the reference's
    layout: unbatched for one run (:func:`init_policy_carry`), or with a
    leading ``(R,)`` replication axis on every field for the fleet
    (:func:`fleet_policy_carry`).  ``M`` = number of servers.

    * ``key`` — ``(..., 2)`` uint32 threefry key chain, bit for bit the
      reference's (:mod:`.prng`).  It lives on the host (a CPU tensor)
      whatever the device: keys are split and hashed there.
      Simulator-owned for ``needs_key`` policies; a ``stateful`` policy
      owns it.
    * ``backlog_gamma`` / ``backlog_eta`` — ``(..., M)`` carried compute
      (chip-ms) and communication (KB) backlog.
    * ``ema_util`` — ``(..., M)`` EMA of committed compute utilization.
    * ``bw_prev`` / ``bw_cur`` — ``(...)`` bandwidth-estimator state.
    * ``link_bw`` / ``server_up`` — ``(..., M)`` resilience-engine vectors,
      all ones (impairments are not ported yet).
    """

    key: torch.Tensor
    backlog_gamma: torch.Tensor
    backlog_eta: torch.Tensor
    ema_util: torch.Tensor
    bw_prev: torch.Tensor
    bw_cur: torch.Tensor
    link_bw: torch.Tensor
    server_up: torch.Tensor


def init_policy_carry(
    n_servers: int, *, seed: int = 0, bandwidth_init: float = 0.0, device=None
) -> PolicyCarry:
    """A fresh single-run carry: empty backlogs, zero EMA, key chain
    ``PRNGKey(seed)``, on ``device`` (:func:`resolve_device`: ``None``
    means the card; the key stays on the host)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return PolicyCarry(
        key=torch.from_numpy(prng.PRNGKey(seed)),
        backlog_gamma=torch.zeros((n_servers,), **f32),
        backlog_eta=torch.zeros((n_servers,), **f32),
        ema_util=torch.zeros((n_servers,), **f32),
        bw_prev=torch.tensor(bandwidth_init, **f32),
        bw_cur=torch.tensor(bandwidth_init, **f32),
        link_bw=torch.ones((n_servers,), **f32),
        server_up=torch.ones((n_servers,), **f32),
    )


def fleet_policy_carry(
    n_rep: int, n_servers: int, *, seed: int = 0, bandwidth_init: float = 0.0, device=None
) -> PolicyCarry:
    """A fresh batched carry: one :class:`PolicyCarry` per replication,
    stacked on a leading ``(R,)`` axis, on ``device``
    (:func:`resolve_device`: ``None`` means the card).  Replication ``r``'s
    key chain is ``fold_in(PRNGKey(seed), r)``, the reference's."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    root = prng.PRNGKey(seed)
    keys = np.stack([prng.fold_in(root, r) for r in range(n_rep)]).reshape(n_rep, 2)
    return PolicyCarry(
        key=torch.from_numpy(keys),
        backlog_gamma=torch.zeros((n_rep, n_servers), **f32),
        backlog_eta=torch.zeros((n_rep, n_servers), **f32),
        ema_util=torch.zeros((n_rep, n_servers), **f32),
        bw_prev=torch.full((n_rep,), bandwidth_init, **f32),
        bw_cur=torch.full((n_rep,), bandwidth_init, **f32),
        link_bw=torch.ones((n_rep, n_servers), **f32),
        server_up=torch.ones((n_rep, n_servers), **f32),
    )


def _inflation(load, budget, slope, cfg: CongestionConfig):
    """``phi``: 1 at or below budget, then ``1 + slope * (rho - 1) ** power``
    capped at ``max_inflation``."""
    rho = load / budget.clamp_min(_EPS)
    over = (rho - 1.0).clamp_min(0.0)
    phi = 1.0 + slope * over ** cfg.power
    return phi.clamp_max(cfg.max_inflation)


def compute_inflation(load, budget, cfg: CongestionConfig):
    """(M,) processing-time inflation from committed+carried compute load."""
    return _inflation(load, budget, cfg.compute_slope, cfg)


def comm_inflation(load, budget, cfg: CongestionConfig):
    """(M,) transfer-time inflation from committed+carried comm load."""
    return _inflation(load, budget, cfg.comm_slope, cfg)


def step_backlog(backlog, committed, budget, cfg: CongestionConfig):
    """Next frame's carried backlog: ``max(0, b + w - g * drain)``."""
    return (backlog + committed - budget * cfg.drain).clamp_min(0.0)


def effective_capacity(budget, backlog):
    """The budget the scheduler sees: ``max(budget - backlog, 0)``."""
    return (budget - backlog).clamp_min(0.0)


def committed_loads(
    inst: FlatInstance, assign_j, assign_l
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-server work committed by one frame's assignment (or a batch).

    Returns ``(w, c)``: ``w[j]`` is the compute (``inst.v``) scheduled on
    server *j*, ``c[e]`` the communication (``inst.u``) charged against
    covering edge *e* by offloaded requests; dropped rows add nothing.

    The reference sums with a scatter-add, which adds in request order.
    This adds one request per step, in that order, so the float sums are
    the same on any device; a scatter-add on the card uses atomics and
    adds in no fixed order.
    """
    batched = assign_j.dim() > 1
    if not batched:
        inst = FlatInstance(**{f.name: getattr(inst, f.name)[None] for f in dataclasses.fields(inst)})
        assign_j, assign_l = assign_j[None], assign_l[None]
    B, N, M, L = inst.v.shape
    dev = inst.v.device
    rows = torch.arange(B, device=dev)
    w = torch.zeros((B, M), dtype=torch.float32, device=dev)
    c = torch.zeros((B, M), dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    for i in range(N):
        ji = assign_j[:, i].long()
        served = ji >= 0
        j = ji.clamp_min(0)
        flat = j * L + assign_l[:, i].long().clamp_min(0)
        v_pick = inst.v[:, i].reshape(B, M * L).gather(1, flat[:, None])[:, 0]
        u_pick = inst.u[:, i].reshape(B, M * L).gather(1, flat[:, None])[:, 0]
        s = inst.cover[:, i].long()
        offloaded = served & (ji != s)
        w[rows, j] = w[rows, j] + torch.where(served, v_pick, zero)
        c[rows, s] = c[rows, s] + torch.where(offloaded, u_pick, zero)
    if not batched:
        return w[0], c[0]
    return w, c


def ema_update(ema, committed, budget, cfg: CongestionConfig):
    """EMA of per-server committed utilization (``committed / budget``)."""
    util = committed / budget.clamp_min(_EPS)
    return (1.0 - cfg.ema_alpha) * ema + cfg.ema_alpha * util


def congested_ctime(inst: FlatInstance, tq, phi_c, phi_e) -> torch.Tensor:
    """Realized completion-time tensor under congestion:

    ``ct' = ctime + v * (phi_c[j] - 1) + comm * (phi_e[cover] - 1)`` with
    ``comm = ctime - v - tq``.  With ``phi == 1`` everywhere this is
    ``ctime`` bitwise.  ``inst`` leaves ``(..., N, M, L)``, ``tq``
    ``(..., N)``, ``phi_c``/``phi_e`` ``(..., M)``.
    """
    comm = inst.ctime - inst.v - tq[..., :, None, None]
    phi_e_cover = torch.gather(phi_e, -1, inst.cover.long())
    return (
        inst.ctime
        + inst.v * (phi_c[..., None, :, None] - 1.0)
        + comm * (phi_e_cover[..., :, None, None] - 1.0)
    )
