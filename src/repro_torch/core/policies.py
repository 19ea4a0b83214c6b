"""Policy registry — every scheduler behind one named interface.

The port's counterpart of ``repro.core.policies``, with the same eleven
policies in the same order and the same metadata:

* ``needs_key``    — the policy consumes a fresh PRNG key per frame
  (``random``); the simulators split the reference's threefry key chain
  (:mod:`.prng`, bit for bit).
* ``vmappable``    — the policy schedules a whole batch of padded frames in
  one call (everything except the host-side oracles and ``gus-hier``).
* ``pad``          — the policy honours the padding contract of
  :func:`~repro_torch.core.instance.pad_instance`.
* ``max_requests`` — hard per-frame size ceiling (ILP only).
* ``kind``         — ``"greedy"``, ``"baseline"``, ``"relaxed"`` or
  ``"oracle"``.
* ``stateful``     — the schedule function reads and returns the
  simulator-threaded :class:`~repro_torch.core.queueing.PolicyCarry`.

Where the reference ``vmap``s a single-frame function, a ``vmappable``
policy of the port takes the batch axis itself: its bound function maps a
*batch* of frames ``(B, N, M, L)`` (on any device) to an Assignment over
the batch — with ``(B, 2)`` keys when ``needs_key``, or a batched carry
when ``stateful``.  Every GUS-cored policy (``gus``, ``gus-ordered``,
``gus-adaptive``, the three restricted baselines and the Happy-* pair) is
the GUS kernel on a transformed frame.  The host policies (``ilp``,
``lp-bound``, ``gus-hier``: ``vmappable=False``) take one unpadded frame on
the CPU, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .aggregation import make_gus_hier
from .baselines import local_all, offload_all, random_assignment
from .extensions import gus_schedule_ordered
from .gus import Assignment, gus_schedule_batch
from .ilp import lagrangian_dual, price_directed_greedy, solve_bnb
from .instance import FlatInstance

__all__ = [
    "Policy",
    "POLICIES",
    "register_policy",
    "get_policy",
    "list_policies",
    "make_ilp_policy",
    "ILP_DEFAULT_MAX_REQUESTS",
    "ILP_DEFAULT_NODE_LIMIT",
]

ILP_DEFAULT_MAX_REQUESTS = 24
ILP_DEFAULT_NODE_LIMIT = 200_000


@dataclasses.dataclass(frozen=True)
class Policy:
    """One named scheduling policy (see module docstring for the fields)."""

    name: str
    description: str
    #: factory ``(n_edge, n_servers) -> schedule_fn``
    make: Callable[[int, int], Callable]
    needs_key: bool = False
    vmappable: bool = True
    pad: bool = True
    max_requests: Optional[int] = None
    kind: str = "baseline"
    #: the schedule fn is ``(batch, PolicyCarry) -> (Assignment,
    #: PolicyCarry)``; ``ema_util`` and ``key`` are policy-owned, the rest
    #: simulator-owned (overwritten after the call)
    stateful: bool = False

    def bind(self, n_edge: int, n_servers: int) -> Callable:
        """Close over the cluster shape; returns the per-frame schedule fn."""
        return self.make(n_edge, n_servers)


POLICIES: Dict[str, Policy] = {}


def register_policy(policy: Policy) -> Policy:
    """Register a :class:`Policy` under its ``name`` (last write wins)."""
    POLICIES[policy.name] = policy
    return policy


def get_policy(policy: Union[str, Policy]) -> Policy:
    """Resolve a policy by name (or pass a :class:`Policy` through)."""
    if isinstance(policy, Policy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise KeyError(
            f"unknown policy {policy!r}; registered: {', '.join(list_policies())}"
        ) from None


def list_policies() -> List[str]:
    """Registered policy names, in registration order (GUS first)."""
    return list(POLICIES)


def _empty() -> Assignment:
    z = torch.full((0,), -1, dtype=torch.int32)
    return Assignment(z, z)


def _make_ilp(
    n_edge: int,
    n_servers: int,
    *,
    max_requests: int = ILP_DEFAULT_MAX_REQUESTS,
    node_limit: int = ILP_DEFAULT_NODE_LIMIT,
    strict: bool = False,
) -> Callable[[FlatInstance], Assignment]:
    def schedule(inst: FlatInstance) -> Assignment:
        n = int(inst.A.shape[0])
        if n == 0:
            return _empty()
        if n > max_requests:
            raise ValueError(
                f"ilp policy refuses a {n}-request frame (max {max_requests}); "
                "shrink the frame (queue_cap / arrival rate) or use a greedy policy"
            )
        assign, _ = solve_bnb(inst, node_limit=node_limit, strict=strict)
        return assign

    return schedule


def make_ilp_policy(
    *,
    max_requests: int = ILP_DEFAULT_MAX_REQUESTS,
    node_limit: int = ILP_DEFAULT_NODE_LIMIT,
    strict: bool = False,
    name: str = "ilp",
) -> Policy:
    """An ILP-oracle :class:`Policy` with custom frame-size / search budgets
    (``strict=True`` raises instead of returning a best-so-far when the
    node budget trips, so "opt" is always a certified optimum)."""
    return Policy(
        name=name,
        description=f"exact MUS optimum via branch & bound (<= {max_requests} requests)",
        make=functools.partial(
            _make_ilp, max_requests=max_requests, node_limit=node_limit, strict=strict,
        ),
        vmappable=False,
        pad=False,
        max_requests=max_requests,
        kind="oracle",
    )


def _gus(batch, *, backend: Optional[str] = None, **relax):
    return gus_schedule_batch(batch, backend=backend, device=batch.device, **relax)


register_policy(Policy(
    name="gus",
    description="Algorithm 1 (GUS): greedy max-US in arrival order",
    make=lambda n_edge, n_servers: _gus,
    kind="greedy",
))

register_policy(Policy(
    name="gus-hier",
    description=(
        "GUS over QoS-class aggregates: bucket requests into classes, "
        "allocate class chunks, de-aggregate by request index"
    ),
    make=lambda n_edge, n_servers: make_gus_hier(),
    vmappable=False,
    pad=False,
    kind="greedy",
))

register_policy(Policy(
    name="gus-ordered",
    description="GUS processing requests by descending best-achievable US",
    make=lambda n_edge, n_servers: (
        lambda batch: gus_schedule_ordered(batch, device=batch.device)
    ),
    kind="greedy",
))


def _make_gus_adaptive(n_edge: int, n_servers: int):
    """GUS reading the carry: servers reported down (``carry.server_up``)
    are masked out of every request's candidate set, and a server whose EMA
    utilization runs over 1 gets its visible capacity shaded down
    proportionally, ``gamma / (1 + max(ema_util - 1, 0))`` in float32.  At
    the carry's init values both transforms are exact identities."""

    def schedule(batch: FlatInstance, carry):
        over = (carry.ema_util - 1.0).clamp_min(0.0)
        up = carry.server_up > 0.0
        shaded = dataclasses.replace(
            batch,
            gamma=batch.gamma / (1.0 + over),
            avail=batch.avail & up[:, None, :, None],
        )
        return _gus(shaded), carry

    return schedule


register_policy(Policy(
    name="gus-adaptive",
    description="GUS reading the carry: skips down servers, shades overloaded ones",
    make=_make_gus_adaptive,
    kind="greedy",
    stateful=True,
))


register_policy(Policy(
    name="random",
    description="baseline 1: one uniformly-random server per request",
    make=lambda n_edge, n_servers: (
        lambda batch, keys: random_assignment(batch, keys, device=batch.device)
    ),
    needs_key=True,
))

register_policy(Policy(
    name="offload_all",
    description="baseline 2: cloud servers only",
    make=lambda n_edge, n_servers: (
        lambda batch: offload_all(batch, np.arange(n_servers) >= n_edge, device=batch.device)
    ),
))

register_policy(Policy(
    name="local_all",
    description="baseline 3: the covering edge server only",
    make=lambda n_edge, n_servers: lambda batch: local_all(batch, device=batch.device),
))

register_policy(Policy(
    name="happy_computation",
    description="baseline 4: GUS with the computation constraint (2d) relaxed",
    make=lambda n_edge, n_servers: functools.partial(_gus, relax_compute=True),
    kind="relaxed",
))

register_policy(Policy(
    name="happy_communication",
    description="baseline 5: GUS with the communication constraint (2e) relaxed",
    make=lambda n_edge, n_servers: functools.partial(_gus, relax_comm=True),
    kind="relaxed",
))


def _make_lp_bound(
    n_edge: int, n_servers: int, *, n_iter: int = 60
) -> Callable[[FlatInstance], Assignment]:
    def schedule(inst: FlatInstance) -> Assignment:
        if int(inst.A.shape[0]) == 0:
            return _empty()
        _, lam, mu = lagrangian_dual(inst, n_iter=n_iter)
        return price_directed_greedy(inst, lam, mu)

    return schedule


register_policy(make_ilp_policy())

register_policy(Policy(
    name="lp-bound",
    description=(
        "LP-relaxation dual bound + price-directed greedy; scales past the "
        "ilp policy's frame-size refusal"
    ),
    make=_make_lp_bound,
    vmappable=False,
    pad=False,
    kind="oracle",
))
