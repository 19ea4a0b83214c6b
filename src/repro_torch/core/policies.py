"""Policy registry — schedulers behind one named interface.

The port's counterpart of ``repro.core.policies``.  A :class:`Policy` wraps
a factory ``(n_edge, n_servers) -> schedule_fn``; the fleet calls the bound
function on a *batch* of padded frames (one per replication) and it returns
an :class:`~repro_torch.core.gus.Assignment` over that batch.  Where the
reference ``vmap``s a single-frame function, the port's schedule functions
take the batch axis themselves.

Only ``gus`` is registered in this slice; the baselines, the Happy-*
relaxations as policies, the keyed and stateful policies and the ILP/LP
oracles are not ported yet (ROADMAP.md §1, still to port: remaining
policies).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

from .gus import gus_schedule_batch

__all__ = ["Policy", "POLICIES", "register_policy", "get_policy", "list_policies"]


@dataclasses.dataclass(frozen=True)
class Policy:
    """One named scheduling policy."""

    name: str
    description: str
    #: factory ``(n_edge, n_servers) -> schedule_fn``; the function maps a
    #: batched ``FlatInstance`` to an Assignment (``gus``'s also takes the
    #: fleet's ``backend=``)
    make: Callable[[int, int], Callable]

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
            f"unknown policy {policy!r}; registered: {', '.join(list_policies())} "
            "(the other policies are not ported yet: ROADMAP.md §1)"
        ) from None


def list_policies() -> List[str]:
    """Registered policy names, in registration order."""
    return list(POLICIES)


def _gus(batch, *, backend: Optional[str] = None):
    return gus_schedule_batch(batch, backend=backend, device=batch.device)


register_policy(Policy(
    name="gus",
    description="Algorithm 1 (GUS): greedy max-US in arrival order",
    make=lambda n_edge, n_servers: _gus,
))
