"""Logical-axis sharding (MaxText-style) with a divisibility fallback, on
DTensor.

The port's counterpart of ``repro/sharding.py``.  Model code names the axes
of its tensors ("vocab", "heads", "ff", "experts", "batch", ...).  A rules
table maps each logical axis to mesh axes; at resolve time a mesh axis that
does not divide the dimension, or that an earlier dimension took, is
dropped (kv_heads = 4 on a model axis of 16 -> replicated), so the same
model code runs on every mesh.

:func:`resolve_spec` returns the reference's ``PartitionSpec`` entries as a
tuple (``None``, an axis name, or a tuple of names for a dimension on
several axes; trailing ``None`` trimmed), and :func:`placements_for` the
same layout as DTensor placements, one ``Shard(d)`` or ``Replicate()`` a
mesh dimension.  A dimension on several mesh axes is split in the order
they are named, the outer first, as ``PartitionSpec(("pod", "data"))``.

Activation constraints go through a thread-local context: outside
:func:`use_sharding` :func:`shard` returns its argument itself (every
single-device path), inside it redistributes a DTensor to the rules'
layout (an all-gather, reduce-scatter or all-reduce where the layout
changes).  :func:`use_sharding` also lets DTensor ops take plain tensors
(positions, masks) as replicated, which is what they are on every rank.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "DEFAULT_RULES",
    "resolve_spec",
    "shard",
    "use_sharding",
    "current_ctx",
    "spec_for_shape",
    "placements_for",
]

MeshAxes = Union[str, Tuple[str, ...], None]

# Logical axis -> mesh axis/axes.  "pod" composes with "data" for pure data
# parallelism across pods (only gradient and input collectives cross pods).
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "embed": None,            # d_model replicated (Megatron-style)
    "heads": "model",         # query heads
    "kv_heads": "model",      # falls back to replication when kv < mesh
    "head_dim": None,
    "ff": "model",
    "experts": "model",       # expert parallelism
    "expert_ff": None,
    "seq": None,              # no context parallelism in the baseline
    "kv_seq": None,
    "d_inner": "model",       # mamba inner channels
    "ssm_heads": "model",
    "ssm_headdim": None,      # fallback when ssm_heads cannot divide the mesh
    "state": None,
    "conv": None,
    "layers": None,           # the reference's stacked-layer axis
    "capacity": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, MeshAxes] = DEFAULT_RULES


_ctx = _Ctx()


def current_ctx():
    """``(mesh, rules)`` of the innermost :func:`use_sharding` on this
    thread (``(None, DEFAULT_RULES)`` outside one)."""
    return _ctx.mesh, _ctx.rules


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Within the block, :func:`shard` lays activations out on ``mesh``
    by ``rules`` (over :data:`DEFAULT_RULES`), and DTensor ops take plain
    tensors as replicated."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = (_ctx.mesh, _ctx.rules, disp._allow_implicit_replication)
    _ctx.mesh = mesh
    _ctx.rules = dict(DEFAULT_RULES, **(rules or {}))
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules, disp._allow_implicit_replication = prev


def _mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or any object with the
    reference mesh's ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_spec(
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    mesh,
    rules: Optional[Dict[str, MeshAxes]] = None,
) -> Tuple[MeshAxes, ...]:
    """Logical names -> the reference's ``PartitionSpec`` entries, dropping
    mesh axes that are absent, already used or do not divide the
    dimension."""
    rules = rules or _ctx.rules or DEFAULT_RULES
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes {tuple(logical)} differ in rank")
    sizes = _mesh_axes(mesh)
    out, used = [], set()
    for dim, name in zip(shape, logical):
        mapped = rules.get(name) if name else None
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        keep = []
        size_so_far = 1
        for a in axes:
            if a not in sizes or a in used:
                continue
            if dim % (size_so_far * sizes[a]) == 0:
                keep.append(a)
                size_so_far *= sizes[a]
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_for_shape(shape, logical, mesh=None, rules=None) -> Tuple[MeshAxes, ...]:
    """:func:`resolve_spec` on the context's mesh; ``()`` (replicated)
    outside :func:`use_sharding`."""
    mesh = mesh or _ctx.mesh
    if mesh is None:
        return ()
    return resolve_spec(shape, logical, mesh, rules)


def placements_for(shape, logical, mesh, rules=None):
    """The DTensor placements of :func:`resolve_spec`'s layout on ``mesh``
    (a ``DeviceMesh``): for each mesh dimension, ``Shard(d)`` for the
    tensor dimension ``d`` that names its axis, else ``Replicate()``.  The
    counterpart of the reference's ``named_sharding_for``."""
    from torch.distributed.tensor import Replicate, Shard

    spec = resolve_spec(shape, logical, mesh, rules)
    where = {}
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            where[a] = d
    return tuple(
        Shard(where[a]) if a in where else Replicate() for a in mesh.mesh_dim_names
    )


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay an activation out by its logical axes: ``x`` itself outside
    :func:`use_sharding` or when it is not a DTensor, else ``x``
    redistributed to the rules' placements."""
    mesh = _ctx.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = placements_for(tuple(x.shape), logical, x.device_mesh, _ctx.rules)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
