"""Checkpoints as npz files, in the reference's layout.

The port of ``repro/training/checkpoint.py``: one array per '/'-joined key
path plus ``__step__``, so a checkpoint written by either package restores
into the other.  The trees are the reference's: dicts by key, tuples (a
``TrainState``, an ``AdamWState``) by index.  The one difference of layout
is the port's, and it lives here: the port keeps a *list* of per-layer
dicts where the reference stacks every layer leaf on a leading axis, so a
list is written as the stacked leaves (``params/layers/attn/w_q`` of shape
``(L, ...)``) and read back layer by layer.  numpy has no bfloat16: a
bfloat16 leaf is written as float32 (exactly) and read back in the dtype
and on the device of the template's leaf.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Set

import numpy as np
import torch

from ..models.carry import to_numpy

__all__ = ["save_checkpoint", "restore_checkpoint", "tree_paths"]


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def tree_paths(tree) -> Dict[str, Any]:
    """'/'-joined path -> leaf, in the reference's layout (a list of
    per-layer trees becomes one stacked leaf per path)."""
    flat: Dict[str, Any] = {}

    def visit(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(_join(path, k), v)
        elif isinstance(node, list):
            per = [tree_paths(x) for x in node]
            for k in per[0]:
                flat[_join(path, k)] = torch.stack([torch.as_tensor(p[k]) for p in per])
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                visit(f"{path}/{i}", v)  # the reference's: "/0/..." at the top
        elif node is not None:
            flat[path] = node

    visit("", tree)
    return flat


def _keys(tree, path: str = "") -> Set[str]:
    """The paths :func:`tree_paths` would give, without stacking."""
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _keys(v, _join(path, k))}
    if isinstance(tree, list):
        return _keys(tree[0], path)
    if isinstance(tree, tuple):
        return {p for i, v in enumerate(tree) for p in _keys(v, f"{path}/{i}")}
    return set() if tree is None else {path}


def save_checkpoint(path: str, tree, step: int = 0) -> str:
    flat = {
        k: to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in tree_paths(tree).items()
    }
    flat["__step__"] = np.int64(step)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    return path


def restore_checkpoint(path: str, like):
    """Restore into the structure of ``like`` (a template tree): returns
    ``(tree, step)``.  Each leaf takes the dtype and device of ``like``'s
    leaf; a key of ``like`` missing from the file raises ``ValueError``."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        missing = _keys(like) - set(data.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

        loaded: Dict[str, np.ndarray] = {}

        def leaf(arr: np.ndarray, node):
            t = torch.from_numpy(np.array(arr))
            if isinstance(node, torch.Tensor):
                t = t.to(device=node.device, dtype=node.dtype)
            return t

        def rebuild(path: str, node, layer: Optional[int]):
            if isinstance(node, dict):
                return {k: rebuild(_join(path, k), v, layer) for k, v in node.items()}
            if isinstance(node, list):
                return [rebuild(path, v, i) for i, v in enumerate(node)]
            if isinstance(node, tuple):
                vals = [rebuild(f"{path}/{i}", v, layer) for i, v in enumerate(node)]
                return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
            if node is None:
                return None
            if path not in loaded:  # a stacked leaf is read once for all its layers
                loaded[path] = data[path]
            arr = loaded[path]
            return leaf(arr if layer is None else arr[layer], node)

        out = rebuild("", like, None)
        step = int(data["__step__"]) if "__step__" in data.files else 0
    return out, step
