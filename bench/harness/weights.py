"""The benchmark's weights, made on the device from the seed.

The weights are inputs that the benchmark makes and hands to both sides:
the program reads them in its parameter layout (nested dicts, one dict a
layer), the plain reference reads the same tensors.  They are drawn in the
type they are served in, into one flat buffer, by a few large calls on a
``torch.Generator`` on the device, then scaled leaf by leaf in place.

Scales: the embedding N(0, 0.02) (with tied embeddings also the
unembedding); every projection N(0, 1/fan_in) with
fan_in its input width (q, k and v at fan-in d_model, not the program's
own initializer's fan-in of H or KV, which makes every softmax at full
width nearly one-hot and a logits comparison ill-conditioned); norm
scales one; the Mamba-2 leaves as the published initializer draws them
(A in [1, 16), dt log-uniform in [1e-3, 1e-1] behind an inverse softplus,
conv taps N(0, 0.2), D one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from .manifest import family
from .seeds import derive

__all__ = ["Leaf", "proj", "layout", "make_weights", "leaves"]

#: elements drawn by one call
_CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    kind: str = "normal"     # normal | ones | zeros | a_log | dt_bias
    scale: float = 1.0


def proj(fan_in: int, *shape: int) -> Leaf:
    """A projection's weight, N(0, 1/fan_in)."""
    return Leaf(tuple(shape), "normal", 1.0 / math.sqrt(fan_in))


def layout(c: dict) -> Dict[str, Any]:
    """The parameter tree of configuration ``c`` (a configuration file's
    dict) in the program's layout, as :class:`Leaf` declarations: the
    embedding, the final norm and the unembedding, then the family's part
    (``bench/families/<family>.py``'s ``layout``)."""
    d, V = c["d_model"], c["vocab_size"]
    tree: Dict[str, Any] = {
        "embed": Leaf((V, d), "normal", 0.02),
        "ln_f": {"scale": Leaf((d,), "ones")},
    }
    if not c["tie_embeddings"]:
        tree["lm_head"] = proj(d, d, V)
    tree.update(family(c).model.layout(c))
    return tree


def leaves(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaves(v, prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def make_weights(c: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, Any]:
    """Configuration ``c``'s weights for run seed ``seed`` on ``device``
    in ``dtype``; the same tensors for the same seed on the same device."""
    device = torch.device(device)
    tree = layout(c)
    pairs = leaves(tree)
    out = _skeleton(tree)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    normal = [(p, l) for p, l in pairs if l.kind == "normal"]
    flat = torch.empty(sum(math.prod(l.shape) for _, l in normal), dtype=dtype, device=device)
    for part in flat.split(_CHUNK):
        part.normal_(generator=g)
    at = 0
    for path, leaf in normal:
        n = math.prod(leaf.shape)
        t = flat[at:at + n].view(leaf.shape)
        t.mul_(leaf.scale)
        _set(out, path, t)
        at += n
    for kind in ("a_log", "dt_bias"):
        group = [(p, l) for p, l in pairs if l.kind == kind]
        if not group:
            continue
        u = torch.rand(sum(math.prod(l.shape) for _, l in group), generator=g,
                       dtype=torch.float32, device=device)
        if kind == "a_log":
            v = torch.log(u * 15.0 + 1.0)
        else:
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            v = dt + torch.log(-torch.expm1(-dt))
        v = v.to(dtype)
        at = 0
        for path, leaf in group:
            n = math.prod(leaf.shape)
            _set(out, path, v[at:at + n].view(leaf.shape))
            at += n
    for path, leaf in pairs:
        if leaf.kind in ("ones", "zeros"):
            fill = torch.ones if leaf.kind == "ones" else torch.zeros
            _set(out, path, fill(leaf.shape, dtype=dtype, device=device))
    return out
