"""Process-wide integer counters of the serving path and the model kernels.

Always on: an :func:`add` is one dict update under a lock.  A reader takes
:func:`snapshot` before and after the work it watches and subtracts
(:func:`delta`); the counts themselves only grow.  The names:

* ``serve.batches`` and ``serve.prompt_tokens``: one and B * S for each
  ``ServingEngine.generate`` call (``serving/engine.py``);
* ``kernel.launches.<kernel>.<route>``: one for each call of a model
  kernel's wrapper, counted where it launches (``kernels/flash_attention.py``,
  ``kernels/ssd_scan.py``, ``kernels/decode_attention.py``,
  ``kernels/causal_conv.py``): the route it launched on the card
  (:data:`ROUTES`), or ``plain`` where the wrapper ran its plain version
  (CPU tensors, or the ``torch`` backend).  The Mamba-2 causal conv's plain
  version is the model's own expression (the reference's conv had no
  kernel), so ``causal_conv`` counts only its launches, never ``plain``.
  A call that launches nothing (an empty batch) counts nothing;
* ``kernel.builds``: one for each kernel library ``nvcc`` builds
  (``kernels/build.py``).

Importable by path (``repro_torch.obs.counters``); not one of
``repro_torch.obs``'s exported names, which are the reference's.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["ROUTES", "add", "snapshot", "delta", "launch_names", "launches", "routes"]

#: each model kernel's routes on the card, as its launch counters name them
ROUTES = {"flash_attention": ("wgmma", "simt"), "ssd": ("wgmma", "simt"),
          "decode_attention": ("cuda",), "causal_conv": ("cuda",)}

_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}


def add(name: str, n: int = 1) -> None:
    """Count ``n`` more under ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def snapshot() -> Dict[str, int]:
    """Every count so far."""
    with _LOCK:
        return dict(_COUNTS)


def delta(before: Dict[str, int], after: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The counts that grew between two snapshots (``after``: now)."""
    after = snapshot() if after is None else after
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def launch_names(kernel: str) -> Dict[str, str]:
    """route -> counter name of ``kernel``'s launches, ``plain`` included."""
    return {r: f"kernel.launches.{kernel}.{r}" for r in ROUTES[kernel] + ("plain",)}


def routes(kernel: str, since: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """route -> launches of ``kernel`` on the card since the snapshot
    ``since`` (``None``: since the process started)."""
    now, since = snapshot(), since or {}
    return {r: now.get(n, 0) - since.get(n, 0)
            for r, n in launch_names(kernel).items() if r != "plain"}


def launches(kernel: str, since: Optional[Dict[str, int]] = None,
             route: Optional[str] = None) -> int:
    """Launches of ``kernel`` since the snapshot ``since`` (``None``: since
    the process started) on ``route`` where given (``"plain"``: calls that
    ran the plain version), else on all its card routes."""
    if route is None:
        return sum(routes(kernel, since).values())
    name, since = launch_names(kernel)[route], since or {}
    return snapshot().get(name, 0) - since.get(name, 0)
