"""Engine options — one frozen configuration object, one precedence order.

The port's counterpart of ``repro.core.options``.  :func:`resolve_options`
fills unset fields along the same order:

    **explicit argument  >  environment variable  >  scenario default
    >  built-in default**

Environment variables recognized (read at resolve time):

=====================  ============================  ===========================
field                  variable                      values
=====================  ============================  ===========================
``backend``            ``REPRO_TORCH_GUS_BACKEND``   ``torch`` | ``cuda``
``rng_mode``           ``REPRO_RNG_MODE``            ``paper-default`` | ``vectorized``
``scheduler``          ``REPRO_SCHEDULER``           ``dense`` | ``hierarchical``
=====================  ============================  ===========================

The backend variable is the port's own: the reference's
``REPRO_GUS_BACKEND`` takes ``xla``/``pallas``.  ``rng_mode`` and
``scheduler`` mean the same in both packages, so they share the names.
As in the reference, the backend's environment fallback is applied at GUS
dispatch (:func:`resolve_backend`).  With no explicit or environment
choice the backend follows the device: ``"cuda"`` (the kernel) for CUDA
tensors, ``"torch"`` (the plain loop) for CPU tensors.

``simulate`` and ``simulate_fleet`` raise ``NotImplementedError`` for the
fields they do not honour yet (:func:`check_ported`); ``simulate`` ignores
the fleet-only fields (``window``, ``prefetch``, ``devices``), as the
reference does, so one options value can drive both.  The reference's ``rep_group`` is a JAX device-mesh
setting and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import torch

__all__ = [
    "EngineOptions",
    "BACKENDS",
    "SCHEDULERS",
    "ENV_BACKEND",
    "ENV_MODEL_BACKEND",
    "ENV_RNG_MODE",
    "ENV_SCHEDULER",
    "resolve_options",
    "resolve_backend",
    "check_ported",
]

#: GUS implementations: the plain PyTorch loop and the Hopper kernel
BACKENDS = ("torch", "cuda")
SCHEDULERS = ("dense", "hierarchical")

ENV_BACKEND = "REPRO_TORCH_GUS_BACKEND"
#: the model kernels' backend (attention and SSD; ``torch`` | ``cuda``), resolved as GUS's
ENV_MODEL_BACKEND = "REPRO_TORCH_MODEL_BACKEND"
ENV_RNG_MODE = "REPRO_RNG_MODE"
ENV_SCHEDULER = "REPRO_SCHEDULER"


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Execution options of ``simulate`` and ``simulate_fleet``.

    Every field defaults to "unset" (``None``) where an environment or
    scenario default exists; :func:`resolve_options` fills those in.
    """

    #: GUS (or, hierarchical, class allocator) implementation (``"torch"``
    #: | ``"cuda"``); ``None`` defers to ``REPRO_TORCH_GUS_BACKEND`` at
    #: dispatch, else follows the device.
    backend: Optional[str] = None
    #: arrival-RNG draw discipline (``"paper-default"`` | ``"vectorized"``);
    #: ``None`` defers to ``REPRO_RNG_MODE``, then the scenario default.
    rng_mode: Optional[str] = None
    #: bounded-memory streaming arrivals; ``None`` defers to the scenario.
    streaming: Optional[bool] = None
    #: frames per fleet window (``None`` = all frames at once).
    window: Optional[int] = None
    #: producer-queue depth overlapping host builds with device compute.
    prefetch: int = 1
    #: devices for the replication axis (only ``None`` or 1 in this slice).
    devices: Optional[int] = None
    #: record the per-decision metric stream (``SimResult.metrics`` /
    #: ``FleetResult.metrics``); off changes no result field.
    metrics: bool = False
    #: engine scheduling layout (:data:`SCHEDULERS`); ``None`` defers to
    #: ``REPRO_SCHEDULER``, else ``"dense"``.
    scheduler: Optional[str] = None


def _env_choice(env: Mapping[str, str], var: str, allowed, what: str):
    """Read and validate an environment override, or return ``None``."""
    raw = env.get(var)
    if raw is None or raw == "":
        return None
    if raw not in allowed:
        raise ValueError(
            f"environment variable {var}={raw!r} is not a valid {what}; "
            f"expected one of {', '.join(allowed)}"
        )
    return raw


def resolve_backend(
    backend: Optional[str] = None,
    device: Optional[torch.device] = None,
    env: Optional[Mapping[str, str]] = None,
    var: str = ENV_BACKEND,
) -> str:
    """The GUS backend: explicit ``backend=`` > ``REPRO_TORCH_GUS_BACKEND``
    > the device's own (``"cuda"`` on a CUDA device, else ``"torch"``).

    The model kernels (attention, SSD) resolve theirs the same way from
    ``var=ENV_MODEL_BACKEND`` (``REPRO_TORCH_MODEL_BACKEND``)."""
    if env is None:
        env = os.environ
    what = "GUS backend" if var == ENV_BACKEND else "model-kernel backend"
    b = backend if backend is not None else _env_choice(env, var, BACKENDS, what)
    if b is None:
        b = "cuda" if device is not None and torch.device(device).type == "cuda" else "torch"
    if b not in BACKENDS:
        raise ValueError(f"unknown {what} {b!r}; expected one of {', '.join(BACKENDS)}")
    return b


def resolve_options(
    options: Optional[EngineOptions] = None,
    scenario=None,
    env: Optional[Mapping[str, str]] = None,
) -> EngineOptions:
    """Fill an :class:`EngineOptions`' unset fields along the precedence
    order **explicit > environment > scenario default > built-in default**.

    ``backend`` is validated here and resolved at dispatch.  ``prefetch``
    is clamped to ``>= 0``; ``window``/``devices`` must be ``None`` or
    ``>= 1``.  Idempotent on an already-resolved value.
    """
    if env is None:
        env = os.environ
    opts = options if options is not None else EngineOptions()
    if not isinstance(opts, EngineOptions):
        raise TypeError(f"options must be an EngineOptions, got {type(opts).__name__}")

    if opts.backend is not None:
        resolve_backend(opts.backend, env=env)

    rng_mode = opts.rng_mode
    if rng_mode is None:
        rng_mode = _env_choice(env, ENV_RNG_MODE, ("paper-default", "vectorized"), "rng_mode")
    if rng_mode is None:
        rng_mode = scenario.rng_mode if scenario is not None else "paper-default"
    from .scenarios import _resolve_rng_mode

    rng_mode = _resolve_rng_mode(rng_mode)

    streaming = opts.streaming
    if streaming is None:
        streaming = bool(scenario.streaming) if scenario is not None else False

    scheduler = opts.scheduler
    if scheduler is None:
        scheduler = _env_choice(env, ENV_SCHEDULER, SCHEDULERS, "scheduler") or "dense"
    if scheduler not in SCHEDULERS:
        raise ValueError(
            f"unknown scheduler {scheduler!r}; expected one of {', '.join(SCHEDULERS)}"
        )

    for field in ("window", "devices"):
        val = getattr(opts, field)
        if val is not None and int(val) < 1:
            raise ValueError(f"{field} must be >= 1 or None, got {val}")

    return dataclasses.replace(
        opts,
        rng_mode=rng_mode,
        streaming=bool(streaming),
        scheduler=scheduler,
        prefetch=max(0, int(opts.prefetch)),
    )


def check_ported(opts: EngineOptions, fleet: bool = True) -> None:
    """Raise ``NotImplementedError`` for a resolved option this slice does
    not run yet, naming the ``ROADMAP.md`` item that brings it.  ``fleet``:
    the caller is ``simulate_fleet`` (``simulate`` ignores ``devices``)."""
    if fleet and opts.devices not in (None, 1):
        raise NotImplementedError(
            f"devices={opts.devices}: the replication axis over several CUDA "
            "devices is not ported yet (ROADMAP.md §1 item 9, still to port: "
            "devices>1)"
        )
