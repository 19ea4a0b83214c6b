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

``simulate`` ignores the fleet-only fields (``window``, ``prefetch``,
``devices``, ``rep_group``), as the reference does, so one options value
can drive both.  One default differs from the reference's:
``rep_group=None`` cuts the replication axis into one group a device
(``ceil(n_rep / devices)``), where the reference cuts groups of
``FLEET_REP_GROUP = 8`` (``core/simulator.py``).  A width of 8 keeps XLA's
compile cache to one program; the port compiles nothing per shape, and
the results do not depend on the width, so ``rep_group=8`` gives the
reference's layout and the default gives one launch a device.
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
    #: devices for the fleet's replication axis (``None`` = every local
    #: device of the run's device type, at most ``n_rep``).
    devices: Optional[int] = None
    #: replication-group width, the unit of device dispatch (``None`` = one
    #: group a device; the reference's default is ``FLEET_REP_GROUP``).
    rep_group: Optional[int] = None
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
    is clamped to ``>= 0``; ``window``/``devices``/``rep_group`` must be
    ``None`` or ``>= 1`` (the simulator adds the checks that depend on the
    run: the visible devices, and a ``rep_group`` above ``n_rep`` is
    clamped to it).  Idempotent on an already-resolved value.
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

    for field in ("window", "devices", "rep_group"):
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

