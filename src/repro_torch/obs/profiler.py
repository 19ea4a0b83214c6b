"""``torch.profiler`` hooks: the program's spans on the profiler's timeline.

The port's counterpart of ``repro.obs.profiler`` (which wraps
``jax.profiler``).  :func:`profile_trace` wraps a run in
``torch.profiler.profile`` — CPU activity, and CUDA activity (CUPTI: every
kernel of the process, the port's ``ctypes``-bound ones included) when the
run's device is CUDA — and exports a Chrome trace into ``log_dir``
(:data:`TRACE_FILE`, loadable in Perfetto and TensorBoard).

:func:`annotate` marks a region of the program: the scheduler call, each
fleet dispatch, and the serving path's engine, model layers and Mamba-2
passes (``serving/engine.py``, ``models/``).  :func:`step_annotation`
marks each fleet window.  Both are live whenever a ``torch.profiler``
profile records in the process, :func:`profile_trace`'s or any other (a
benchmark's): then the region is a host-side range of the profile
(``torch.profiler``'s fast record function), nested as the calls nest, on
the clock of the device events: each kernel's launch (the runtime call
that shares its correlation id) lies inside the ranges that launched it.
The range has no device-side copy (it is not a user-scope range), so a
trace's device time and busy intervals read the same with or without it.
Under :func:`profile_trace` on CUDA an NVTX range is pushed around it
too.  Keywords given to :func:`annotate` go into its trace
event's ``args``, as the reference's ``TraceAnnotation`` carries them into
its event's metadata (the profile records them where it records inputs:
``record_shapes``, which :func:`profile_trace` sets).

With no profile recording — the default — both helpers return one shared
``nullcontext`` instance after one flag check.  A host whose profiler
cannot start degrades to a warning, never an error: profiling is
observability, not a dependency.
"""
from __future__ import annotations

import os
import warnings
from contextlib import contextmanager, nullcontext

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["profile_trace", "annotate", "step_annotation", "profiling_active", "TRACE_FILE"]

#: the exported trace's file name inside ``log_dir``
TRACE_FILE = "profile.pt.trace.json"

#: whether :func:`profile_trace` on a CUDA device is recording (NVTX ranges too)
_NVTX = False
_NOOP = nullcontext()


def profiling_active() -> bool:
    """Whether a ``torch.profiler`` profile is recording in this process:
    the condition under which :func:`annotate` is live."""
    return _autograd_profiler._is_profiler_enabled


@contextmanager
def profile_trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/TRACE_FILE``.

    ``device`` is the run's device: CUDA activity is traced when it is a
    CUDA device (``None``: when CUDA is available).  ``log_dir`` of
    ``None``/empty yields without starting anything, so callers can thread
    an optional ``--profile DIR`` flag straight through.
    """
    global _NVTX
    if not log_dir:
        yield
        return
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities, record_shapes=True)
        prof.start()
    except Exception as e:  # no profiler backend on this host
        warnings.warn(f"torch profiler unavailable ({e}); running unprofiled")
        yield
        return
    _NVTX = cuda
    try:
        yield
    finally:
        _NVTX = False
        try:
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(str(log_dir), exist_ok=True)
            prof.export_chrome_trace(os.path.join(str(log_dir), TRACE_FILE))
        except Exception as e:
            warnings.warn(f"torch profiler stop failed ({e})")


class _Nvtx:
    """A range of the profile with an NVTX range around it."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str, rf) -> None:
        self.name = name
        self.rf = rf

    def __enter__(self):
        torch.cuda.nvtx.range_push(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.rf.__exit__(*exc)
        torch.cuda.nvtx.range_pop()


def _range(name: str, kwargs=None):
    rf = (_RecordFunctionFast(name, keyword_values=kwargs) if kwargs
          else _RecordFunctionFast(name))
    return _Nvtx(name, rf) if _NVTX else rf


def annotate(name: str, **kwargs):
    """A range ``name`` of the recording profile, its event's args holding
    ``kwargs``; the shared no-op when no profile records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _range(name, kwargs)


def step_annotation(name: str, step: int):
    """The range ``<name>#<step>`` of the recording profile, else the
    shared no-op — one per fleet window."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _range(f"{name}#{step}")
