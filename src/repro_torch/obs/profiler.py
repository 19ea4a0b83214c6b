"""``torch.profiler`` hooks — device-side profiling of the scheduler paths.

The port's counterpart of ``repro.obs.profiler`` (which wraps
``jax.profiler``).  :func:`profile_trace` wraps a run in
``torch.profiler.profile`` — CPU activity, and CUDA activity (CUPTI: every
kernel of the process, the port's ``ctypes``-bound ones included) when the
run's device is CUDA — and exports a Chrome trace into ``log_dir``
(:data:`TRACE_FILE`, loadable in Perfetto and TensorBoard).  Inside it,
:func:`annotate` marks host-dispatched regions (the scheduler call, each
fleet dispatch) with ``torch.profiler.record_function`` plus an NVTX range
when CUDA is present, and :func:`step_annotation` marks each fleet window.
Keywords given to :func:`annotate` go into its trace event's ``args``, as
the reference's ``TraceAnnotation`` carries them into its event's metadata
(the profile records inputs, ``record_shapes``, for that).

With no profile active — the default — both helpers return one shared
``nullcontext`` instance, so instrumented call sites cost a function call
and a flag check.  A host whose profiler cannot start degrades to a
warning, never an error: profiling is observability, not a dependency.
"""
from __future__ import annotations

import os
import warnings
from contextlib import contextmanager, nullcontext

import torch

__all__ = ["profile_trace", "annotate", "step_annotation", "profiling_active", "TRACE_FILE"]

#: the exported trace's file name inside ``log_dir``
TRACE_FILE = "profile.pt.trace.json"

_ACTIVE = False
_NVTX = False
_NOOP = nullcontext()


def profiling_active() -> bool:
    return _ACTIVE


@contextmanager
def profile_trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/TRACE_FILE``.

    ``device`` is the run's device: CUDA activity is traced when it is a
    CUDA device (``None``: when CUDA is available).  ``log_dir`` of
    ``None``/empty yields without starting anything, so callers can thread
    an optional ``--profile DIR`` flag straight through.
    """
    global _ACTIVE, _NVTX
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
    _ACTIVE, _NVTX = True, cuda
    try:
        yield
    finally:
        _ACTIVE = _NVTX = False
        try:
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(str(log_dir), exist_ok=True)
            prof.export_chrome_trace(os.path.join(str(log_dir), TRACE_FILE))
        except Exception as e:
            warnings.warn(f"torch profiler stop failed ({e})")


class _Range:
    """``record_function(name)``, with an NVTX range around it on CUDA;
    with keywords, a record function that carries them as its event's
    args."""

    __slots__ = ("name", "nvtx", "rf")

    def __init__(self, name: str, nvtx: bool, kwargs=None) -> None:
        self.name = name
        self.nvtx = nvtx
        if kwargs:
            from torch._C._profiler import _RecordFunctionFast

            self.rf = _RecordFunctionFast(name, keyword_values=kwargs)
        else:
            self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.rf.__exit__(*exc)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()


def annotate(name: str, **kwargs):
    """A ``record_function`` (+ NVTX) range under an active profile, its
    event's args holding ``kwargs``, else a no-op."""
    if not _ACTIVE:
        return _NOOP
    return _Range(name, _NVTX, kwargs)


def step_annotation(name: str, step: int):
    """The profiler step marker ``<name>#<step>`` under an active profile,
    else a no-op — one per fleet window."""
    if not _ACTIVE:
        return _NOOP
    return _Range(f"{name}#{step}", _NVTX)
