"""The device trace of a ``--trace 1`` run, from ``torch.profiler``.

The traced window is the benchmark's own span ``bench/window`` around the
closed loop; each batch is a span ``bench/batch``.  A :class:`TraceSummary`
keeps every device operation inside the window (its name, start and
length), the seconds in which one ran (the union of their intervals), and
the idle gaps between them, each named by what the host was doing at the
gap's middle.  :class:`Tracer` records the window and reduces its events
with :func:`.spans.summarize`, the one reduction, which also splits the
window by the program's spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceSummary", "Tracer", "union_busy", "HOST_ONLY"]

WINDOW_SPAN, BATCH_SPAN = "bench/window", "bench/batch"
HOST_ONLY = "host (between ops)"
#: entries of each list of ``breakdown``, and the characters kept of a name
TOP, NAME = 10, 160


@dataclasses.dataclass
class TraceSummary:
    #: device operations in the window: (name, start s from the window's
    #: start, seconds), in order of start
    ops: List[Tuple[str, float, float]]
    window_s: float
    busy_s: float
    #: device seconds by operation name, and idle seconds by what the host
    #: was doing, each sorted from the largest
    op_seconds: List[Tuple[str, float]]
    idle_seconds: List[Tuple[str, float]]

    def kernels(self, *needles: str) -> List[Tuple[str, float, float]]:
        """The operations whose name holds one of ``needles``."""
        return [o for o in self.ops if any(n in o[0] for n in needles)]

    @property
    def launches(self) -> int:
        """Kernels launched in the window (copies and fills left out)."""
        return sum(1 for o in self.ops if not o[0].startswith(("Memcpy", "Memset")))

    def breakdown(self) -> Dict[str, list]:
        return {"device_ops": [[n[:NAME], s] for n, s in self.op_seconds[:TOP]],
                "idle_gaps": [[n, s] for n, s in self.idle_seconds[:TOP]]}


def union_busy(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(seconds covered, the merged intervals) of (start, end) pairs."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


class Tracer:
    """``torch.profiler`` over the window when ``on``; spans either way
    (``record_function`` costs next to nothing with no profile open).
    After :meth:`summary`, :attr:`spans` holds the window's
    :class:`.spans.SpanSummary`."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self.spans = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.on:
            yield
            return
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):  # each batch ends in a copy to the host
                yield
        self._prof = prof

    @staticmethod
    def batch():
        from torch.profiler import record_function

        return record_function(BATCH_SPAN)

    def summary(self) -> Optional[TraceSummary]:
        """The window's trace (``None`` unless traced); sets :attr:`spans`."""
        if self._prof is None:
            return None
        import torch

        from .spans import summarize

        cuda = torch.autograd.DeviceType.CUDA
        device, host, window, thread = [], [], None, None
        for e in self._prof.profiler.kineto_results.events():
            a, n, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() == cuda:
                device.append((name, a, a + n, e.correlation_id(), e.is_user_annotation()))
                continue
            host.append((name, a, a + n, e.correlation_id(), e.start_thread_id()))
            if name == WINDOW_SPAN:
                window, thread = (a, a + n), e.start_thread_id()
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        base = window[0]  # seconds from the window's start, taken from integer ns

        def s(ns):
            return (ns - base) * 1e-9

        trace, self.spans = summarize(
            [(n, s(a), s(b), c, u) for n, a, b, c, u in device],
            [(n, s(a), s(b), c) for n, a, b, c, t in host if t == thread],
            (0.0, s(window[1])))
        return trace
