"""Span timing for the port's runs — the reference's ``Stopwatch`` /
``span`` (``repro.obs.trace``), timing only.

``FleetResult.timings``, ``gen_s`` and ``dispatch_s`` are built from the
same ``perf_counter`` pairs as in the reference, so they keep their
meaning.  The Chrome-trace recorder is not ported yet (ROADMAP.md §1,
still to port: telemetry).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

__all__ = ["span", "Stopwatch"]


class span:
    """Timed block: ``with span("fleet/dispatch") as s: ...``.

    ``s.elapsed_s`` is valid after exit; with an ``acc`` Stopwatch the
    duration is added to its total under ``name``.  An exception inside the
    block still closes the span.
    """

    __slots__ = ("name", "acc", "_t0", "elapsed_s")

    def __init__(self, name: str, acc: Optional["Stopwatch"] = None) -> None:
        self.name = name
        self.acc = acc
        self.elapsed_s = 0.0

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.elapsed_s = time.perf_counter() - self._t0
        if self.acc is not None:
            self.acc._add(self.name, self.elapsed_s)


class Stopwatch:
    """Per-run accumulator of span durations, keyed by span name."""

    __slots__ = ("totals",)

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    def _add(self, name: str, elapsed_s: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + elapsed_s

    def span(self, name: str) -> span:
        return span(name, acc=self)

    def total(self, *names: str) -> float:
        return sum(self.totals.get(n, 0.0) for n in names)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
