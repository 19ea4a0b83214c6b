"""Host span tracing — a thread-aware recorder emitting Chrome trace JSON.

The port's counterpart of ``repro.obs.trace``, name for name.  The recorder
is process-wide and explicitly installed (:func:`start_trace` /
:func:`recording`); until then every :class:`span` is inert:
``__enter__``/``__exit__`` cost two ``time.perf_counter()`` calls and one
``None`` check, nothing is allocated and no lock is taken.  The two
timestamps are kept even when tracing is off because the simulators build
their timing fields (``FleetResult.gen_s`` / ``dispatch_s``,
``SimResult.timings``) from the same spans through :class:`Stopwatch`.

Events carry the recording thread's id and name, so spans from
``simulate_fleet``'s producer thread ("fleet-window-producer",
"fleet-hier-producer") and the JSONL exporter ("telemetry-writer") land on
their own tracks in ``chrome://tracing`` / Perfetto.  The emitted JSON
object format is::

    {"traceEvents": [
        {"name": ..., "cat": ..., "ph": "X", "ts": us, "dur": us,
         "pid": <pid>, "tid": <tid>, "args": {...}},
        {"ph": "M", "name": "thread_name", ...},           # metadata
        {"ph": "i", "name": ..., "ts": us, "s": "t", ...}, # instants
     ],
     "displayTimeUnit": "ms"}

:func:`validate_chrome_trace` checks that shape.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = [
    "CAT_GEN",
    "CAT_BUILD",
    "CAT_SCHED",
    "CAT_DISPATCH",
    "CAT_METRICS",
    "CAT_IO",
    "CAT_COMPILE",
    "TraceRecorder",
    "span",
    "instant",
    "Stopwatch",
    "start_trace",
    "stop_trace",
    "recording",
    "active_recorder",
    "save_chrome_trace",
    "validate_chrome_trace",
]

#: span categories used across the pipeline (the reference's vocabulary)
CAT_GEN = "gen"            # arrival-trace generation / stream pulls
CAT_BUILD = "build"        # frame-grid / instance building (host)
CAT_SCHED = "sched"        # scheduler calls
CAT_DISPATCH = "dispatch"  # the fleet's window on the device, and the wait for it
CAT_METRICS = "metrics"    # window scoring / metric rows / member accounting
CAT_IO = "io"              # telemetry export (JSONL writer thread)
CAT_COMPILE = "compile"    # kernel library builds and loads, policy binding


class TraceRecorder:
    """Thread-safe in-memory event sink for one recording session.

    Timestamps are ``perf_counter`` microseconds relative to the recorder's
    creation, which is what Chrome's trace viewer expects of a
    single-process capture.
    """

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._thread_names: Dict[int, str] = {}

    # -- recording --------------------------------------------------------
    def _note_thread(self, tid: int) -> None:
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name

    def add_complete(
        self, name: str, cat: str, t_start: float, t_end: float,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One complete ("X") event from a pair of ``perf_counter`` readings."""
        tid = threading.get_ident()
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (t_start - self._t0) * 1e6,
            "dur": max(t_end - t_start, 0.0) * 1e6,
            "pid": os.getpid(),
            "tid": tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._note_thread(tid)
            self._events.append(ev)

    def add_instant(
        self, name: str, cat: str, args: Optional[Dict[str, Any]] = None
    ) -> None:
        """One instant ("i") event at the current time (thread-scoped)."""
        tid = threading.get_ident()
        ev = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._note_thread(tid)
            self._events.append(ev)

    # -- introspection ----------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def categories(self) -> set:
        return {e["cat"] for e in self.events() if e["ph"] != "M"}

    def thread_ids(self) -> set:
        return {e["tid"] for e in self.events()}

    def span_names(self) -> set:
        return {e["name"] for e in self.events() if e["ph"] == "X"}

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export -----------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (events + thread metadata)."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": os.getpid(),
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(names.items())
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


#: the process-wide recorder; ``None`` means tracing is off (the default)
_RECORDER: Optional[TraceRecorder] = None
_INSTALL_LOCK = threading.Lock()


def active_recorder() -> Optional[TraceRecorder]:
    return _RECORDER


def start_trace() -> TraceRecorder:
    """Install a fresh process-wide recorder (replacing any active one)."""
    global _RECORDER
    with _INSTALL_LOCK:
        _RECORDER = TraceRecorder()
        return _RECORDER


def stop_trace() -> Optional[TraceRecorder]:
    """Uninstall and return the active recorder (``None`` if none)."""
    global _RECORDER
    with _INSTALL_LOCK:
        rec, _RECORDER = _RECORDER, None
        return rec


@contextmanager
def recording():
    """``with recording() as rec: ...`` — record for the block's duration."""
    rec = start_trace()
    try:
        yield rec
    finally:
        with _INSTALL_LOCK:
            global _RECORDER
            if _RECORDER is rec:
                _RECORDER = None


class span:
    """Timed block: ``with span("fleet/dispatch", CAT_DISPATCH) as s: ...``.

    Always measures (``s.elapsed_s`` is valid after exit; with an ``acc``
    :class:`Stopwatch` the duration is added to its total under ``name``);
    records a trace event only when a process-wide recorder is active at
    ``__enter__``.  An exception inside the block still closes and records
    the span.
    """

    __slots__ = ("name", "cat", "args", "acc", "_t0", "_rec", "elapsed_s")

    def __init__(
        self,
        name: str,
        cat: str = CAT_SCHED,
        acc: Optional["Stopwatch"] = None,
        **args: Any,
    ) -> None:
        self.name = name
        self.cat = cat
        self.args = args or None
        self.acc = acc
        self.elapsed_s = 0.0

    def __enter__(self) -> "span":
        self._rec = _RECORDER  # snapshot: a recorder swapped mid-span stays sane
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        self.elapsed_s = t1 - self._t0
        if self.acc is not None:
            self.acc._add(self.name, self.elapsed_s)
        rec = self._rec
        if rec is not None:
            rec.add_complete(self.name, self.cat, self._t0, t1, self.args)


def instant(name: str, cat: str = CAT_COMPILE, **args: Any) -> None:
    """Record an instant event (a no-op when tracing is off)."""
    rec = _RECORDER
    if rec is not None:
        rec.add_instant(name, cat, args or None)


class Stopwatch:
    """Per-run accumulator of span durations, keyed by span name.

    ``simulate`` / ``simulate_fleet`` each create one and wire their spans
    through it (``sw.span(...)``), then read totals to fill their timing
    fields: the recorder and the result fields see the same
    ``perf_counter`` pairs, so tracing cannot skew the numbers.
    """

    __slots__ = ("totals",)

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    def _add(self, name: str, elapsed_s: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + elapsed_s

    def span(self, name: str, cat: str = CAT_SCHED, **args: Any) -> span:
        return span(name, cat, acc=self, **args)

    def total(self, *names: str) -> float:
        return sum(self.totals.get(n, 0.0) for n in names)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


def save_chrome_trace(recorder: TraceRecorder, path) -> None:
    recorder.save(path)


_VALID_PH = {"X", "i", "M", "B", "E", "C"}


def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema check of a Chrome trace-event JSON object; returns the list
    of violations (empty == valid).  Accepts the object form this module
    emits and the bare event-array form."""
    errors: List[str] = []
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level 'traceEvents' missing or not a list"]
    elif isinstance(obj, list):
        events = obj
    else:
        return ["trace is neither an object with 'traceEvents' nor an array"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"event {i}: bad or missing ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            errors.append(f"event {i}: missing pid/tid")
        if ph in ("X", "i"):
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"event {i}: missing ts")
            if not isinstance(ev.get("cat"), str):
                errors.append(f"event {i}: missing cat")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: X event needs dur >= 0")
    return errors
