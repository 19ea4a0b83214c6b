"""Async JSONL export — telemetry writes off the simulation's critical path.

The port's counterpart of ``repro.obs.export``, with one repair: a batch
that fails to serialize after taking the stop marker with it ends the
thread instead of waiting for a second marker that never comes (the
reference's writer hangs its ``close()`` there).

:class:`AsyncJsonlWriter` drains a bounded queue on its own thread
("telemetry-writer") and serializes rows in batches, emitting
``CAT_IO`` spans for each flush — so in a recorded run the export work
is visible on its own track instead of silently inflating the frame
loop.  ``close()`` drains the queue, joins the thread, and re-raises any
writer-side exception, so a full trace always contains every row that
was handed over (and the recorder sees every io span before the trace is
saved).
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Optional

from .trace import CAT_IO, span

__all__ = ["AsyncJsonlWriter"]

_STOP = object()


class AsyncJsonlWriter:
    """Background JSONL writer: ``write(obj)`` enqueues, a daemon thread
    serializes and appends.  Use as a context manager or call ``close()``."""

    def __init__(self, path, maxsize: int = 1024, batch: int = 64) -> None:
        self.path = str(path)
        self.n_written = 0
        self._batch = max(1, int(batch))
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=maxsize)
        self._error: Optional[BaseException] = None
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self._thread = threading.Thread(
            target=self._run, name="telemetry-writer", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        done = False
        try:
            with open(self.path, "w") as f:
                while not done:
                    items = [self._q.get()]
                    while len(items) < self._batch:
                        try:
                            items.append(self._q.get_nowait())
                        except queue.Empty:
                            break
                    if items[-1] is _STOP:
                        done = True
                        items.pop()
                    if not items:
                        continue
                    with span("telemetry/jsonl_flush", CAT_IO, rows=len(items)):
                        f.write("".join(json.dumps(o) + "\n" for o in items))
                        self.n_written += len(items)
        except BaseException as e:  # surfaced by close()
            self._error = e
            # keep draining so producers blocked on a full queue unwind,
            # unless the stop marker came in the batch that failed
            while not done:
                done = self._q.get() is _STOP

    def write(self, obj: Any) -> None:
        if self._error is not None:
            raise self._error
        self._q.put(obj)

    def close(self) -> None:
        self._q.put(_STOP)
        self._thread.join()
        if self._error is not None:
            raise self._error

    def __enter__(self) -> "AsyncJsonlWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
