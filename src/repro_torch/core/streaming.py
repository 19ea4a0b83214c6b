"""Streaming arrival engine — frame-by-frame arrivals with bounded memory.

A numpy copy of ``repro.core.streaming`` (the port imports nothing of the
reference package), op for op, so a (scenario, seed) pair streams the
reference's trace bit for bit in both ``rng_mode``s.

``Scenario.generate_arrivals`` materializes a replication's whole trace up
front.  An :class:`ArrivalStream` draws the same kind of thinned-Poisson
traffic online: memory is O(n_edge) — one pending arrival per edge in a heap
plus the current frame's buffer (and one numpy chunk per edge in
``"vectorized"`` mode) — whatever the horizon.

Determinism and chunking invariance: each edge draws from its own child
generator, spawned from ``numpy.random.SeedSequence(seed)``, in the
scenario's per-edge draw order.  Edges never share a generator, so *when*
arrivals are pulled cannot change *what* is drawn: draining the stream frame
by frame gives the same requests as draining it in one shot.  The stream
pops arrivals in global time order, so ``rid``s follow arrival order as on
the materialized path.

Usage::

    stream = ArrivalStream("sustained-overload", seed=0, n_edge=4,
                           n_services=3, cfg=cfg)
    while not stream.exhausted:
        frame = stream.take_until(t + cfg.frame_ms)   # bounded memory
"""
from __future__ import annotations

import heapq
import math
from typing import List, Optional, Union

import numpy as np

from repro_torch.obs.trace import CAT_GEN, span

from .scenarios import (
    Request,
    RequestColumns,
    Scenario,
    _resolve_rng_mode,
    edge_arrival_columns,
    get_scenario,
    iter_edge_arrival_chunks,
)

__all__ = [
    "ArrivalStream",
    "stream_trace",
    "stream_trace_columns",
    "max_frame_arrivals",
]


class _VecEdgeBuffer:
    """One edge's chunk-buffered vectorized arrival process.

    Wraps :func:`repro_torch.core.scenarios.iter_edge_arrival_chunks`; holds
    the current chunk's columns plus a cursor, so memory stays O(chunk)
    while the stream pops arrivals one at a time in time order.
    """

    __slots__ = ("_chunks", "_cols", "_pos")

    def __init__(self, scn, rng, edge, n_services, cfg, horizon_ms):
        self._chunks = iter_edge_arrival_chunks(
            scn, rng, edge, n_services, cfg, horizon_ms
        )
        self._cols = None
        self._pos = 0

    def peek_ms(self) -> Optional[float]:
        """Next arrival time, refilling from the chunk iterator; None at end."""
        while self._cols is None or self._pos >= self._cols[0].size:
            nxt = next(self._chunks, None)
            if nxt is None:
                return None
            self._cols = nxt
            self._pos = 0
        return float(self._cols[0][self._pos])

    def pop(self):
        """(t, service, A, C, size) of the arrival ``peek_ms`` looked at."""
        ts, svc, a, c, size = self._cols
        i = self._pos
        self._pos += 1
        return (
            float(ts[i]), int(svc[i]), float(a[i]), float(c[i]), float(size[i]),
        )


class ArrivalStream:
    """Online thinned-Poisson arrival generator for one replication.

    Memory is bounded: one lookahead arrival time per edge (a heap) plus
    whatever the caller pulls per frame — in vectorized mode, plus one numpy
    chunk per edge.
    """

    def __init__(
        self,
        scenario: Union[str, Scenario],
        seed: int,
        n_edge: int,
        n_services: int,
        cfg,
        horizon_ms: Optional[float] = None,
        rng_mode: Optional[str] = None,
    ):
        self.scenario = get_scenario(scenario)
        self.cfg = cfg
        self.n_services = n_services
        self.horizon_ms = cfg.horizon_ms if horizon_ms is None else horizon_ms
        self.rng_mode = _resolve_rng_mode(
            self.scenario.rng_mode if rng_mode is None else rng_mode
        )
        root = np.random.SeedSequence(seed)
        self._rngs = [np.random.default_rng(s) for s in root.spawn(n_edge)]
        self._heap: List[tuple] = []
        self._n_emitted = 0
        self._vec: Optional[List[_VecEdgeBuffer]] = None
        if self.rng_mode == "vectorized":
            self._vec = [
                _VecEdgeBuffer(
                    self.scenario, self._rngs[e], e, n_services, cfg, self.horizon_ms
                )
                for e in range(n_edge)
            ]
            for e, buf in enumerate(self._vec):
                t = buf.peek_ms()
                if t is not None:
                    heapq.heappush(self._heap, (t, e))
        else:
            for e in range(n_edge):
                t = self._next_accepted(e, 0.0)
                if t is not None:
                    heapq.heappush(self._heap, (t, e))

    @property
    def n_emitted(self) -> int:
        """Requests emitted so far (the next rid)."""
        return self._n_emitted

    @property
    def exhausted(self) -> bool:
        """True once every edge's process has run past the horizon."""
        return not self._heap

    def peek_ms(self) -> float:
        """Arrival time of the next pending request (inf when exhausted)."""
        return self._heap[0][0] if self._heap else math.inf

    def _next_accepted(self, edge: int, t: float) -> Optional[float]:
        """Next *accepted* arrival at ``edge`` strictly after ``t`` via
        thinning against ``rate_bound`` (the materialized generator's draw
        order), or ``None`` once the process passes the horizon."""
        rng = self._rngs[edge]
        rmax = float(self.scenario.rate_bound(edge, self.cfg))
        if rmax <= 0.0:
            return None
        while True:
            t += rng.exponential(1000.0 / rmax)
            if t >= self.horizon_ms:
                return None
            r_t = float(self.scenario.rate(edge, t, self.cfg))
            if r_t >= rmax or rng.random() < r_t / rmax:
                return t

    def take_until(self, t_ms: float) -> List[Request]:
        """Pop every arrival with ``arrival_ms < t_ms``, in arrival order."""
        cfg = self.cfg
        out: List[Request] = []
        while self._heap and self._heap[0][0] < t_ms:
            t, e = heapq.heappop(self._heap)
            if self._vec is not None:
                buf = self._vec[e]
                t, service, a, c, size = buf.pop()
                nxt = buf.peek_ms()
            else:
                rng = self._rngs[e]
                service = int(rng.integers(0, self.n_services))
                a, c = self.scenario.draw_qos(rng, cfg)
                size = float(rng.uniform(cfg.req_size_lo, cfg.req_size_hi))
                nxt = self._next_accepted(e, t)
            out.append(
                Request(
                    rid=self._n_emitted,
                    arrival_ms=t,
                    cover=e,
                    service=service,
                    A=a,
                    C=c,
                    size_bytes=size,
                )
            )
            self._n_emitted += 1
            if nxt is not None:
                heapq.heappush(self._heap, (nxt, e))
        return out


def stream_trace(
    scenario: Union[str, Scenario],
    seed: int,
    n_edge: int,
    n_services: int,
    cfg,
    rng_mode: Optional[str] = None,
) -> List[Request]:
    """Drain a fresh :class:`ArrivalStream` in one shot (the materialized
    view of the streaming process)."""
    with span("stream/drain_trace", CAT_GEN, seed=seed):
        stream = ArrivalStream(scenario, seed, n_edge, n_services, cfg, rng_mode=rng_mode)
        return stream.take_until(math.inf)


def stream_trace_columns(
    scenario: Union[str, Scenario],
    seed: int,
    n_edge: int,
    n_services: int,
    cfg,
) -> RequestColumns:
    """The vectorized stream's full trace as columns, without Request objects.

    The same values as ``stream_trace(..., rng_mode="vectorized")``: the
    same spawned per-edge generators drain the same chunk iterators, and the
    stable sort reproduces the heap's tie order (per-edge emission order).
    """
    with span("stream/trace_columns", CAT_GEN, seed=seed):
        scn = get_scenario(scenario)
        root = np.random.SeedSequence(seed)
        parts: List[RequestColumns] = []
        for e, ss in enumerate(root.spawn(n_edge)):
            rng = np.random.default_rng(ss)
            parts.extend(edge_arrival_columns(scn, rng, e, n_services, cfg, cfg.horizon_ms))
        return RequestColumns.concatenate(parts).sorted_by_arrival()


def max_frame_arrivals(
    scenario: Union[str, Scenario],
    seed: int,
    n_edge: int,
    n_services: int,
    cfg,
    n_frames: int,
    rng_mode: Optional[str] = None,
) -> int:
    """Largest per-frame arrival count of one replication, in bounded memory.

    A counting pre-pass over a *fresh* stream (determinism makes it draw the
    exact trace the caller streams afterwards): each frame's requests are
    drawn, counted and discarded.  The windowed fleet fixes its padding
    bucket with it, so every window shares one shape and the bucket equals
    the materialized path's.  In ``"vectorized"`` mode each edge's chunk
    iterator is histogrammed into per-frame counts directly.
    """
    with span("stream/count_prepass", CAT_GEN, seed=seed):
        scn = get_scenario(scenario)
        mode = _resolve_rng_mode(scn.rng_mode if rng_mode is None else rng_mode)
        if mode == "vectorized":
            counts = np.zeros(n_frames, np.int64)
            root = np.random.SeedSequence(seed)
            for e, ss in enumerate(root.spawn(n_edge)):
                rng = np.random.default_rng(ss)
                for ts, *_ in iter_edge_arrival_chunks(
                    scn, rng, e, n_services, cfg, cfg.horizon_ms
                ):
                    idx = np.minimum((ts // cfg.frame_ms).astype(np.int64), n_frames - 1)
                    np.add.at(counts, idx, 1)
            return int(counts.max()) if n_frames else 0
        stream = ArrivalStream(scenario, seed, n_edge, n_services, cfg, rng_mode=mode)
        mx = 0
        for tf in range(n_frames):
            mx = max(mx, len(stream.take_until((tf + 1) * cfg.frame_ms)))
        return mx
