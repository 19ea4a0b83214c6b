"""Scenario engine — named workload scenarios, copied from the reference.

A pure numpy copy of ``repro.core.scenarios`` (the port imports nothing of
the reference package): the same registry, the same :class:`Request` /
:class:`RequestColumns` traces, and the same RNG consumption in both modes,
so a (scenario, seed) pair draws the reference's trace bit for bit.

A :class:`Scenario` shapes three per-frame streams consumed by
``repro_torch.core.simulator``:

* **arrivals** — a (possibly time- and edge-varying) Poisson process, drawn
  by :meth:`Scenario.generate_arrivals` via thinning against the scenario's
  instantaneous rate :meth:`Scenario.rate`;
* **QoS** — per-request accuracy floor A_i and deadline C_i from
  :meth:`Scenario.draw_qos`;
* **capacity** — a per-frame multiplier in [0, 1] on every server's
  (gamma, eta) frame budgets from :meth:`Scenario.capacity_scale`.

Two RNG modes generate that traffic (``Scenario.rng_mode``, overridable per
call):

* ``"paper-default"`` — the per-request Python loop: one exponential gap,
  one thinning draw, one QoS draw at a time (the frozen draw order);
* ``"vectorized"`` — batched generation in numpy chunks (:data:`VEC_CHUNK`
  gaps at a time per edge): the same process in a different draw order,
  columnar (:class:`RequestColumns`) end to end.

The registry is the reference's whole registry, the three streaming
scenarios (``sustained-overload``, ``diurnal-week``, ``mega-city``)
included; their bounded-memory arrival engine is
:mod:`repro_torch.core.streaming`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Request",
    "RequestColumns",
    "Scenario",
    "PaperDefaultScenario",
    "DiurnalScenario",
    "FlashCrowdScenario",
    "MobilityScenario",
    "HeteroTiersScenario",
    "SustainedOverloadScenario",
    "DiurnalWeekScenario",
    "OutageScenario",
    "FlashCrowdOutageScenario",
    "MegaCityScenario",
    "SCENARIOS",
    "RNG_MODES",
    "VEC_CHUNK",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
    "bucket_arrivals",
    "bucket_columns",
]

#: the two arrival-RNG modes; see the module docstring
RNG_MODES = ("paper-default", "vectorized")

#: cap on exponential gaps drawn per numpy batch in ``rng_mode="vectorized"``.
#: Each chunk's actual size is the deterministic estimate
#: ``min(VEC_CHUNK, mean_remaining + 6*sqrt(mean_remaining+1) + 16)`` (>= 32),
#: a function of the process's current time only — so the draw order (and
#: therefore the trace) depends only on (scenario, seed, edge), never on how
#: the caller pulls arrivals.  Cap and formula are part of the vectorized
#: trace's definition: changing either changes every vectorized trace.
VEC_CHUNK = 512


def _resolve_rng_mode(mode) -> str:
    if mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {mode!r}; expected one of {RNG_MODES}")
    return mode


@dataclasses.dataclass
class Request:
    """One user request as the testbed sees it (shared with the simulator)."""

    rid: int
    arrival_ms: float
    cover: int          # covering edge server at submission time
    service: int        # requested service k_i
    A: float            # accuracy floor (%)
    C: float            # deadline (ms)
    size_bytes: float   # payload shipped off the covering edge when offloading


@dataclasses.dataclass
class RequestColumns:
    """Columnar arrival trace — the struct-of-arrays twin of ``List[Request]``.

    The vectorized generator emits this so the fleet's grid-building code
    (``repro_torch.core.simulator._build_frame_batch``) can fill whole frames with
    array slices instead of per-request Python attribute reads.  Arrays are
    parallel, sorted by ``arrival_ms``; float columns stay float64 (the RNG's
    native width) and are narrowed to float32 exactly where the per-request
    path narrows its Python floats, so columnar and object traces built from
    the same draws produce bit-identical instance tensors.
    """

    arrival_ms: np.ndarray   # (N,) float64
    cover: np.ndarray        # (N,) int64
    service: np.ndarray      # (N,) int64
    A: np.ndarray            # (N,) float64
    C: np.ndarray            # (N,) float64
    size_bytes: np.ndarray   # (N,) float64

    def __len__(self) -> int:
        return int(self.arrival_ms.shape[0])

    def __bool__(self) -> bool:  # empty frames must be falsy, like an empty list
        return len(self) > 0

    def slice(self, lo: int, hi: int) -> "RequestColumns":
        """View of rows [lo, hi) (no copy)."""
        return RequestColumns(
            arrival_ms=self.arrival_ms[lo:hi],
            cover=self.cover[lo:hi],
            service=self.service[lo:hi],
            A=self.A[lo:hi],
            C=self.C[lo:hi],
            size_bytes=self.size_bytes[lo:hi],
        )

    def to_requests(self, rid0: int = 0) -> List[Request]:
        """Materialize :class:`Request` objects (rids ``rid0..rid0+N-1``).

        ``tolist()`` converts each column to Python natives in one C pass —
        an order of magnitude faster than per-element numpy scalar reads.
        """
        rows = zip(
            self.arrival_ms.tolist(),
            self.cover.tolist(),
            self.service.tolist(),
            self.A.tolist(),
            self.C.tolist(),
            self.size_bytes.tolist(),
        )
        return [
            Request(rid0 + i, t, cov, svc, a, c, size)
            for i, (t, cov, svc, a, c, size) in enumerate(rows)
        ]

    @staticmethod
    def concatenate(parts: Sequence["RequestColumns"]) -> "RequestColumns":
        if not parts:
            return _empty_columns()
        return RequestColumns(
            arrival_ms=np.concatenate([p.arrival_ms for p in parts]),
            cover=np.concatenate([p.cover for p in parts]),
            service=np.concatenate([p.service for p in parts]),
            A=np.concatenate([p.A for p in parts]),
            C=np.concatenate([p.C for p in parts]),
            size_bytes=np.concatenate([p.size_bytes for p in parts]),
        )

    def sorted_by_arrival(self) -> "RequestColumns":
        """Stable-sorted by arrival time (ties keep per-edge emission order,
        matching the per-request path's ``list.sort``)."""
        order = np.argsort(self.arrival_ms, kind="stable")
        return RequestColumns(
            arrival_ms=self.arrival_ms[order],
            cover=self.cover[order],
            service=self.service[order],
            A=self.A[order],
            C=self.C[order],
            size_bytes=self.size_bytes[order],
        )


def _empty_columns() -> RequestColumns:
    z = np.zeros(0, np.float64)
    return RequestColumns(
        arrival_ms=z,
        cover=np.zeros(0, np.int64),
        service=np.zeros(0, np.int64),
        A=z.copy(),
        C=z.copy(),
        size_bytes=z.copy(),
    )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Base scenario: the paper's homogeneous Poisson workload.

    Subclasses override any of :meth:`rate`, :meth:`rate_bound`,
    :meth:`draw_qos`, :meth:`capacity_scale`, or :attr:`move_prob` — the
    arrival generator, simulator, and fleet runner consume only this
    interface.
    """

    name: str = "paper-default"
    description: str = "Sec. IV workload: homogeneous Poisson, fixed QoS draw"
    #: per-frame probability that a user re-attaches to a random edge;
    #: ``None`` defers to ``SimConfig.move_prob``.
    move_prob: Optional[float] = None
    #: when True the simulator defaults to the bounded-memory streaming
    #: arrival engine (:mod:`repro_torch.core.streaming`) instead of
    #: materializing the full trace — the mode for long-horizon /
    #: nonstationary workloads.  ``EngineOptions(streaming=...)`` overrides
    #: per run.
    streaming: bool = False
    #: default arrival-RNG mode (:data:`RNG_MODES`): ``"paper-default"`` is
    #: the frozen per-request draw order, ``"vectorized"`` the batched
    #: generator (~10x faster, different draw order — opt in).  Overridable
    #: per call via ``simulate(..., rng_mode=...)`` and friends.
    rng_mode: str = "paper-default"
    #: whether the scenario is sized for the dense per-request sweeps in
    #: ``benchmarks/`` (every-policy x every-scenario matrices).  City-scale
    #: workloads built for the hierarchical fleet path set this False; they
    #: are exercised by the mega-city smoke and ``fleet_scale --users-sweep``
    #: instead.
    dense_sweep: bool = True

    # -- arrival process ----------------------------------------------------
    def rate(self, edge: int, t_ms: float, cfg) -> float:
        """Instantaneous arrival rate (requests/s) at ``edge`` at time ``t_ms``."""
        return cfg.arrival_rate_per_s

    def rate_bound(self, edge: int, cfg) -> float:
        """Upper bound on :meth:`rate` over the horizon (thinning envelope).

        Must satisfy ``rate(edge, t, cfg) <= rate_bound(edge, cfg)`` for all t.
        """
        return cfg.arrival_rate_per_s

    def rate_batch(self, edge: int, t_ms: np.ndarray, cfg) -> np.ndarray:
        """Vectorized :meth:`rate` over an array of times (thinning hot path).

        Registered time-varying scenarios override this with true numpy
        expressions.  The default covers the two safe cases: a scenario that
        never overrode :meth:`rate` is constant-rate (broadcast), and one
        that overrode :meth:`rate` but not this method falls back to an
        elementwise loop — slower, but never silently wrong.
        """
        t = np.asarray(t_ms, np.float64)
        if type(self).rate is Scenario.rate:
            return np.full(t.shape, float(self.rate(edge, 0.0, cfg)))
        return np.fromiter(
            (float(self.rate(edge, float(x), cfg)) for x in t), np.float64, t.size
        )

    # -- QoS draw -----------------------------------------------------------
    def draw_qos(self, rng: np.random.Generator, cfg) -> Tuple[float, float]:
        """Draw one request's (A_i, C_i).  Paper default: A ~ N(mean, std)
        clipped to [1, 99], C fixed."""
        a = float(np.clip(rng.normal(cfg.acc_req_mean, cfg.acc_req_std), 1, 99))
        return a, float(cfg.delay_req_ms)

    def draw_qos_batch(
        self, rng: np.random.Generator, cfg, n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw ``n`` requests' (A, C) arrays in one batch (vectorized mode).

        Subclasses that override :meth:`draw_qos` should override this too;
        until they do, the default detects the scalar override and loops it,
        so the vectorized mode stays distributionally faithful for any
        third-party scenario at reduced speed.
        """
        if (
            type(self).draw_qos is not Scenario.draw_qos
            and type(self).draw_qos_batch is Scenario.draw_qos_batch
        ):
            pairs = [self.draw_qos(rng, cfg) for _ in range(n)]
            a = np.array([p[0] for p in pairs], np.float64)
            c = np.array([p[1] for p in pairs], np.float64)
            return a, c
        a = np.clip(rng.normal(cfg.acc_req_mean, cfg.acc_req_std, n), 1.0, 99.0)
        return a, np.full(n, float(cfg.delay_req_ms))

    # -- capacity stream ----------------------------------------------------
    def capacity_scale(
        self, frame_start_ms: float, cfg, n_edge: int, n_servers: int
    ) -> Optional[np.ndarray]:
        """(M,) multiplier in [0, 1] applied to each server's per-frame
        (gamma, eta) budgets, or ``None`` for "no scaling" (all ones)."""
        return None

    def capacity_scale_batch(
        self, frame_starts_ms: np.ndarray, cfg, n_edge: int, n_servers: int
    ) -> Optional[np.ndarray]:
        """Vectorized :meth:`capacity_scale` over a window of frame starts.

        Returns ``(F, M)`` multipliers, or ``None`` when no frame in the
        window is scaled.  Unscaled frames carry rows of exact ``1.0``; the
        budgets are float64 and ``x * 1.0`` is the identity there, so a
        batched window is bit-identical to per-frame scalar calls.

        Like :meth:`rate_batch`, the default covers the two safe cases: a
        scenario that never overrode :meth:`capacity_scale` has a constant
        all-ones stream (return ``None`` without touching the frames), and
        one that overrode the scalar hook but not this method falls back to
        an elementwise loop — slower, but never silently wrong.
        """
        t = np.asarray(frame_starts_ms, np.float64)
        if type(self).capacity_scale is Scenario.capacity_scale:
            return None
        out = None
        for i in range(t.size):
            s = self.capacity_scale(float(t[i]), cfg, n_edge, n_servers)
            if s is not None:
                if out is None:
                    out = np.ones((t.size, n_servers), np.float64)
                out[i] = s
        return out

    # -- generator ----------------------------------------------------------
    def generate_arrivals(
        self,
        rng: np.random.Generator,
        n_edge: int,
        n_services: int,
        cfg,
        rng_mode: Optional[str] = None,
    ) -> List[Request]:
        """Draw the full request trace for one replication.

        ``rng_mode=None`` defers to :attr:`rng_mode`.  In ``"paper-default"``
        mode, per edge: a thinned Poisson process against ``rate_bound``,
        one request at a time.  When the instantaneous rate equals the bound
        (constant-rate scenarios) the acceptance draw is skipped, which
        keeps ``paper-default`` bit-identical to the legacy inline
        generator.  ``"vectorized"`` draws the same process in numpy batches
        (different RNG consumption, same distribution).  Requests come back
        sorted by arrival either way.
        """
        mode = _resolve_rng_mode(self.rng_mode if rng_mode is None else rng_mode)
        if mode == "vectorized":
            return self.generate_arrivals_columns(
                rng, n_edge, n_services, cfg
            ).to_requests()
        reqs: List[Request] = []
        rid = 0
        for e in range(n_edge):
            rmax = float(self.rate_bound(e, cfg))
            if rmax <= 0.0:
                continue
            t = 0.0
            while t < cfg.horizon_ms:
                t += rng.exponential(1000.0 / rmax)
                if t >= cfg.horizon_ms:
                    break
                r_t = float(self.rate(e, t, cfg))
                if r_t < rmax and rng.random() >= r_t / rmax:
                    continue  # thinned away
                service = int(rng.integers(0, n_services))
                a, c = self.draw_qos(rng, cfg)
                reqs.append(
                    Request(
                        rid=rid,
                        arrival_ms=t,
                        cover=e,
                        service=service,
                        A=a,
                        C=c,
                        size_bytes=float(rng.uniform(cfg.req_size_lo, cfg.req_size_hi)),
                    )
                )
                rid += 1
        reqs.sort(key=lambda r: r.arrival_ms)
        for i, r in enumerate(reqs):  # rids in arrival order, like the testbed
            r.rid = i
        return reqs

    def generate_arrivals_columns(
        self, rng: np.random.Generator, n_edge: int, n_services: int, cfg
    ) -> RequestColumns:
        """Vectorized trace as :class:`RequestColumns` (the fleet's format).

        Edges draw sequentially from the shared ``rng`` — each edge drains
        its chunked thinned-Poisson process (:func:`iter_edge_arrival_chunks`)
        to the horizon — then the merged trace is stable-sorted by arrival.
        ``generate_arrivals(rng_mode="vectorized")`` wraps exactly these
        columns into :class:`Request` objects, so the two views of one seed
        are the same trace.
        """
        parts: List[RequestColumns] = []
        for e in range(n_edge):
            parts.extend(
                edge_arrival_columns(self, rng, e, n_services, cfg, cfg.horizon_ms)
            )
        return RequestColumns.concatenate(parts).sorted_by_arrival()


def edge_arrival_columns(
    scn: Scenario,
    rng: np.random.Generator,
    edge: int,
    n_services: int,
    cfg,
    horizon_ms: float,
) -> List[RequestColumns]:
    """Drain one edge's chunk iterator into :class:`RequestColumns` parts.

    The single assembly point between :func:`iter_edge_arrival_chunks`'s raw
    ``(ts, svc, A, C, size)`` tuples and the columnar trace — shared by the
    materialized generator (shared rng, edges sequential) and the streaming
    engine's one-shot drain (spawned per-edge rngs), so the two cannot
    drift apart.
    """
    return [
        RequestColumns(
            arrival_ms=ts,
            cover=np.full(ts.size, edge, np.int64),
            service=svc,
            A=a,
            C=c,
            size_bytes=size,
        )
        for ts, svc, a, c, size in iter_edge_arrival_chunks(
            scn, rng, edge, n_services, cfg, horizon_ms
        )
    ]


def _scalar_hook_is_newer(cls: type, scalar_name: str, batch_name: str) -> bool:
    """True when ``scalar_name`` is overridden at a more-derived class than
    ``batch_name`` — i.e. somewhere down the MRO the scalar law changed but
    its batched twin did not, so the inherited batch implementation no
    longer matches.  The vectorized engine then falls back to looping the
    scalar hook: slower, never silently wrong.  (A plain ``is``-comparison
    against ``Scenario`` only catches direct subclasses; this works at any
    inheritance depth, e.g. a subclass of a registered scenario.)"""
    mro = cls.__mro__
    scalar_at = next(i for i, c in enumerate(mro) if scalar_name in c.__dict__)
    batch_at = next(i for i, c in enumerate(mro) if batch_name in c.__dict__)
    return scalar_at < batch_at


def _rate_batch(scn: Scenario, edge: int, ts: np.ndarray, cfg) -> np.ndarray:
    """``scn.rate_batch`` guarded by the MRO check above."""
    if _scalar_hook_is_newer(type(scn), "rate", "rate_batch"):
        return np.fromiter(
            (float(scn.rate(edge, float(x), cfg)) for x in ts), np.float64, ts.size
        )
    return np.asarray(scn.rate_batch(edge, ts, cfg), np.float64)


def _draw_qos_batch(
    scn: Scenario, rng: np.random.Generator, cfg, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``scn.draw_qos_batch`` guarded by the MRO check above."""
    if _scalar_hook_is_newer(type(scn), "draw_qos", "draw_qos_batch"):
        pairs = [scn.draw_qos(rng, cfg) for _ in range(n)]
        a = np.array([p[0] for p in pairs], np.float64)
        c = np.array([p[1] for p in pairs], np.float64)
        return a, c
    a, c = scn.draw_qos_batch(rng, cfg, n)
    return np.asarray(a, np.float64), np.asarray(c, np.float64)


def iter_edge_arrival_chunks(
    scn: Scenario,
    rng: np.random.Generator,
    edge: int,
    n_services: int,
    cfg,
    horizon_ms: float,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """One edge's vectorized thinned-Poisson process, one chunk at a time.

    Yields ``(arrival_ms, service, A, C, size_bytes)`` column chunks of
    accepted arrivals in time order.  Each iteration consumes the RNG in a
    fixed pattern — :data:`VEC_CHUNK` exponential gaps, :data:`VEC_CHUNK`
    thinning uniforms, then the accepted requests' attribute batches — so
    the draw sequence depends only on the generator's state, never on when
    or how far the consumer pulls.  That is the invariance that lets the
    one-shot trace, the streaming engine, and the count-only pre-pass all
    share this single code path (and each other's traces) in
    ``rng_mode="vectorized"``.
    """
    rmax = float(scn.rate_bound(edge, cfg))
    if rmax <= 0.0:
        return
    scale = 1000.0 / rmax
    t = 0.0
    while t < horizon_ms:
        # deterministic chunk size: expected remaining count + 6 sigma slack,
        # so one chunk usually finishes the horizon without gross overdraw
        mean_n = (horizon_ms - t) / scale
        n = int(min(VEC_CHUNK, max(32.0, mean_n + 6.0 * math.sqrt(mean_n + 1.0) + 16.0)))
        gaps = rng.exponential(scale, n)
        ts = t + np.cumsum(gaps)
        t = float(ts[-1])
        u = rng.random(n)  # thinning draws, paired with the gaps
        keep = ts < horizon_ms
        ts, u = ts[keep], u[keep]
        if ts.size:
            r_t = _rate_batch(scn, edge, ts, cfg)
            accept = u * rmax < r_t
            ts = ts[accept]
        if ts.size:
            svc = rng.integers(0, n_services, ts.size)
            a, c = _draw_qos_batch(scn, rng, cfg, ts.size)
            size = rng.uniform(cfg.req_size_lo, cfg.req_size_hi, ts.size)
            yield ts, svc, a, c, size


def bucket_arrivals(
    reqs: List[Request], frame_ms: float, n_frames: int
) -> List[List[Request]]:
    """Group a materialized arrival trace into per-frame buckets.

    This is the fleet runner's frame-synchronous layout: frame ``t`` holds
    every arrival in ``[t * frame_ms, (t + 1) * frame_ms)``, and anything at
    or past the last boundary clamps into the final frame — the same
    bucketing the windowed streaming path reproduces by pulling an
    :class:`~repro_torch.core.streaming.ArrivalStream` one frame at a time.
    """
    buckets: List[List[Request]] = [[] for _ in range(n_frames)]
    for r in reqs:
        buckets[min(int(r.arrival_ms // frame_ms), n_frames - 1)].append(r)
    return buckets


def bucket_columns(
    cols: RequestColumns, frame_ms: float, n_frames: int
) -> List[RequestColumns]:
    """:func:`bucket_arrivals` for a columnar trace — per-frame column views.

    ``cols`` must be sorted by arrival (the generator's contract), so each
    frame is a contiguous slice found by ``searchsorted``; anything at or
    past the last boundary clamps into the final frame, exactly like the
    per-request bucketing.
    """
    edges = np.searchsorted(
        cols.arrival_ms, np.arange(1, n_frames) * frame_ms, side="left"
    )
    bounds = np.concatenate([[0], edges, [len(cols)]])
    return [
        cols.slice(int(bounds[i]), int(bounds[i + 1])) for i in range(n_frames)
    ]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scenario):
    """Register a :class:`Scenario` instance — or a Scenario subclass, which
    is instantiated with its defaults — under its ``name`` (last write wins).
    Returns the argument unchanged, so it works as a class decorator."""
    inst = scenario() if isinstance(scenario, type) else scenario
    SCENARIOS[inst.name] = inst
    return scenario


def get_scenario(scenario) -> Scenario:
    """Resolve a scenario by name (or pass a :class:`Scenario` through)."""
    if isinstance(scenario, Scenario):
        return scenario
    try:
        return SCENARIOS[scenario]
    except KeyError:
        raise KeyError(
            f"unknown scenario {scenario!r}; registered: {', '.join(list_scenarios())}"
        ) from None


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------------------
# Named scenarios
# ---------------------------------------------------------------------------


@register_scenario
@dataclasses.dataclass(frozen=True)
class PaperDefaultScenario(Scenario):
    """The paper's workload, verbatim (the base class defaults)."""

    name: str = "paper-default"
    description: str = "Sec. IV workload: homogeneous Poisson, fixed QoS draw"


@register_scenario
@dataclasses.dataclass(frozen=True)
class DiurnalScenario(Scenario):
    """Sinusoidal day/night load: rate(t) = base * (1 + amp * sin(2*pi*t/P)).

    One full cycle spans ``period_frac`` of the horizon, so short runs still
    see both the peak and the trough.
    """

    name: str = "diurnal"
    description: str = "sinusoidal day/night load swing around the base rate"
    amplitude: float = 0.8
    period_frac: float = 1.0  # cycles = 1 / period_frac over the horizon

    def rate(self, edge, t_ms, cfg):
        period = max(cfg.horizon_ms * self.period_frac, 1e-9)
        return cfg.arrival_rate_per_s * (
            1.0 + self.amplitude * math.sin(2.0 * math.pi * t_ms / period)
        )

    def rate_batch(self, edge, t_ms, cfg):
        period = max(cfg.horizon_ms * self.period_frac, 1e-9)
        t = np.asarray(t_ms, np.float64)
        return cfg.arrival_rate_per_s * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * t / period)
        )

    def rate_bound(self, edge, cfg):
        return cfg.arrival_rate_per_s * (1.0 + self.amplitude)


@register_scenario
@dataclasses.dataclass(frozen=True)
class FlashCrowdScenario(Scenario):
    """A flash crowd hits a subset of edges mid-run: rate jumps ``burst_mult``x
    inside the [burst_start_frac, burst_end_frac) window of the horizon."""

    name: str = "flash-crowd"
    description: str = "10x burst on half the edges for the middle fifth of the run"
    burst_mult: float = 10.0
    burst_start_frac: float = 0.4
    burst_end_frac: float = 0.6
    hot_edge_stride: int = 2  # edges 0, 2, 4, ... catch the crowd

    def _hot(self, edge: int) -> bool:
        return edge % self.hot_edge_stride == 0

    def rate(self, edge, t_ms, cfg):
        base = cfg.arrival_rate_per_s
        in_burst = (
            self.burst_start_frac * cfg.horizon_ms
            <= t_ms
            < self.burst_end_frac * cfg.horizon_ms
        )
        return base * self.burst_mult if (self._hot(edge) and in_burst) else base

    def rate_batch(self, edge, t_ms, cfg):
        t = np.asarray(t_ms, np.float64)
        base = cfg.arrival_rate_per_s
        if not self._hot(edge):
            return np.full(t.shape, base)
        in_burst = (self.burst_start_frac * cfg.horizon_ms <= t) & (
            t < self.burst_end_frac * cfg.horizon_ms
        )
        return np.where(in_burst, base * self.burst_mult, base)

    def rate_bound(self, edge, cfg):
        return cfg.arrival_rate_per_s * (self.burst_mult if self._hot(edge) else 1.0)


@register_scenario
@dataclasses.dataclass(frozen=True)
class MobilityScenario(Scenario):
    """Paper-default traffic, but users roam: every frame each pending user
    re-attaches to a uniformly random edge with probability ``move_prob``
    (the conclusion's future-work item, on by default here)."""

    name: str = "mobility"
    description: str = "Poisson load with per-frame user re-attachment (roaming)"
    move_prob: Optional[float] = 0.3


@register_scenario
@dataclasses.dataclass(frozen=True)
class HeteroTiersScenario(Scenario):
    """Heterogeneous demand: edges carry unequal load (repeating
    ``rate_mults`` pattern) and users split into a *strict* tier (high
    accuracy floor, tight deadline) and a *lenient* tier."""

    name: str = "hetero-tiers"
    description: str = "unequal per-edge load + strict/lenient user QoS mix"
    rate_mults: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strict_frac: float = 0.5
    strict_acc_mean: float = 70.0
    strict_acc_std: float = 5.0
    strict_deadline_mult: float = 0.5
    lenient_deadline_mult: float = 1.5

    def rate(self, edge, t_ms, cfg):
        return cfg.arrival_rate_per_s * self.rate_mults[edge % len(self.rate_mults)]

    def rate_batch(self, edge, t_ms, cfg):
        return np.full(
            np.asarray(t_ms, np.float64).shape, float(self.rate(edge, 0.0, cfg))
        )

    def rate_bound(self, edge, cfg):
        return self.rate(edge, 0.0, cfg)

    def draw_qos(self, rng, cfg):
        if rng.random() < self.strict_frac:
            a = float(np.clip(rng.normal(self.strict_acc_mean, self.strict_acc_std), 1, 99))
            return a, float(cfg.delay_req_ms * self.strict_deadline_mult)
        a = float(np.clip(rng.normal(cfg.acc_req_mean, cfg.acc_req_std), 1, 99))
        return a, float(cfg.delay_req_ms * self.lenient_deadline_mult)

    def draw_qos_batch(self, rng, cfg, n):
        # same tier law as the scalar draw, batched: one tier uniform per
        # request, then a strict and a lenient normal selected by the mask
        # (both batches are drawn so consumption is data-independent)
        strict = rng.random(n) < self.strict_frac
        a_strict = np.clip(rng.normal(self.strict_acc_mean, self.strict_acc_std, n), 1, 99)
        a_lenient = np.clip(rng.normal(cfg.acc_req_mean, cfg.acc_req_std, n), 1, 99)
        a = np.where(strict, a_strict, a_lenient)
        c = np.where(
            strict,
            cfg.delay_req_ms * self.strict_deadline_mult,
            cfg.delay_req_ms * self.lenient_deadline_mult,
        )
        return a, c


@register_scenario
@dataclasses.dataclass(frozen=True)
class SustainedOverloadScenario(Scenario):
    """Arrivals sustained at ``rate_mult`` x the base rate for the whole
    horizon — demand permanently exceeds cluster capacity, so carried
    backlog grows without bound once congestion is enabled.  Streams by
    default: the long-horizon congestion workload."""

    name: str = "sustained-overload"
    description: str = "constant overload at rate_mult x base; streaming by default"
    streaming: bool = True
    rate_mult: float = 3.0

    def rate(self, edge, t_ms, cfg):
        return cfg.arrival_rate_per_s * self.rate_mult

    def rate_batch(self, edge, t_ms, cfg):
        return np.full(
            np.asarray(t_ms, np.float64).shape, cfg.arrival_rate_per_s * self.rate_mult
        )

    def rate_bound(self, edge, cfg):
        return cfg.arrival_rate_per_s * self.rate_mult


@register_scenario
@dataclasses.dataclass(frozen=True)
class DiurnalWeekScenario(DiurnalScenario):
    """Seven full diurnal cycles over the horizon — the long-horizon
    nonstationary workload (the streaming engine keeps memory bounded
    whatever the horizon)."""

    name: str = "diurnal-week"
    description: str = "seven day/night cycles over the horizon; streaming by default"
    streaming: bool = True
    period_frac: float = 1.0 / 7.0


@register_scenario
@dataclasses.dataclass(frozen=True)
class OutageScenario(Scenario):
    """Mid-run server outage: the per-frame (gamma, eta) budgets of
    ``down_servers`` are masked to zero inside the outage window.  A dead
    server can neither compute (gamma = 0) nor ship requests off its queue
    (eta = 0), so requests covered by a dead *edge* are dropped for the
    window, while the rest of the fleet must route around the hole that the
    dead server leaves in cluster capacity."""

    name: str = "outage"
    description: str = "servers lose all capacity for the middle third of the run"
    outage_start_frac: float = 0.33
    outage_end_frac: float = 0.66
    down_servers: Tuple[int, ...] = (0,)

    def capacity_scale(self, frame_start_ms, cfg, n_edge, n_servers):
        in_outage = (
            self.outage_start_frac * cfg.horizon_ms
            <= frame_start_ms
            < self.outage_end_frac * cfg.horizon_ms
        )
        if not in_outage:
            return None
        scale = np.ones(n_servers, np.float32)
        for j in self.down_servers:
            if 0 <= j < n_servers:
                scale[j] = 0.0
        return scale

    def capacity_scale_batch(self, frame_starts_ms, cfg, n_edge, n_servers):
        return _outage_scale_batch(self, frame_starts_ms, cfg, n_servers)


@register_scenario
@dataclasses.dataclass(frozen=True)
class FlashCrowdOutageScenario(FlashCrowdScenario):
    """The resilience composite: a flash crowd *and* a server outage hit at
    once.  Arrivals follow :class:`FlashCrowdScenario` (``burst_mult`` x on
    the hot edges mid-run) while ``down_servers`` lose all capacity inside
    the same window — the flash crowd lands exactly when the cluster is a
    server short.  This is the stress test for admission control: without
    protection, the doomed burst's committed work snowballs into carried
    backlog (congestion on) and poisons the recovery; queue caps and
    deadline shedding bound the damage."""

    name: str = "flash-crowd-outage"
    description: str = "flash crowd on the hot edges while servers are down"
    outage_start_frac: float = 0.4
    outage_end_frac: float = 0.6
    down_servers: Tuple[int, ...] = (1,)

    def capacity_scale(self, frame_start_ms, cfg, n_edge, n_servers):
        in_outage = (
            self.outage_start_frac * cfg.horizon_ms
            <= frame_start_ms
            < self.outage_end_frac * cfg.horizon_ms
        )
        if not in_outage:
            return None
        scale = np.ones(n_servers, np.float32)
        for j in self.down_servers:
            if 0 <= j < n_servers:
                scale[j] = 0.0
        return scale

    def capacity_scale_batch(self, frame_starts_ms, cfg, n_edge, n_servers):
        return _outage_scale_batch(self, frame_starts_ms, cfg, n_servers)


def _outage_scale_batch(scn, frame_starts_ms, cfg, n_servers):
    """Shared vectorized outage-window mask for the two outage scenarios.

    Bit-identity with the scalar hook: frames inside the window get the
    same float32 ``0.0``/``1.0`` row the scalar hook builds, frames outside
    get exact ``1.0`` (the f64 multiplicative identity).
    """
    t = np.asarray(frame_starts_ms, np.float64)
    in_outage = (scn.outage_start_frac * cfg.horizon_ms <= t) & (
        t < scn.outage_end_frac * cfg.horizon_ms
    )
    if not in_outage.any():
        return None
    out = np.ones((t.size, n_servers), np.float64)
    down = [j for j in scn.down_servers if 0 <= j < n_servers]
    if down:
        out[np.ix_(in_outage, down)] = 0.0
    return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class MegaCityScenario(Scenario):
    """City-scale load: a diurnal swing *multiplied* by a mid-run flash
    crowd on the hot edges, at rates sized for 10^5+ arrivals per frame on
    a ~20-edge cluster (``rate_per_edge_per_s * frame_s * n_edge``).  QoS
    requirements are drawn from *discrete* tiers (accuracy floor x deadline
    multiplier), so the distinct-QoS space stays tiny however many users
    arrive — the workload the hierarchical class-aggregate scheduler
    (:mod:`repro_torch.core.aggregation`) is built for.  Streams and
    generates columnar (``vectorized``) by default.
    """

    name: str = "mega-city"
    description: str = "10^5+ users/frame: diurnal x flash crowd, discrete QoS tiers"
    streaming: bool = True
    rng_mode: str = "vectorized"
    dense_sweep: bool = False
    rate_per_edge_per_s: float = 2400.0
    amplitude: float = 0.5
    period_frac: float = 1.0
    burst_mult: float = 3.0
    burst_start_frac: float = 0.4
    burst_end_frac: float = 0.6
    hot_edge_stride: int = 2
    acc_tiers: Tuple[float, ...] = (45.0, 55.0, 65.0)
    deadline_mults: Tuple[float, ...] = (0.75, 1.0, 1.5)

    def _hot(self, edge: int) -> bool:
        return edge % self.hot_edge_stride == 0

    def rate(self, edge, t_ms, cfg):
        period = max(cfg.horizon_ms * self.period_frac, 1e-9)
        r = self.rate_per_edge_per_s * (
            1.0 + self.amplitude * math.sin(2.0 * math.pi * t_ms / period)
        )
        in_burst = (
            self.burst_start_frac * cfg.horizon_ms
            <= t_ms
            < self.burst_end_frac * cfg.horizon_ms
        )
        return r * self.burst_mult if (self._hot(edge) and in_burst) else r

    def rate_batch(self, edge, t_ms, cfg):
        t = np.asarray(t_ms, np.float64)
        period = max(cfg.horizon_ms * self.period_frac, 1e-9)
        r = self.rate_per_edge_per_s * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * t / period)
        )
        if not self._hot(edge):
            return r
        in_burst = (self.burst_start_frac * cfg.horizon_ms <= t) & (
            t < self.burst_end_frac * cfg.horizon_ms
        )
        return np.where(in_burst, r * self.burst_mult, r)

    def rate_bound(self, edge, cfg):
        peak = self.rate_per_edge_per_s * (1.0 + self.amplitude)
        return peak * (self.burst_mult if self._hot(edge) else 1.0)

    def draw_qos(self, rng, cfg):
        a = self.acc_tiers[int(rng.integers(0, len(self.acc_tiers)))]
        m = self.deadline_mults[int(rng.integers(0, len(self.deadline_mults)))]
        return float(a), float(cfg.delay_req_ms * m)

    def draw_qos_batch(self, rng, cfg, n):
        a = np.asarray(self.acc_tiers, np.float64)[
            rng.integers(0, len(self.acc_tiers), n)
        ]
        c = cfg.delay_req_ms * np.asarray(self.deadline_mults, np.float64)[
            rng.integers(0, len(self.deadline_mults), n)
        ]
        return a, c
