"""Monte-Carlo fleet simulator — the paper's numerical testbed on the card.

The PyTorch counterpart of ``repro.core.simulator.simulate_fleet``: R
independent replications of a scenario, each a sequence of T
frame-synchronous decisions, in one of two scheduling layouts.

**Dense** (the default):

1. Each replication's arrivals are drawn on the host in numpy
   (:class:`_RepFrameSource`, the reference's RNG order, both ``rng_mode``s,
   materialized or streamed).
2. Every (replication, frame) pair becomes one padded ``FlatInstance``: the
   (N requests x M servers x L variants) candidate grid, built on the host
   for a whole window of frames at once (:func:`_build_frame_batch`) and
   moved to the card once per window from pinned memory.
3. The scheduler runs over the replication batch.  With congestion on, a
   Python loop over the window's frames applies the backlog-reduced budgets,
   calls the policy and updates the carry (:func:`_step`); with it off the
   carry is inert, and one call schedules all R x W frames of the window —
   the same assignments, because no frame then depends on another.
4. Satisfaction and mean US are scored on the card per frame and only the
   per-frame counts come back to the host.

**Hierarchical** (``EngineOptions(scheduler="hierarchical")``, the
city-scale path, :func:`_simulate_fleet_hier`): each frame's requests are
bucketed into QoS classes on the host, the class representatives become one
padded ``(Cp, M, L)`` class grid per frame, utility and feasibility are
computed on the card, the class allocator
(:func:`repro_torch.kernels.hier.hier_cells`) places whole chunks of each
class, and the members are accounted one by one on the host, one window
behind the card.

``window=`` bounds memory (frames are built and scheduled ``window`` at a
time, the carry threaded between windows; on a streaming scenario the
arrivals themselves are drawn a window at a time) and ``prefetch=``
overlaps the host build of window k+1 with the card's work on window k in
one producer thread.  All host RNG lives in the build, which runs the same
work in the same order inline or on the producer, so results are identical
either way.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP.md item): the sequential ``simulate``, impairments and admission
control, the metric stream and ``devices>1``.
"""
from __future__ import annotations

import dataclasses
import functools
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.obs.trace import Stopwatch

from repro_torch.kernels.hier import hier_cells

from .aggregation import QuantizationConfig, aggregate_requests
from .impairments import AdmissionConfig, ImpairmentConfig
from .instance import FlatInstance, resolve_device
from .options import EngineOptions, check_ported, resolve_options
from .policies import Policy, get_policy
from .queueing import (
    CongestionConfig,
    comm_inflation,
    committed_loads,
    compute_inflation,
    congested_ctime,
    effective_capacity,
    ema_update,
    fleet_policy_carry,
    step_backlog,
)
from .satisfaction import hard_feasible, mean_us, satisfied_mask, us_tensor
from .scenarios import (
    RequestColumns,
    Scenario,
    bucket_arrivals,
    bucket_columns,
    get_scenario,
)
from .streaming import ArrivalStream, max_frame_arrivals, stream_trace, stream_trace_columns

__all__ = [
    "ClusterSpec",
    "SimConfig",
    "FleetResult",
    "EngineOptions",
    "simulate_fleet",
    "demo_cluster_spec",
]

_FIELDS = tuple(f.name for f in dataclasses.fields(FlatInstance))


@dataclasses.dataclass
class ClusterSpec:
    """Static cluster description (servers, services, placement, profiles)."""

    n_edge: int
    n_cloud: int
    gamma_frame: np.ndarray       # (M,) compute capacity per frame (chip-ms)
    eta_frame: np.ndarray         # (M,) comm capacity per frame (KB)
    proc_ms: np.ndarray           # (M, K, L) mean processing delay
    placed: np.ndarray            # (M, K, L) bool
    acc: np.ndarray               # (K, L) accuracy (%)
    bandwidth_true: float = 600.0  # bytes/ms
    cloud_extra_delay: float = 100.0

    @property
    def n_servers(self) -> int:
        return self.n_edge + self.n_cloud

    def is_cloud(self) -> np.ndarray:
        return np.arange(self.n_servers) >= self.n_edge


@dataclasses.dataclass
class SimConfig:
    """The reference's simulation configuration, field for field (the
    sequential testbed's fields ride along unused by the fleet)."""

    horizon_ms: float = 120_000.0
    frame_ms: float = 3000.0
    queue_cap: int = 4
    arrival_rate_per_s: float = 2.0
    acc_req_mean: float = 50.0
    acc_req_std: float = 0.0
    delay_req_ms: float = 53_000.0
    req_size_lo: float = 20_000.0
    req_size_hi: float = 120_000.0
    channel_sigma: float = 0.25
    proc_sigma: float = 0.05
    move_prob: float = 0.0
    w_a: float = 1.0
    w_c: float = 1.0
    max_as: float = 100.0
    max_cs: float = 12_000.0
    adapt_max_cs: bool = True
    bandwidth_init: float = 600.0
    congestion: CongestionConfig = dataclasses.field(default_factory=CongestionConfig)
    impairments: ImpairmentConfig = dataclasses.field(default_factory=ImpairmentConfig)
    admission: AdmissionConfig = dataclasses.field(default_factory=AdmissionConfig)


@dataclasses.dataclass
class FleetResult:
    """Aggregate of R independent replications."""

    n_rep: int
    n_frames: int                  # frames per replication
    n_requests: int                # total across all replications
    n_served: int
    satisfied_per_rep: np.ndarray  # (R,) satisfied-% per replication
    mean_us_per_rep: np.ndarray    # (R,) mean US over that replication's requests
    #: (R, M) carried compute backlog after the last frame (None when the
    #: congestion model is disabled)
    final_backlog_per_rep: Optional[np.ndarray] = None
    #: mean compute-inflation factor across (rep, frame, server) cells
    mean_compute_inflation: float = 1.0
    n_devices: int = 1
    #: frames per window (== n_frames when fully materialized)
    window: Optional[int] = None
    #: wall-clock seconds of the scheduling phase: moving each window to the
    #: device, the per-frame steps, and waiting for the device to finish
    dispatch_s: float = 0.0
    #: wall-clock seconds the pipeline was *blocked* on host-side arrival
    #: generation + frame-grid building (work hidden behind the device by
    #: ``prefetch`` does not count)
    gen_s: float = 0.0
    #: producer-queue depth the run used (0 = serial build)
    prefetch: int = 0
    #: per-span wall-clock totals of the run's Stopwatch
    timings: Optional[Dict[str, float]] = None
    #: the device the fleet ran on (``"cpu"`` or the CUDA device's name)
    device: str = "cpu"

    @property
    def satisfied_pct(self) -> float:
        return float(np.mean(self.satisfied_per_rep))

    @property
    def satisfied_std(self) -> float:
        return float(np.std(self.satisfied_per_rep))

    @property
    def mean_us(self) -> float:
        return float(np.mean(self.mean_us_per_rep))


def _pad_bucket(n: int) -> int:
    """Round a frame's queue length up to a power-of-two bucket (min 4)."""
    return max(4, 1 << max(n - 1, 0).bit_length())


def _pad_bucket_fine(n: int) -> int:
    """Bucket schedule for the hierarchical class axis: powers of two up to
    4096, multiples of 1024 above (at most ~5% dead class rows past 4096,
    where a power of two would pad 19k classes to 32768)."""
    if n <= 4096:
        return max(4, 1 << max(n - 1, 0).bit_length())
    return ((n + 1023) // 1024) * 1024


def _frame_arrays(
    reqs, spec: ClusterSpec, cfg: SimConfig, now_ms, bw_est: float
) -> Dict[str, np.ndarray]:
    """Numpy request-row tensors for the given requests (a Request list or a
    :class:`RequestColumns` view), with ``now_ms`` a scalar or per request.

    The same elementwise float64 arithmetic as the reference, narrowed to
    float32 at the same points, so the tensors are bit-identical."""
    M = spec.n_servers
    L = spec.acc.shape[1]
    N = len(reqs)
    is_cloud = spec.is_cloud()

    if isinstance(reqs, RequestColumns):
        cover = reqs.cover.astype(np.int32)
        A = reqs.A.astype(np.float32)
        C = reqs.C.astype(np.float32)
        Tq = (now_ms - reqs.arrival_ms).astype(np.float32)
        size = reqs.size_bytes.astype(np.float32)
        svc = reqs.service.astype(np.int32)
    else:
        cover = np.array([r.cover for r in reqs], np.int32)
        A = np.array([r.A for r in reqs], np.float32)
        C = np.array([r.C for r in reqs], np.float32)
        Tq = np.array([now_ms - r.arrival_ms for r in reqs], np.float32)
        size = np.array([r.size_bytes for r in reqs], np.float32)
        svc = np.array([r.service for r in reqs], np.int32)

    local = cover[:, None] == np.arange(M)[None, :]
    transfer = size[:, None] / bw_est
    comm = transfer + np.where(is_cloud[None, :], spec.cloud_extra_delay, 0.0)
    comm = np.where(local, 0.0, comm)

    proc = spec.proc_ms[:, svc, :].transpose(1, 0, 2)       # (N, M, L)
    ctime = Tq[:, None, None] + proc + comm[:, :, None]
    avail = spec.placed[:, svc, :].transpose(1, 0, 2)
    acc = np.broadcast_to(spec.acc[svc][:, None, :], (N, M, L))
    u = np.where(local[:, :, None], 0.0, (size / 1024.0)[:, None, None])
    return dict(
        cover=cover, A=A, C=C, acc=acc, ctime=ctime, v=proc,
        u=np.broadcast_to(u, (N, M, L)), avail=avail,
    )


def _build_frame_batch(
    frames: List,
    spec: ClusterSpec,
    cfg: SimConfig,
    frame_starts: Sequence[float],
    budgets,
    n_pad: int,
) -> Dict[str, np.ndarray]:
    """Padded numpy leaves of a ``FlatInstance`` for a list of frames.

    Pad rows follow :func:`repro_torch.core.instance.pad_instance`'s
    contract (infeasible and free).  A fully columnar list (the vectorized
    rng mode) runs :func:`_frame_arrays` once over all its requests — its
    formulas are elementwise given each request's decision time — and copies
    each frame's rows into place; otherwise frames are filled one by one.
    """
    F = len(frames)
    M = spec.n_servers
    L = spec.acc.shape[1]
    out = dict(
        cover=np.zeros((F, n_pad), np.int32),
        A=np.full((F, n_pad), 1e9, np.float32),
        C=np.full((F, n_pad), -1.0, np.float32),
        w_a=np.zeros((F, n_pad), np.float32),
        w_c=np.zeros((F, n_pad), np.float32),
        acc=np.zeros((F, n_pad, M, L), np.float32),
        ctime=np.full((F, n_pad, M, L), 1e9, np.float32),
        v=np.zeros((F, n_pad, M, L), np.float32),
        u=np.zeros((F, n_pad, M, L), np.float32),
        avail=np.zeros((F, n_pad, M, L), bool),
        gamma=np.zeros((F, M), np.float32),
        eta=np.zeros((F, M), np.float32),
        max_as=np.full((F,), cfg.max_as, np.float32),
        max_cs=np.full((F,), cfg.max_cs, np.float32),
    )
    for i in range(F):
        out["gamma"][i], out["eta"][i] = budgets[i]
    row_keys = ("cover", "A", "C", "acc", "ctime", "v", "u", "avail")

    def put(i, arr, sl, n):
        for k in row_keys:
            out[k][i, :n] = arr[k][sl]
        out["w_a"][i, :n] = cfg.w_a
        out["w_c"][i, :n] = cfg.w_c

    if F > 0 and all(isinstance(b, RequestColumns) for b in frames):
        lengths = np.fromiter((len(b) for b in frames), np.int64, F)
        if lengths.sum():
            cat = RequestColumns.concatenate(frames)
            now = np.repeat(np.asarray(frame_starts, np.float64) + cfg.frame_ms, lengths)
            arr = _frame_arrays(cat, spec, cfg, now, spec.bandwidth_true)
            starts = np.cumsum(lengths) - lengths
            for i in range(F):
                n = int(lengths[i])
                if n:
                    put(i, arr, slice(int(starts[i]), int(starts[i]) + n), n)
    else:
        for i, (reqs, t0) in enumerate(zip(frames, frame_starts)):
            n = len(reqs)
            if n:
                arr = _frame_arrays(reqs, spec, cfg, t0 + cfg.frame_ms, spec.bandwidth_true)
                put(i, arr, slice(None), n)
    return out


def _apply_mobility(cover: np.ndarray, n_edge: int, move_prob: float, rng) -> np.ndarray:
    """Each user re-attaches to a random edge with probability ``move_prob``."""
    move = rng.random(cover.shape[0]) < move_prob
    new = rng.integers(0, n_edge, size=cover.shape[0]).astype(cover.dtype)
    return np.where(move, new, cover)


def _apply_mobility_inplace(reqs, n_edge: int, move_prob: float, rng) -> None:
    """Re-attach each pending request's covering edge with prob ``move_prob``
    (two draws of ``len(reqs)``, none when the frame is empty, either layout)."""
    if move_prob <= 0 or not reqs:
        return
    if isinstance(reqs, RequestColumns):
        reqs.cover = _apply_mobility(
            reqs.cover.astype(np.int32), n_edge, move_prob, rng
        ).astype(np.int64)
        return
    cov = _apply_mobility(np.array([r.cover for r in reqs], np.int32), n_edge, move_prob, rng)
    for r, c in zip(reqs, cov):
        r.cover = int(c)


def _frame_budgets_batch(
    spec: ClusterSpec, cfg: SimConfig, scn: Scenario, frame_starts_ms: np.ndarray
):
    """``(F, M)`` float64 gamma and eta budgets for a window of frame starts,
    masked by the scenario's capacity stream (outages)."""
    t = np.asarray(frame_starts_ms, np.float64)
    F = t.size
    g = np.repeat(spec.gamma_frame.astype(np.float64)[None, :], F, axis=0)
    e = np.repeat(spec.eta_frame.astype(np.float64)[None, :], F, axis=0)
    scale = scn.capacity_scale_batch(t, cfg, spec.n_edge, spec.n_servers)
    if scale is not None:
        g = g * scale
        e = e * scale
    return g, e


class _RepFrameSource:
    """One replication's per-frame request buckets, materialized or lazy.

    *Materialized*: one ``default_rng(rep_seed)`` draws the trace (Request
    objects in ``"paper-default"`` mode, :class:`RequestColumns` in
    ``"vectorized"``) — or the trace comes from the streaming engine's
    one-shot drain when ``use_stream`` — and then the per-frame mobility
    draws, in the reference's order.  *Lazy* holds an
    :class:`~repro_torch.core.streaming.ArrivalStream` and draws each
    frame's bucket on demand, so a windowed fleet never holds more than one
    window of requests; the stream's chunking invariance makes the buckets
    (and the mobility draw order) the same either way.
    """

    def __init__(
        self, scn, rep_seed, n_edge, n_services, cfg, T, use_stream, lazy, rng_mode
    ):
        self.cfg = cfg
        self.n_edge = n_edge
        self.move_prob = cfg.move_prob if scn.move_prob is None else scn.move_prob
        self.rng = np.random.default_rng(rep_seed)
        self.stream: Optional[ArrivalStream] = None
        self.buckets = None
        if lazy:
            self.stream = ArrivalStream(
                scn, rep_seed, n_edge, n_services, cfg, rng_mode=rng_mode
            )
        elif rng_mode == "vectorized":
            if use_stream:
                cols = stream_trace_columns(scn, rep_seed, n_edge, n_services, cfg)
            else:
                cols = scn.generate_arrivals_columns(self.rng, n_edge, n_services, cfg)
            self.buckets = bucket_columns(cols, cfg.frame_ms, T)
        else:
            if use_stream:
                # rng_mode=None defers to the scenario, as in the reference
                reqs = stream_trace(scn, rep_seed, n_edge, n_services, cfg)
            else:
                reqs = scn.generate_arrivals(self.rng, n_edge, n_services, cfg, rng_mode=rng_mode)
            self.buckets = bucket_arrivals(reqs, cfg.frame_ms, T)
        self._next = 0

    @property
    def max_bucket(self) -> int:
        """Largest per-frame bucket (materialized sources only)."""
        return max((len(b) for b in self.buckets), default=0)

    def take(self, upto_frame: int) -> List:
        """Buckets for frames ``[next, upto_frame)``, mobility applied in
        frame order."""
        out = []
        for tf in range(self._next, upto_frame):
            if self.buckets is not None:
                b = self.buckets[tf]
            else:
                b = self.stream.take_until((tf + 1) * self.cfg.frame_ms)
            _apply_mobility_inplace(b, self.n_edge, self.move_prob, self.rng)
            out.append(b)
        self._next = upto_frame
        return out


def _build_window(sources, spec, cfg, scn, t0: int, t1: int, n_pad: int, sw, pin: bool):
    """Host build of frames ``[t0, t1)`` of every replication, frame-major
    (row ``k * n_rep + rep``): pull the buckets, fill the queueing delays,
    assemble the padded grid and stage it in host tensors (pinned when
    ``pin``).  Returns ``(host, n_real)``: the ``FlatInstance`` leaves plus
    ``tq`` as CPU tensors, and the real request count per row.  Pure numpy
    and the sources' own RNGs, so it runs the same inline or on a producer
    thread."""
    n_rep = len(sources)
    Tc = t1 - t0
    with sw.span("fleet/arrivals"):
        per_rep = [src.take(t1) for src in sources]
        frames = [per_rep[r][k] for k in range(Tc) for r in range(n_rep)]
        frame_starts = [(t0 + k) * cfg.frame_ms for k in range(Tc) for _ in range(n_rep)]
        n_real = np.array([len(b) for b in frames], np.int32)
        tq = np.zeros((Tc * n_rep, n_pad), np.float32)
        for i, (bucket, fs) in enumerate(zip(frames, frame_starts)):
            nb = len(bucket)
            if not nb:
                continue
            if isinstance(bucket, RequestColumns):
                tq[i, :nb] = fs + cfg.frame_ms - bucket.arrival_ms
            else:
                tq[i, :nb] = [fs + cfg.frame_ms - r.arrival_ms for r in bucket]
    with sw.span("fleet/grid_build"):
        gb, eb = _frame_budgets_batch(spec, cfg, scn, (t0 + np.arange(Tc)) * cfg.frame_ms)
        budgets = [(gb[k], eb[k]) for k in range(Tc) for _ in range(n_rep)]
        arrays = _build_frame_batch(frames, spec, cfg, frame_starts, budgets, n_pad)
        arrays["tq"] = tq
        host = {k: torch.from_numpy(x) for k, x in arrays.items()}
    if pin:
        with sw.span("fleet/pin"):
            host = {k: x.pin_memory() for k, x in host.items()}
    return host, n_real


def _step(fn, frame: FlatInstance, carry, ccfg: CongestionConfig):
    """One congested frame over the replication batch: schedule against the
    backlog-reduced budgets, then inflate and roll the backlog/EMA carry."""
    run = dataclasses.replace(
        frame,
        gamma=effective_capacity(frame.gamma, carry.backlog_gamma),
        eta=effective_capacity(frame.eta, carry.backlog_eta),
    )
    a = fn(run)
    w, c = a.loads if a.loads is not None else committed_loads(frame, a.j, a.l)
    pc = compute_inflation(carry.backlog_gamma + w, frame.gamma, ccfg)
    pe = comm_inflation(carry.backlog_eta + c, frame.eta, ccfg)
    carry = dataclasses.replace(
        carry,
        backlog_gamma=step_backlog(carry.backlog_gamma, w, frame.gamma, ccfg),
        backlog_eta=step_backlog(carry.backlog_eta, c, frame.eta, ccfg),
        ema_util=ema_update(carry.ema_util, w, frame.gamma, ccfg),
    )
    return carry, a, pc, pe


def _not_ported(cfg: SimConfig) -> None:
    if cfg.impairments.enabled or cfg.admission.enabled:
        raise NotImplementedError(
            "impairments and admission control are not ported yet "
            "(ROADMAP.md §1 item 3, still to port: resilience)"
        )


class _WindowPipeline:
    """Windows built in order: inline, or up to ``prefetch`` ahead on one
    producer thread with a bounded queue.

    An exception raised while building a window reaches the consumer's
    :meth:`next`; :meth:`close` (always called) unblocks, drains and joins
    the producer, so an early exit or an error never leaves a thread
    behind.
    """

    def __init__(self, build, window_starts, prefetch: int, name: str):
        self.build = build
        self.thread = None
        if prefetch <= 0 or not window_starts:
            return
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self.stop = threading.Event()

        def offer(item) -> bool:
            while not self.stop.is_set():
                try:
                    self.queue.put(item, timeout=0.05)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            try:
                for t0 in window_starts:
                    if not offer(build(t0)):
                        return
            except BaseException as e:  # delivered to the consumer's next()
                offer(e)

        self.thread = threading.Thread(target=produce, name=name, daemon=True)
        self.thread.start()

    def next(self, t0: int):
        if self.thread is None:
            return self.build(t0)
        item = self.queue.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        if self.thread is None:
            return
        self.stop.set()
        while self.thread.is_alive():
            try:
                self.queue.get_nowait()
            except queue_mod.Empty:
                pass
            self.thread.join(timeout=0.05)
        self.thread.join()


def _fold_hier_scheduler(policy) -> None:
    """The hierarchical layout *is* the reference's ``gus-hier`` policy, so
    it composes only with ``"gus"`` or ``"gus-hier"``; any other policy is
    an error, not a silent override."""
    name = policy.name if isinstance(policy, Policy) else policy
    if name not in ("gus", "gus-hier"):
        raise ValueError(
            "EngineOptions(scheduler='hierarchical') maps to the 'gus-hier' "
            f"policy; it does not compose with policy {name!r}"
        )


def simulate_fleet(
    spec: ClusterSpec,
    cfg: SimConfig,
    *,
    policy: Union[str, Policy] = "gus",
    scenario: Union[str, Scenario] = "paper-default",
    n_rep: int = 16,
    seed: int = 0,
    options: Optional[EngineOptions] = None,
    device=None,
) -> FleetResult:
    """Monte-Carlo fleet: ``n_rep`` independent replications on ``device``.

    Replication ``r`` draws its arrivals from ``default_rng(seed + r)`` (or
    streams them from ``SeedSequence(seed + r)``), as in the reference.  On
    the dense layout every frame is padded to one power-of-two bucket (the
    largest frame over all replications; a count-only pre-pass finds it
    when the arrivals stream lazily), so the integer results equal the
    reference's ``simulate_fleet`` for the same arguments and
    ``mean_us_per_rep`` agrees to float32 summation order.
    ``EngineOptions(scheduler="hierarchical")`` runs the class-aggregate
    fleet instead (:func:`_simulate_fleet_hier`).

    ``device=None`` means ``"cuda"`` (raises without a CUDA device);
    ``options`` takes the fields :func:`~repro_torch.core.options.
    resolve_options` resolves.  ``options.backend`` picks the GUS
    implementation (dense; composes only with the ``"gus"`` policy) or the
    class allocator's (hierarchical).
    """
    dev = resolve_device(device)
    scn = get_scenario(scenario)
    opts = resolve_options(options, scenario=scn)
    check_ported(opts)
    _not_ported(cfg)
    hier = opts.scheduler == "hierarchical"
    if hier:
        _fold_hier_scheduler(policy)
    else:
        pol = get_policy(policy)
        fn = pol.bind(spec.n_edge, spec.n_servers)
        if opts.backend is not None:
            if pol.name != "gus":
                raise ValueError(
                    f"backend={opts.backend!r} selects the GUS implementation; "
                    f"policy {pol.name!r} does not take it"
                )
            fn = functools.partial(fn, backend=opts.backend)
    ccfg = cfg.congestion
    T = max(1, int(np.ceil(cfg.horizon_ms / cfg.frame_ms)))
    K = spec.proc_ms.shape[1]
    M = spec.n_servers
    W = T if opts.window is None else max(1, min(int(opts.window), T))
    # a streamed trace is drawn a window at a time when windows are shorter
    # than the horizon, and materialized in one drain otherwise
    lazy = opts.streaming and W < T
    pin = dev.type == "cuda"

    sw = Stopwatch()
    t_run0 = time.perf_counter()
    with sw.span("fleet/generate_traces"):
        sources = [
            _RepFrameSource(
                scn, seed + rep, spec.n_edge, K, cfg, T, opts.streaming, lazy, opts.rng_mode
            )
            for rep in range(n_rep)
        ]
        if hier:
            n_pad = 0  # the class-aggregate path never pads a request grid
        elif lazy:
            # count-only pre-pass: the global largest frame in bounded
            # memory — one padding bucket, the materialized run's
            n_pad = _pad_bucket(max(
                max_frame_arrivals(
                    scn, seed + rep, spec.n_edge, K, cfg, T, rng_mode=opts.rng_mode
                )
                for rep in range(n_rep)
            ))
        else:
            n_pad = _pad_bucket(max(src.max_bucket for src in sources))
    gen_s = sw.total("fleet/generate_traces")
    if hier:
        return _simulate_fleet_hier(
            spec, cfg, scn, sources, n_rep=n_rep, T=T, W=W, opts=opts, dev=dev,
            gen_s=gen_s, sw=sw, t_run0=t_run0,
        )
    carry = fleet_policy_carry(n_rep, M, bandwidth_init=spec.bandwidth_true, device=dev)

    sat_frames = np.zeros((n_rep, T), np.int64)
    served_frames = np.zeros((n_rep, T), np.int64)
    us_frames = np.zeros((n_rep, T), np.float32)
    n_real_frames = np.zeros((n_rep, T), np.int32)
    phi_frames = np.ones((n_rep, T, M), np.float32) if ccfg.enabled else None

    def build_window(t0: int):
        return _build_window(sources, spec, cfg, scn, t0, min(t0 + W, T), n_pad, sw, pin)

    window_starts = list(range(0, T, W))
    pipe = _WindowPipeline(build_window, window_starts, opts.prefetch, "fleet-window-producer")
    try:
        for wi_t0 in window_starts:
            with sw.span("fleet/window_wait"):
                host, n_real = pipe.next(wi_t0)
            t0, t1 = wi_t0, min(wi_t0 + W, T)
            Tc = t1 - t0
            with sw.span("fleet/dispatch"):
                inst = FlatInstance(
                    **{k: host[k].to(dev, non_blocking=True) for k in _FIELDS}
                )
                if ccfg.enabled:
                    js, ls, pcs, pes = [], [], [], []
                    for k in range(Tc):
                        sl = slice(k * n_rep, (k + 1) * n_rep)
                        frame = FlatInstance(**{f: getattr(inst, f)[sl] for f in _FIELDS})
                        carry, a, pc, pe = _step(fn, frame, carry, ccfg)
                        js.append(a.j)
                        ls.append(a.l)
                        pcs.append(pc)
                        pes.append(pe)
                    aj, al = torch.cat(js), torch.cat(ls)
                else:
                    a = fn(inst)
                    aj, al = a.j, a.l
                if pin:
                    torch.cuda.synchronize(dev)
            with sw.span("fleet/window_metrics"):
                if ccfg.enabled:
                    phi_c = torch.cat(pcs)
                    mbatch = dataclasses.replace(
                        inst,
                        ctime=congested_ctime(
                            inst, host["tq"].to(dev, non_blocking=True), phi_c, torch.cat(pes)
                        ),
                    )
                    phi_frames[:, t0:t1] = (
                        phi_c.reshape(Tc, n_rep, M).transpose(0, 1).cpu().numpy()
                    )
                else:
                    mbatch = inst
                real = torch.arange(n_pad, device=dev)[None, :] < torch.from_numpy(
                    n_real
                ).to(dev)[:, None]
                sat = (satisfied_mask(mbatch, aj, al) & real).sum(-1)
                served = ((aj >= 0) & real).sum(-1)
                us = mean_us(mbatch, aj, al)

                def per_rep(x):  # frame-major (Tc * R,) -> (R, Tc)
                    return x.reshape(Tc, n_rep).T

                sat_frames[:, t0:t1] = per_rep(sat.cpu().numpy())
                served_frames[:, t0:t1] = per_rep(served.cpu().numpy())
                us_frames[:, t0:t1] = per_rep(us.cpu().numpy())
                n_real_frames[:, t0:t1] = per_rep(n_real)
    finally:
        pipe.close()

    reqs_per_rep = n_real_frames.sum(1)
    sat_per_rep = sat_frames.sum(1)
    # mean_us averages over n_pad rows (padded rows contribute 0); recover the
    # per-rep sum (exact: n_pad is a power of two) and renormalize by the
    # rep's true request count
    us_sum_per_rep = (us_frames * n_pad).sum(1)
    gen_s += sw.total("fleet/window_wait")
    timings = sw.as_dict()
    timings["total_s"] = time.perf_counter() - t_run0
    return FleetResult(
        n_rep=n_rep,
        n_frames=T,
        n_requests=int(reqs_per_rep.sum()),
        n_served=int(served_frames.sum()),
        satisfied_per_rep=100.0 * sat_per_rep / np.maximum(reqs_per_rep, 1),
        mean_us_per_rep=us_sum_per_rep / np.maximum(reqs_per_rep, 1),
        final_backlog_per_rep=carry.backlog_gamma.cpu().numpy() if ccfg.enabled else None,
        mean_compute_inflation=float(np.mean(phi_frames)) if ccfg.enabled else 1.0,
        n_devices=1,
        window=W,
        dispatch_s=sw.total("fleet/dispatch"),
        gen_s=gen_s,
        prefetch=opts.prefetch if pipe.thread is not None else 0,
        timings=timings,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )


def _frame_columns(bucket):
    """``(cover, service, A, C, size, arrival_ms)`` numpy columns of one
    frame's requests, either layout."""
    if isinstance(bucket, RequestColumns):
        return (bucket.cover, bucket.service, bucket.A, bucket.C,
                bucket.size_bytes, bucket.arrival_ms)
    return (
        np.array([r.cover for r in bucket], np.int64),
        np.array([r.service for r in bucket], np.int64),
        np.array([r.A for r in bucket], np.float64),
        np.array([r.C for r in bucket], np.float64),
        np.array([r.size_bytes for r in bucket], np.float64),
        np.array([r.arrival_ms for r in bucket], np.float64),
    )


def _aggregate_frame(bucket, frame_end: float, quant: QuantizationConfig):
    """One frame's QoS classes, sorted by first member (the order the
    allocator walks them): the class-representative columns and the
    member bookkeeping the accounting needs."""
    cov, svc, A_r, C_r, size, arr_ms = _frame_columns(bucket)
    tq = frame_end - np.asarray(arr_ms, np.float64)
    count, first_idx, members, offsets, repc = aggregate_requests(
        cov, svc, A_r, C_r, size, tq, quant
    )
    order = np.argsort(first_idx, kind="stable")
    n_c = count.shape[0]
    rank = np.empty(n_c, np.int64)
    rank[order] = np.arange(n_c)
    cls_of_member = np.repeat(np.arange(n_c), count)
    members_s = members[np.argsort(rank[cls_of_member], kind="stable")]
    count_s = count[order]
    rep_cols = RequestColumns(
        arrival_ms=frame_end - repc["tq"][order],
        cover=repc["cover"][order],
        service=repc["service"][order],
        A=repc["A"][order],
        C=repc["C"][order],
        size_bytes=repc["size"][order],
    )
    info = dict(
        members_s=members_s,
        off_s=np.concatenate([[0], np.cumsum(count_s)]),
        count_s=count_s,
        cov=cov, svc=svc, A=A_r, C=C_r, size=size, tq=tq,
    )
    return rep_cols, info


def _member_accounting(spec: ClusterSpec, cfg: SimConfig, info, ci, jj, ll, lens, st,
                       pc_k=None, pe_k=None):
    """Per-member satisfaction of one frame's allocated cells: ``(served,
    satisfied, sum of US)``.

    The allocated members of each cell are the class's members from its
    ``start`` offset on, and every member's realized accuracy and
    completion time are recomputed from its *own* size and queueing delay
    with the reference's op sequence (its float32/float64 mixing included);
    the class mean only steered the allocation.  ``pc_k``/``pe_k`` are the
    frame's congestion inflation factors, or ``None``.
    """
    tot = int(lens.sum())
    cellid = np.repeat(np.arange(ci.size), lens)
    intra = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
    base = info["off_s"][ci] + st
    midx = info["members_s"][base[cellid] + intra]
    jm = jj[cellid].astype(np.int64)
    lm = ll[cellid].astype(np.int64)
    svc_m = info["svc"][midx]
    cov_m = info["cov"][midx]
    A_m = info["A"][midx].astype(np.float32)
    C_m = info["C"][midx].astype(np.float32)
    Tq_m = info["tq"][midx].astype(np.float32)
    size_m = info["size"][midx].astype(np.float32)
    acc_m = spec.acc[svc_m, lm]
    proc_m = spec.proc_ms[jm, svc_m, lm]
    local_m = jm == cov_m
    transfer = size_m / spec.bandwidth_true
    comm = transfer + np.where(jm >= spec.n_edge, spec.cloud_extra_delay, 0.0)
    comm = np.where(local_m, 0.0, comm)
    ct = ((Tq_m + proc_m) + comm).astype(np.float32)
    if pc_k is not None:  # congested_ctime, per member
        comm_f = ct - proc_m - Tq_m
        ct = ct + proc_m * (pc_k[jm] - 1.0) + comm_f * (pe_k[cov_m] - 1.0)
    sat_m = (acc_m >= A_m) & (ct <= C_m)
    us_m = cfg.w_a * (acc_m - A_m) / cfg.max_as + cfg.w_c * (C_m - ct) / cfg.max_cs
    return tot, int(sat_m.sum()), float(us_m.sum())


def _build_hier_window(sources, spec, cfg, scn, t0: int, t1: int, quant, sw, pin: bool):
    """Host build of frames ``[t0, t1)`` of every replication for the
    class-aggregate fleet, frame-major (row ``k * n_rep + rep``): pull the
    buckets, aggregate each frame into sorted QoS classes, assemble the
    padded class grid with its member counts and stage it in host tensors
    (pinned when ``pin``).  Returns ``(t0, Tc, host, infos, n_arr)``: the
    leaves, the per-frame member bookkeeping (``None`` for an empty frame)
    and the ``(n_rep, Tc)`` arrival counts.  Pure numpy and the sources' own
    RNGs, so it runs the same inline or on a producer thread."""
    n_rep = len(sources)
    Tc = t1 - t0
    with sw.span("fleet/hier_build"):
        gb, eb = _frame_budgets_batch(spec, cfg, scn, (t0 + np.arange(Tc)) * cfg.frame_ms)
    with sw.span("fleet/arrivals"):
        per_rep = [src.take(t1) for src in sources]
    frames_rc, frame_starts, infos = [], [], []
    n_arr = np.zeros((n_rep, Tc), np.int32)
    n_cls = np.zeros((n_rep, Tc), np.int32)
    for k in range(Tc):
        frame_start = (t0 + k) * cfg.frame_ms
        for rep in range(n_rep):
            bucket = per_rep[rep][k]
            frame_starts.append(frame_start)
            n_arr[rep, k] = len(bucket)
            if not len(bucket):
                z = np.zeros(0)
                frames_rc.append(RequestColumns(
                    arrival_ms=z, cover=np.zeros(0, np.int64),
                    service=np.zeros(0, np.int64), A=z, C=z, size_bytes=z,
                ))
                infos.append(None)
                continue
            with sw.span("fleet/hier_aggregate"):
                rep_cols, info = _aggregate_frame(bucket, frame_start + cfg.frame_ms, quant)
            frames_rc.append(rep_cols)
            infos.append(info)
            n_cls[rep, k] = len(rep_cols)
    Cp = _pad_bucket_fine(int(n_cls.max()))
    with sw.span("fleet/grid_build"):
        budgets = [(gb[k], eb[k]) for k in range(Tc) for _ in range(n_rep)]
        arrays = _build_frame_batch(frames_rc, spec, cfg, frame_starts, budgets, Cp)
        count = np.zeros((Tc * n_rep, Cp), np.int32)
        for i, info in enumerate(infos):
            if info is not None:
                count[i, : info["count_s"].shape[0]] = info["count_s"]
        arrays["count"] = count
        host = {k: torch.from_numpy(x) for k, x in arrays.items()}
    if pin:
        with sw.span("fleet/pin"):
            host = {k: x.pin_memory() for k, x in host.items()}
    return t0, Tc, host, infos, n_arr


def _hier_device_inputs(host, dev):
    """A window's class grid on ``dev`` with its utility and feasibility:
    ``(inst, us, feas, count)``."""
    inst = FlatInstance(**{k: host[k].to(dev, non_blocking=True) for k in _FIELDS})
    return inst, us_tensor(inst), hard_feasible(inst), host["count"].to(dev, non_blocking=True)


def _simulate_fleet_hier(
    spec: ClusterSpec,
    cfg: SimConfig,
    scn: Scenario,
    sources: List[_RepFrameSource],
    *,
    n_rep: int,
    T: int,
    W: int,
    opts: EngineOptions,
    dev: torch.device,
    gen_s: float,
    sw: Stopwatch,
    t_run0: float,
) -> FleetResult:
    """Class-aggregate fleet for ``EngineOptions(scheduler="hierarchical")``,
    the reference's ``_simulate_fleet_hier`` (without admission control).

    Per window, on the host (inline or on the producer thread): each
    (replication, frame)'s arrivals are bucketed into QoS classes
    (:func:`~repro_torch.core.aggregation.aggregate_requests`), sorted by
    first member, and the count-weighted class representatives become one
    padded ``(Cp, M, L)`` class grid per frame (:func:`_build_frame_batch`,
    ``Cp`` from :func:`_pad_bucket_fine`), staged in pinned memory.  On the
    card: the grid's utility and feasibility, then the class allocator
    (:func:`~repro_torch.kernels.hier.hier_cells`) — one launch over all
    R x W frames of the window with congestion off (no frame depends on
    another), or a loop over the window's frames with congestion on, each
    against the backlog-reduced budgets and followed by the backlog step.
    Only the nonzero cells of ``take``/``start`` come back, one window
    behind the card, and every allocated member is accounted on the host
    (:func:`_member_accounting`) while the card runs the next window.
    Rows are frame-major (row ``k * n_rep + rep``).
    """
    ccfg = cfg.congestion
    M = spec.n_servers
    quant = QuantizationConfig()
    pin = dev.type == "cuda"
    reqs_per_rep = np.zeros(n_rep, np.int64)
    served_per_rep = np.zeros(n_rep, np.int64)
    sat_per_rep = np.zeros(n_rep, np.int64)
    us_sum_per_rep = np.zeros(n_rep, np.float64)
    phi_sum = 0.0
    phi_cnt = 0
    bg = torch.zeros((n_rep, M), dtype=torch.float32, device=dev)
    be = torch.zeros_like(bg)

    def build_window(t0: int):
        return _build_hier_window(sources, spec, cfg, scn, t0, min(t0 + W, T), quant, sw, pin)

    def dispatch(host, Tc):
        """Enqueue one window on the card; returns its device outputs."""
        nonlocal bg, be
        inst, us, feas, count = _hier_device_inputs(host, dev)
        if not ccfg.enabled:
            take, start = hier_cells(
                us, feas, inst.v, inst.u, inst.cover, count, inst.gamma, inst.eta,
                backend=opts.backend,
            )
            return take, start, None, None
        takes, starts, pcs, pes = [], [], [], []
        for k in range(Tc):
            sl = slice(k * n_rep, (k + 1) * n_rep)
            g, e = inst.gamma[sl], inst.eta[sl]
            t_k, s_k, w, c_load = hier_cells(
                us[sl], feas[sl], inst.v[sl], inst.u[sl], inst.cover[sl], count[sl],
                effective_capacity(g, bg), effective_capacity(e, be),
                backend=opts.backend, loads=True,
            )
            pcs.append(compute_inflation(bg + w, g, ccfg))
            pes.append(comm_inflation(be + c_load, e, ccfg))
            bg = step_backlog(bg, w, g, ccfg)
            be = step_backlog(be, c_load, e, ccfg)
            takes.append(t_k)
            starts.append(s_k)
        return torch.cat(takes), torch.cat(starts), torch.stack(pcs, 1), torch.stack(pes, 1)

    def fetch(outs):
        """The window's nonzero cells (row-major ``(frame, c, j, l)``) with
        their take and start, and the inflation factors, on the host."""
        take, start, pc, pe = outs
        nz = torch.nonzero(take)
        idx = nz.unbind(1)
        return (
            nz.cpu().numpy(), take[idx].cpu().numpy(), start[idx].cpu().numpy(),
            None if pc is None else pc.cpu().numpy(),
            None if pe is None else pe.cpu().numpy(),
        )

    def post(Tc, infos, n_arr, fetched):
        nonlocal phi_sum, phi_cnt
        nz, vals, starts, pc, pe = fetched
        with sw.span("fleet/hier_post"):
            if ccfg.enabled:  # pc: (n_rep, Tc, M), the reference's layout
                phi_sum += float(pc.sum())
                phi_cnt += pc.size
            reqs_per_rep[:] += n_arr.sum(1)
            bounds = np.searchsorted(nz[:, 0], np.arange(Tc * n_rep + 1))
            for rep in range(n_rep):
                for k in range(Tc):
                    i = k * n_rep + rep
                    lo, hi = bounds[i], bounds[i + 1]
                    if infos[i] is None or lo == hi:
                        continue
                    tot, n_sat, us_sum = _member_accounting(
                        spec, cfg, infos[i], nz[lo:hi, 1], nz[lo:hi, 2], nz[lo:hi, 3],
                        vals[lo:hi], starts[lo:hi],
                        None if pc is None else pc[rep, k], None if pe is None else pe[rep, k],
                    )
                    served_per_rep[rep] += tot
                    sat_per_rep[rep] += n_sat
                    us_sum_per_rep[rep] += us_sum

    window_starts = list(range(0, T, W))
    pipe = _WindowPipeline(build_window, window_starts, opts.prefetch, "fleet-hier-producer")
    pending = None
    try:
        for wi_t0 in window_starts:
            with sw.span("fleet/window_wait"):
                t0, Tc, host, infos, n_arr = pipe.next(wi_t0)
            with sw.span("fleet/dispatch"):
                # the previous window's results first (this waits for the
                # card), then the next window's work, so the card computes
                # while the host accounts the previous window
                fetched = fetch(pending[3]) if pending is not None else None
                outs = dispatch(host, Tc)
            if pending is not None:
                post(*pending[:3], fetched)
            pending = (Tc, infos, n_arr, outs)
        if pending is not None:
            with sw.span("fleet/dispatch"):
                fetched = fetch(pending[3])
            post(*pending[:3], fetched)
    finally:
        pipe.close()

    gen_s += sw.total("fleet/window_wait")
    timings = sw.as_dict()
    timings["total_s"] = time.perf_counter() - t_run0
    return FleetResult(
        n_rep=n_rep,
        n_frames=T,
        n_requests=int(reqs_per_rep.sum()),
        n_served=int(served_per_rep.sum()),
        satisfied_per_rep=100.0 * sat_per_rep / np.maximum(reqs_per_rep, 1),
        mean_us_per_rep=us_sum_per_rep / np.maximum(reqs_per_rep, 1),
        final_backlog_per_rep=bg.cpu().numpy() if ccfg.enabled else None,
        mean_compute_inflation=phi_sum / phi_cnt if ccfg.enabled and phi_cnt else 1.0,
        n_devices=1,
        window=W,
        dispatch_s=sw.total("fleet/dispatch"),
        gen_s=gen_s,
        prefetch=opts.prefetch if pipe.thread is not None else 0,
        timings=timings,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )


def demo_cluster_spec(
    n_edge: int = 4,
    n_cloud: int = 1,
    n_services: int = 3,
    n_variants: int = 3,
    seed: int = 0,
) -> ClusterSpec:
    """A small heterogeneous cluster for examples, sweeps and smoke tests,
    drawn exactly as the reference's (deterministic given ``seed``)."""
    rng = np.random.default_rng(seed)
    M = n_edge + n_cloud
    K, L = n_services, n_variants

    rel = np.geomspace(0.3, 1.0, L)
    acc = np.linspace(55.0, 85.0, L)[None, :] + rng.normal(0.0, 1.5, (K, L))
    acc = np.clip(np.sort(acc, axis=1), 1.0, 99.0).astype(np.float32)

    proc = np.empty((M, K, L), np.float32)
    placed = np.zeros((M, K, L), bool)
    for j in range(M):
        is_cloud = j >= n_edge
        base = 300.0 if is_cloud else rng.uniform(900.0, 1400.0)
        proc[j] = base * rel[None, :] * rng.uniform(0.95, 1.05, (K, L))
        placed[j] = True
        if not is_cloud and L > 1:
            placed[j, :, L - 1] = False  # biggest variant is cloud-only

    gamma = np.where(np.arange(M) >= n_edge, 12_000.0, 3900.0).astype(np.float32)
    eta = np.where(np.arange(M) >= n_edge, 3500.0, 350.0).astype(np.float32)
    return ClusterSpec(
        n_edge=n_edge,
        n_cloud=n_cloud,
        gamma_frame=gamma,
        eta_frame=eta,
        proc_ms=proc,
        placed=placed,
        acc=acc,
    )
