"""Time-slotted edge-cluster simulators: the paper's sequential testbed
(:func:`simulate`) and the Monte-Carlo fleet (:func:`simulate_fleet`).

The PyTorch counterpart of ``repro.core.simulator``.

**The sequential testbed** (:func:`simulate`, the reference's
``simulate``) replays the paper's Sec. IV protocol one decision at a time:
arrivals queue at their covering edge (``queue_cap`` each; a full queue
fires the decision early), budgets deplete within a wall-clock frame, the
scheduler sees an EMA estimate of the bandwidth, and realized delays draw
from a lognormal channel.  All of that accounting stays on the host in
numpy float64, op for op the reference's, with one ``default_rng(seed)``
drawing trace, mobility and channel in the reference's order.  Only the
decision goes to ``device``: each frame, padded to a power-of-two bucket,
is one B=1 launch of the GUS kernel for every GUS-cored policy, and its
``j``/``l`` come back once per decision.  The host policies (``ilp``,
``lp-bound``, ``gus-hier``) schedule the unpadded frame on the CPU.

**The fleet** (:func:`simulate_fleet`): R independent replications of a
scenario, each a sequence of T frame-synchronous decisions, in one of two
scheduling layouts.

**Dense** (the default):

1. Each replication's arrivals are drawn on the host in numpy
   (:class:`_RepFrameSource`, the reference's RNG order, both ``rng_mode``s,
   materialized or streamed).
2. Every (replication, frame) pair becomes one padded ``FlatInstance``: the
   (N requests x M servers x L variants) candidate grid, built on the host
   for a whole window of frames at once (:func:`_build_frame_batch`) and
   moved to the card once per window from pinned memory.
3. The scheduler runs over the replication batch.  With congestion on (or
   a ``stateful`` policy), a Python loop over the window's frames applies
   the backlog-reduced budgets, calls the policy and updates the carry
   (:func:`_step`); otherwise the carry is inert, and one call schedules
   all R x W frames of the window — the same assignments, because no frame
   then depends on another.  A ``needs_key`` policy gets the reference's
   key for each (replication, frame).  The host policies run on
   :func:`_simulate_fleet_host` instead: unpadded frames scheduled on the
   CPU one by one, re-padded with drops.
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
ROADMAP.md item): impairments and admission control, the metric stream and
``devices>1``.
"""
from __future__ import annotations

import dataclasses
import functools
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.obs.trace import Stopwatch

from repro_torch.kernels.hier import hier_cells

from . import prng
from .aggregation import QuantizationConfig, aggregate_requests
from .extensions import apply_mobility, as_batch
from .impairments import AdmissionConfig, ImpairmentConfig
from .instance import FlatInstance, pad_instance, resolve_device, stack_instances
from .options import EngineOptions, check_ported, resolve_options
from .policies import Policy, get_policy
from .queueing import (
    CongestionConfig,
    PolicyCarry,
    comm_inflation,
    committed_loads,
    compute_inflation,
    congested_ctime,
    effective_capacity,
    ema_update,
    fleet_policy_carry,
    init_policy_carry,
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
    "SimResult",
    "FleetResult",
    "EngineOptions",
    "simulate",
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
class SimResult:
    """The sequential testbed's result, field for field the reference's
    (the per-decision metric stream is not ported yet: ROADMAP.md §1
    item 5)."""

    n_requests: int
    n_served: int
    n_satisfied: int
    n_local: int
    n_cloud: int
    n_edge_offload: int
    n_dropped: int
    mean_us: float
    mean_completion_ms: float
    mean_queue_ms: float
    bandwidth_estimates: List[float]
    #: work accounting of the congestion model (None when disabled)
    congestion_stats: Optional[Dict[str, float]] = None
    #: fault-injection accounting (None: impairments and admission control
    #: are not ported, so always None here)
    resilience_stats: Optional[Dict[str, float]] = None
    #: wall-clock seconds per phase: ``gen_s`` arrival generation / stream
    #: pulls, ``build_s`` frame building, ``sched_s`` scheduler calls (on
    #: the card: the H2D copy, the launch and the wait for ``j``/``l``),
    #: ``realize_s`` realized-delay accounting, ``total_s`` end to end
    timings: Optional[Dict[str, float]] = None

    @property
    def satisfied_pct(self) -> float:
        return 100.0 * self.n_satisfied / max(self.n_requests, 1)

    @property
    def local_pct(self) -> float:
        return 100.0 * self.n_local / max(self.n_requests, 1)

    @property
    def cloud_pct(self) -> float:
        return 100.0 * self.n_cloud / max(self.n_requests, 1)

    @property
    def edge_offload_pct(self) -> float:
        return 100.0 * self.n_edge_offload / max(self.n_requests, 1)

    def as_dict(self) -> Dict[str, float]:
        d = {
            "n_requests": self.n_requests,
            "satisfied_pct": self.satisfied_pct,
            "local_pct": self.local_pct,
            "cloud_pct": self.cloud_pct,
            "edge_offload_pct": self.edge_offload_pct,
            "dropped_pct": 100.0 * self.n_dropped / max(self.n_requests, 1),
            "mean_us": self.mean_us,
            "mean_completion_ms": self.mean_completion_ms,
            "mean_queue_ms": self.mean_queue_ms,
        }
        if self.congestion_stats is not None:
            d["mean_compute_inflation"] = self.congestion_stats["mean_compute_inflation"]
            d["final_backlog_gamma"] = self.congestion_stats["final_backlog_gamma"]
        return d


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


def _apply_mobility_inplace(reqs, n_edge: int, move_prob: float, rng) -> None:
    """Re-attach each pending request's covering edge with prob ``move_prob``
    (two draws of ``len(reqs)``, none when the frame is empty, either layout)."""
    if move_prob <= 0 or not reqs:
        return
    if isinstance(reqs, RequestColumns):
        reqs.cover = apply_mobility(
            reqs.cover.astype(np.int32), n_edge, move_prob, rng
        ).astype(np.int64)
        return
    cov = apply_mobility(np.array([r.cover for r in reqs], np.int32), n_edge, move_prob, rng)
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


def _frame_budgets(spec: ClusterSpec, cfg: SimConfig, scn: Scenario, frame_start_ms: float):
    """Fresh float64 ``(gamma, eta)`` budgets of one frame: the window
    version at one frame start, which the reference's docstring states is
    bit-identical to its scalar ``_frame_budgets``."""
    g, e = _frame_budgets_batch(spec, cfg, scn, np.array([frame_start_ms], np.float64))
    return g[0].copy(), e[0].copy()


def _build_frame_instance(
    reqs, spec: ClusterSpec, cfg: SimConfig, now_ms: float, bw_est: float, max_cs: float,
    gamma, eta,
) -> FlatInstance:
    """The unpadded ``FlatInstance`` of the requests pending at ``now_ms``,
    on the CPU, priced with the scheduler's bandwidth estimate ``bw_est``
    (the reference's ``_build_frame_instance``: float64 host math narrowed
    to float32 at the same points)."""
    N = len(reqs)
    arr = _frame_arrays(reqs, spec, cfg, now_ms, bw_est)
    f32 = np.float32
    return FlatInstance.from_numpy(dict(
        cover=arr["cover"], A=arr["A"], C=arr["C"],
        w_a=np.full((N,), cfg.w_a, f32), w_c=np.full((N,), cfg.w_c, f32),
        acc=np.asarray(arr["acc"], f32), ctime=np.asarray(arr["ctime"], f32),
        v=np.asarray(arr["v"], f32), u=np.asarray(arr["u"], f32), avail=arr["avail"],
        gamma=np.asarray(gamma, f32), eta=np.asarray(eta, f32),
        max_as=f32(cfg.max_as), max_cs=f32(max_cs),
    ), "cpu")


def _inflation_host(fn, load: np.ndarray, budget: np.ndarray, ccfg: CongestionConfig):
    """A float32 inflation formula on host float64 loads and budgets, cast
    to float32 where the reference's x32 arrays cast them."""
    return fn(
        torch.from_numpy(np.asarray(load, np.float32)),
        torch.from_numpy(np.asarray(budget, np.float32)), ccfg,
    ).numpy()


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


def _step(call, frame: FlatInstance, carry, ccfg: CongestionConfig, keys=None):
    """One frame over the replication batch: schedule (against the
    backlog-reduced budgets when congestion is on), then inflate and roll
    the backlog/EMA carry.  ``call(run, carry, keys) -> (Assignment,
    carry)`` is the bound policy in its mode.  Returns ``(carry, a, pc,
    pe)``, the inflation factors ``None`` with congestion off."""
    if not ccfg.enabled:
        a, carry = call(frame, carry, keys)
        return carry, a, None, None
    run = dataclasses.replace(
        frame,
        gamma=effective_capacity(frame.gamma, carry.backlog_gamma),
        eta=effective_capacity(frame.eta, carry.backlog_eta),
    )
    a, carry = call(run, carry, keys)
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


def _fold_hier_scheduler(policy, opts: EngineOptions, allow_backend: bool = False) -> Policy:
    """The hierarchical layout *is* the reference's ``gus-hier`` policy, so
    it composes only with ``"gus"`` or ``"gus-hier"`` (by name or as a
    :class:`Policy`); any other policy is an error, not a silent override.
    ``allow_backend=True`` (the fleet) lets ``backend=`` through, where it
    picks the class allocator's implementation; :func:`simulate`'s per-frame
    ``gus-hier`` is host-side, so there it raises.  Returns the policy."""
    pol = get_policy(policy)
    if opts.backend is not None and not allow_backend:
        raise ValueError(
            f"backend={opts.backend!r} with EngineOptions(scheduler='hierarchical') "
            "selects the device allocator, which only the fleet path runs — use "
            "simulate_fleet (simulate's hier path is host-side)"
        )
    if pol.name not in ("gus", "gus-hier"):
        raise ValueError(
            "EngineOptions(scheduler='hierarchical') maps to the 'gus-hier' "
            f"policy; it does not compose with policy {pol.name!r}"
        )
    return get_policy("gus-hier")


def _bind_policy(pol: Policy, spec: ClusterSpec, backend: Optional[str]) -> Callable:
    """``pol.bind`` with ``backend=`` folded in: it picks the GUS
    implementation and composes only with the ``"gus"`` policy (the other
    GUS-cored policies follow ``REPRO_TORCH_GUS_BACKEND``)."""
    fn = pol.bind(spec.n_edge, spec.n_servers)
    if backend is None:
        return fn
    if pol.name != "gus":
        raise ValueError(
            f"backend={backend!r} selects the GUS implementation; policy {pol.name!r} "
            "does not take it (set REPRO_TORCH_GUS_BACKEND to steer GUS-cored "
            "policies process-wide)"
        )
    return functools.partial(fn, backend=backend)


def _carry_to_device(carry: PolicyCarry, dev) -> PolicyCarry:
    """The host carry on ``dev`` with a leading batch axis of one, in one
    host-to-device copy: the float fields travel packed and come out as
    views.  The key stays on the host."""
    names = [f.name for f in dataclasses.fields(carry) if f.name != "key"]
    parts = [getattr(carry, n) for n in names]
    packed = torch.cat([x.reshape(-1) for x in parts]).to(dev)
    out = {"key": carry.key[None]}
    for n, x, y in zip(names, parts, packed.split([x.numel() for x in parts])):
        out[n] = y.view((1,) + tuple(x.shape))
    return PolicyCarry(**out)


def _carry_from_device(host: PolicyCarry, c_in: PolicyCarry, c_out: PolicyCarry) -> PolicyCarry:
    """The policy's carry ``c_out`` back on the host without its batch
    axis; a field the policy handed back as it got it (``c_in``) keeps the
    host's tensor and makes no copy."""
    out = {}
    for f in dataclasses.fields(host):
        x = getattr(c_out, f.name)
        out[f.name] = getattr(host, f.name) if x is getattr(c_in, f.name) else x[0].cpu()
    return PolicyCarry(**out)


class _ArrivalSource:
    """Uniform pull interface over the two arrival engines: the materialized
    trace (drawn up front from the simulator's own generator) or an
    :class:`~repro_torch.core.streaming.ArrivalStream` (``n_total`` counts
    submissions as they are emitted)."""

    def __init__(self, reqs=None, stream: Optional[ArrivalStream] = None,
                 limit: Optional[int] = None):
        self._reqs = reqs
        self._idx = 0
        self._stream = stream
        self._limit = limit
        self._emitted = 0

    def pull(self, t_ms: float) -> List:
        """All not-yet-pulled arrivals with ``arrival_ms < t_ms``."""
        if self._stream is None:
            out = []
            while self._idx < len(self._reqs) and self._reqs[self._idx].arrival_ms < t_ms:
                out.append(self._reqs[self._idx])
                self._idx += 1
            return out
        if self._limit is not None and self._emitted >= self._limit:
            return []
        out = self._stream.take_until(t_ms)
        if self._limit is not None and self._emitted + len(out) > self._limit:
            out = out[: self._limit - self._emitted]
        self._emitted += len(out)
        return out

    @property
    def exhausted(self) -> bool:
        if self._stream is None:
            return self._idx >= len(self._reqs)
        return self._stream.exhausted or (
            self._limit is not None and self._emitted >= self._limit
        )

    @property
    def n_total(self) -> int:
        """Total submissions (call after the run for the streaming source)."""
        return len(self._reqs) if self._stream is None else self._emitted


def simulate(
    spec: ClusterSpec,
    cfg: SimConfig,
    *,
    policy: Union[str, Policy] = "gus",
    scenario: Union[str, Scenario] = "paper-default",
    seed: int = 0,
    n_requests: Optional[int] = None,
    options: Optional[EngineOptions] = None,
    device=None,
) -> SimResult:
    """Run the virtual testbed (the reference's ``simulate``), deciding on
    ``device``.

    The signature mirrors :func:`simulate_fleet`: ``policy`` names a
    registered :class:`~repro_torch.core.policies.Policy` (or passes one)
    and ``options`` carries the engine options.  The reference's deprecated
    per-call keywords (``streaming=``, ``rng_mode=``, ``backend=``,
    ``metrics=``) and its raw scheduler callables are not taken: pass
    ``EngineOptions`` and a ``Policy``.  Fleet-only options are ignored.

    Everything but the decision runs on the host in numpy float64, op for
    op the reference's: queue-cap admission with early decisions, budgets
    that deplete within a wall-clock frame, the EMA bandwidth estimator,
    mobility, the congestion backlogs and inflation, and one
    ``default_rng(seed)`` for trace, mobility and channel in the reference's
    draw order.  Each decision pads the frame to a power-of-two bucket,
    moves it to ``device`` and makes one B=1 call of the policy (the GUS
    kernel for the GUS-cored policies); its ``j``/``l`` come back to the
    host.  ``random`` gets a fresh key per decision split from the carry's
    threefry chain (seeded by ``seed``), ``gus-adaptive`` the carry, and the
    host policies (``ilp``, ``lp-bound``, ``gus-hier``) the unpadded frame
    on the CPU.  ``EngineOptions(scheduler="hierarchical")`` maps to
    ``gus-hier``.

    ``device=None`` means ``"cuda"`` (raises without a CUDA device).
    Impairments and admission control (ROADMAP.md §1 item 3) and
    ``metrics=True`` (item 5) raise ``NotImplementedError``.  If
    ``n_requests`` is given, arrivals stop after that many submissions (the
    x-axis of the paper's Fig. 1(e)-(h)).
    """
    dev = resolve_device(device)
    scn = get_scenario(scenario)
    opts = resolve_options(options, scenario=scn)
    check_ported(opts, fleet=False)
    _not_ported(cfg)
    if opts.scheduler == "hierarchical":
        pol = _fold_hier_scheduler(policy, opts)
        scheduler = pol.bind(spec.n_edge, spec.n_servers)
    else:
        pol = get_policy(policy)
        scheduler = _bind_policy(pol, spec, opts.backend)
    stateful = pol.stateful
    needs_key = pol.needs_key and not pol.stateful
    on_device = pol.vmappable
    ccfg = cfg.congestion
    rng = np.random.default_rng(seed)
    M, K, L = spec.proc_ms.shape
    move_prob = cfg.move_prob if scn.move_prob is None else scn.move_prob

    sw = Stopwatch()
    t_run0 = time.perf_counter()

    if opts.streaming:
        source = _ArrivalSource(
            stream=ArrivalStream(scn, seed, spec.n_edge, K, cfg, rng_mode=opts.rng_mode),
            limit=n_requests,
        )
    else:
        with sw.span("sim/generate_trace"):
            reqs = scn.generate_arrivals(rng, spec.n_edge, K, cfg, rng_mode=opts.rng_mode)
        if n_requests is not None:
            reqs = reqs[:n_requests]
        source = _ArrivalSource(reqs=reqs)

    # the carry lives on the host; a stateful policy gets it on the device
    carry = init_policy_carry(M, seed=seed, bandwidth_init=cfg.bandwidth_init, device="cpu")
    bw_prev = bw_cur = cfg.bandwidth_init
    bw_log = [bw_cur]
    max_cs = cfg.max_cs

    n_served = n_sat = n_local = n_cloud = n_eo = n_drop = 0
    us_sum = 0.0
    comp_sum = 0.0
    q_sum = 0.0
    pending: List = []
    buffer: deque = deque()
    t = 0.0
    is_cloud = spec.is_cloud()

    # congestion state (numpy, float64 like the budgets)
    backlog_g = np.zeros(M)
    backlog_e = np.zeros(M)
    committed_g = np.zeros(M)
    committed_e = np.zeros(M)
    drained_g = drained_e = 0.0
    infl_sum = 0.0
    infl_max = 1.0
    infl_n = 0

    def _drain(backlog, committed, budget):
        """One frame-boundary backlog step in float64: ``(new_backlog,
        drained)``, the fleet's :func:`step_backlog` formula."""
        new = np.maximum(backlog + committed - budget * ccfg.drain, 0.0)
        return new, float(np.sum(backlog + committed - new))

    # capacity budgets deplete WITHIN a wall-clock frame (queue-full decisions
    # fire early but do not refresh gamma/eta — they share the frame budget)
    frame_budget_g, frame_budget_e = _frame_budgets(spec, cfg, scn, 0.0)
    rem_gamma = frame_budget_g.copy()
    rem_eta = frame_budget_e.copy()
    frame_boundary = cfg.frame_ms

    while t < cfg.horizon_ms + 10 * cfg.frame_ms:
        frame_end = t + cfg.frame_ms
        # admit arrivals in this frame; queue_cap per covering server
        qlen = {e: sum(1 for r in pending if r.cover == e) for e in range(spec.n_edge)}
        early_close = None
        with sw.span("sim/arrival_pull"):
            buffer.extend(source.pull(frame_end))
        while buffer:
            r = buffer[0]
            if qlen.get(r.cover, 0) >= cfg.queue_cap:
                # queue full -> decision fires early (paper testbed behaviour)
                early_close = r.arrival_ms
                break
            pending.append(buffer.popleft())
            qlen[r.cover] = qlen.get(r.cover, 0) + 1
        decision_time = early_close if early_close is not None else frame_end
        if decision_time >= frame_boundary:  # new wall-clock frame: budgets refresh
            frame_boundary += cfg.frame_ms * np.ceil(
                (decision_time - frame_boundary + 1e-9) / cfg.frame_ms
            )
            if ccfg.enabled:
                ema = ema_update(
                    carry.ema_util, torch.from_numpy(committed_g.astype(np.float32)),
                    torch.from_numpy(frame_budget_g.astype(np.float32)), ccfg,
                )
                backlog_g, dg = _drain(backlog_g, committed_g, frame_budget_g)
                backlog_e, de = _drain(backlog_e, committed_e, frame_budget_e)
                drained_g += dg
                drained_e += de
                committed_g = np.zeros(M)
                committed_e = np.zeros(M)
                carry = dataclasses.replace(
                    carry,
                    backlog_gamma=torch.from_numpy(backlog_g.astype(np.float32)),
                    backlog_eta=torch.from_numpy(backlog_e.astype(np.float32)),
                    ema_util=ema,
                )
            frame_budget_g, frame_budget_e = _frame_budgets(
                spec, cfg, scn, frame_boundary - cfg.frame_ms
            )
            if ccfg.enabled:
                rem_gamma = np.maximum(frame_budget_g - backlog_g, 0.0)
                rem_eta = np.maximum(frame_budget_e - backlog_e, 0.0)
            else:
                rem_gamma = frame_budget_g.copy()
                rem_eta = frame_budget_e.copy()

        if pending:
            _apply_mobility_inplace(pending, spec.n_edge, move_prob, rng)
            bw_est = 0.5 * (bw_cur + bw_prev)  # E[B_{t+1}] = (B_t + B_{t-1})/2
            n_real = len(pending)
            with sw.span("sim/frame_build"):
                inst = _build_frame_instance(
                    pending, spec, cfg, decision_time, bw_est, max_cs,
                    gamma=rem_gamma, eta=rem_eta,
                )
                # padded rows are infeasible -> dropped; the host policies
                # see the raw frame
                frame_inst = pad_instance(inst, _pad_bucket(n_real)) if pol.pad else inst
            with sw.span("sim/schedule"):
                # a batched policy takes the frame as a batch of one on the
                # device; a host policy the frame itself
                frame = as_batch(frame_inst)[0].to(dev) if on_device else frame_inst
                if stateful:
                    c_in = _carry_to_device(carry, dev) if on_device else carry
                    assign, c_out = scheduler(frame, c_in)
                    carry = _carry_from_device(carry, c_in, c_out) if on_device else c_out
                elif needs_key:
                    # split order matches the reference's chain:
                    # (next, sub) = split(key)
                    nxt, sub = prng.split(carry.key.numpy(), 2)
                    carry = dataclasses.replace(carry, key=torch.from_numpy(nxt))
                    assign = scheduler(frame, sub[None] if on_device else sub)
                else:
                    assign = scheduler(frame)
                aj, al = (assign.j[0], assign.l[0]) if on_device else (assign.j, assign.l)
                # the copy back waits for the card, so the span times the
                # decision itself, not just its launch
                jv = aj.cpu().numpy()[:n_real]
                lv = al.cpu().numpy()[:n_real]

            with sw.span("sim/realize"):
                # pass 1 — capacity commit (shared frame budget + backlog
                # growth)
                for idx, r in enumerate(pending):
                    j, l = int(jv[idx]), int(lv[idx])
                    if j < 0:
                        continue
                    local = j == r.cover
                    rem_gamma[j] -= spec.proc_ms[j, r.service, l]
                    committed_g[j] += spec.proc_ms[j, r.service, l]
                    if not local:
                        rem_eta[r.cover] -= r.size_bytes / 1024.0
                        committed_e[r.cover] += r.size_bytes / 1024.0

                # the whole decision batch shares one inflation factor,
                # computed from the wall-clock frame's committed-so-far load
                if ccfg.enabled:
                    phi_c = _inflation_host(
                        compute_inflation, backlog_g + committed_g, frame_budget_g, ccfg
                    )
                    phi_e = _inflation_host(
                        comm_inflation, backlog_e + committed_e, frame_budget_e, ccfg
                    )
                    infl_sum += float(phi_c.sum())
                    infl_max = max(infl_max, float(phi_c.max()), float(phi_e.max()))
                    infl_n += M

                # pass 2 — realized delays and stats (the reference's RNG
                # draw order)
                observed_bw = []
                for idx, r in enumerate(pending):
                    j, l = int(jv[idx]), int(lv[idx])
                    if j < 0:
                        n_drop += 1
                        continue
                    n_served += 1
                    local = j == r.cover
                    proc = spec.proc_ms[j, r.service, l] * rng.lognormal(0.0, cfg.proc_sigma)
                    if local:
                        comm = 0.0
                    else:
                        bw_real = spec.bandwidth_true * rng.lognormal(0.0, cfg.channel_sigma)
                        extra = 0.0
                        comm = r.size_bytes / bw_real + extra + (
                            spec.cloud_extra_delay if is_cloud[j] else 0.0
                        )
                        # the estimator observes the *channel* (uninflated
                        # transfer)
                        observed_bw.append(r.size_bytes / max(comm - extra - (spec.cloud_extra_delay if is_cloud[j] else 0.0), 1e-6))
                    if ccfg.enabled:
                        proc = proc * phi_c[j]
                        comm = comm * phi_e[r.cover]
                    tq = decision_time - r.arrival_ms
                    ct = tq + proc + comm
                    acc = spec.acc[r.service, l]
                    sat = (ct <= r.C) and (acc >= r.A)
                    n_sat += int(sat)
                    n_local += int(local)
                    n_cloud += int((not local) and is_cloud[j])
                    n_eo += int((not local) and (not is_cloud[j]))
                    us_sum += cfg.w_a * (acc - r.A) / cfg.max_as + cfg.w_c * (r.C - ct) / max_cs
                    comp_sum += ct
                    q_sum += tq
                    if cfg.adapt_max_cs:
                        max_cs = max(max_cs, ct)
                pending = []
                if observed_bw:
                    bw_prev, bw_cur = bw_cur, float(np.mean(observed_bw))
                    bw_log.append(0.5 * (bw_cur + bw_prev))
                    carry = dataclasses.replace(
                        carry,
                        bw_prev=torch.tensor(bw_prev, dtype=torch.float32),
                        bw_cur=torch.tensor(bw_cur, dtype=torch.float32),
                    )

        t = decision_time if early_close is not None else frame_end
        if source.exhausted and not buffer and not pending:
            break

    congestion_stats = None
    if ccfg.enabled:
        # flush the last frame's committed work through one more drain step so
        # the conservation identity (enqueued == drained + carried) closes
        backlog_g, dg = _drain(backlog_g, committed_g, frame_budget_g)
        backlog_e, de = _drain(backlog_e, committed_e, frame_budget_e)
        drained_g += dg
        drained_e += de
        congestion_stats = {
            "work_enqueued_gamma": drained_g + float(backlog_g.sum()),
            "work_drained_gamma": drained_g,
            "work_enqueued_eta": drained_e + float(backlog_e.sum()),
            "work_drained_eta": drained_e,
            "final_backlog_gamma": float(backlog_g.sum()),
            "final_backlog_eta": float(backlog_e.sum()),
            "mean_compute_inflation": (infl_sum / infl_n) if infl_n else 1.0,
            "max_inflation": infl_max,
        }

    n_total = source.n_total
    timings = {
        "gen_s": sw.total("sim/generate_trace", "sim/arrival_pull"),
        "build_s": sw.total("sim/frame_build"),
        "sched_s": sw.total("sim/schedule"),
        "realize_s": sw.total("sim/realize"),
        "total_s": time.perf_counter() - t_run0,
    }
    return SimResult(
        n_requests=n_total,
        n_served=n_served,
        n_satisfied=n_sat,
        n_local=n_local,
        n_cloud=n_cloud,
        n_edge_offload=n_eo,
        n_dropped=n_total - n_served,
        mean_us=us_sum / max(n_total, 1),
        mean_completion_ms=comp_sum / max(n_served, 1),
        mean_queue_ms=q_sum / max(n_served, 1),
        bandwidth_estimates=bw_log,
        congestion_stats=congestion_stats,
        timings=timings,
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

    Every registered policy runs: a ``needs_key`` policy (``random``) gets
    the reference's key for each (replication, frame), ``split(PRNGKey(
    seed), n_rep * T)``; a ``stateful`` one (``gus-adaptive``) the carry,
    frame by frame; the host policies (``ilp``, ``lp-bound``, ``gus-hier``)
    run on :func:`_simulate_fleet_host`, on the CPU.

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
        pol = _fold_hier_scheduler(policy, opts, allow_backend=True)
    else:
        pol = get_policy(policy)
        fn = _bind_policy(pol, spec, opts.backend)
    host_side = not hier and (not pol.vmappable or not pol.pad)
    ccfg = cfg.congestion
    T = max(1, int(np.ceil(cfg.horizon_ms / cfg.frame_ms)))
    K = spec.proc_ms.shape[1]
    M = spec.n_servers
    W = T if opts.window is None else max(1, min(int(opts.window), T))
    # a streamed trace is drawn a window at a time when windows are shorter
    # than the horizon (the host policies' loop takes every frame at once),
    # and materialized in one drain otherwise
    lazy = opts.streaming and W < T and not host_side
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
    if host_side:
        return _simulate_fleet_host(
            spec, cfg, scn, pol, sources, n_rep=n_rep, T=T, n_pad=n_pad, seed=seed,
            gen_s=gen_s, sw=sw, t_run0=t_run0,
        )
    carry = fleet_policy_carry(
        n_rep, M, seed=seed, bandwidth_init=spec.bandwidth_true, device=dev
    )
    stateful = pol.stateful
    needs_key = pol.needs_key and not stateful
    # one key per (replication, frame), the reference's grid
    keys_all = (
        prng.split(prng.PRNGKey(seed), n_rep * T).reshape(n_rep, T, 2) if needs_key else None
    )

    def call(run, carry, keys):
        if stateful:
            return fn(run, carry)
        if needs_key:
            return fn(run, keys), carry
        return fn(run), carry

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
                if ccfg.enabled or stateful:
                    js, ls, pcs, pes = [], [], [], []
                    for k in range(Tc):
                        sl = slice(k * n_rep, (k + 1) * n_rep)
                        frame = FlatInstance(**{f: getattr(inst, f)[sl] for f in _FIELDS})
                        carry, a, pc, pe = _step(
                            call, frame, carry, ccfg,
                            None if keys_all is None else keys_all[:, t0 + k],
                        )
                        js.append(a.j)
                        ls.append(a.l)
                        pcs.append(pc)
                        pes.append(pe)
                    aj, al = torch.cat(js), torch.cat(ls)
                else:
                    # frame-major rows: frame t0 + k of replication r at k * n_rep + r
                    keys = (None if keys_all is None
                            else keys_all[:, t0:t1].transpose(1, 0, 2).reshape(-1, 2))
                    a, _ = call(inst, carry, keys)
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


def _simulate_fleet_host(
    spec: ClusterSpec,
    cfg: SimConfig,
    scn: Scenario,
    pol: Policy,
    sources: List[_RepFrameSource],
    *,
    n_rep: int,
    T: int,
    n_pad: int,
    seed: int,
    gen_s: float,
    sw: Stopwatch,
    t_run0: float,
) -> FleetResult:
    """The fleet for the host policies (``vmappable=False`` or
    ``pad=False``: ``ilp``, ``lp-bound``, ``gus-hier``), the reference's
    ``_simulate_fleet_host``: each *unpadded* frame is scheduled on the CPU
    in a Python loop that threads each replication's carry frame by frame,
    and the assignments are re-padded with drops so the scoring is the
    dense path's.  Everything runs on the host; rows are replication-major
    (row ``rep * T + frame``)."""
    ccfg = cfg.congestion
    M = spec.n_servers
    fleet_frames = []
    with sw.span("fleet/arrivals"):
        for src in sources:
            fleet_frames.extend(src.take(T))
    raw_insts = []
    n_real = np.array([len(b) for b in fleet_frames], np.int32)
    tq_flat = np.zeros((len(fleet_frames), n_pad), np.float32)
    with sw.span("fleet/grid_build"):
        for i, bucket in enumerate(fleet_frames):
            frame_start = (i % T) * cfg.frame_ms
            gamma, eta = _frame_budgets(spec, cfg, scn, frame_start)
            raw_insts.append(_build_frame_instance(
                bucket, spec, cfg, frame_start + cfg.frame_ms, spec.bandwidth_true,
                cfg.max_cs, gamma=gamma, eta=eta,
            ))
            if len(bucket):
                if isinstance(bucket, RequestColumns):
                    tq_flat[i, : len(bucket)] = frame_start + cfg.frame_ms - bucket.arrival_ms
                else:
                    tq_flat[i, : len(bucket)] = [
                        frame_start + cfg.frame_ms - r.arrival_ms for r in bucket
                    ]
        batch = stack_instances([pad_instance(r, n_pad) for r in raw_insts])

    fn = pol.bind(spec.n_edge, spec.n_servers)
    keys = (
        prng.split(prng.PRNGKey(seed), len(raw_insts))
        if pol.needs_key and not pol.stateful else None
    )
    jv = np.full((len(raw_insts), n_pad), -1, np.int32)
    lv = np.full((len(raw_insts), n_pad), -1, np.int32)
    phi_c = np.ones((len(raw_insts), M), np.float32)
    phi_e = np.ones((len(raw_insts), M), np.float32)
    final_backlog = np.zeros((n_rep, M), np.float32)
    with sw.span("fleet/schedule_host"):
        for rep in range(n_rep):
            carry = init_policy_carry(
                M, seed=seed + rep, bandwidth_init=spec.bandwidth_true, device="cpu"
            )
            for tf in range(T):
                i = rep * T + tf
                inst, n = raw_insts[i], n_real[i]
                if ccfg.enabled:
                    run_inst = dataclasses.replace(
                        inst,
                        gamma=effective_capacity(inst.gamma, carry.backlog_gamma),
                        eta=effective_capacity(inst.eta, carry.backlog_eta),
                    )
                else:
                    run_inst = inst
                if pol.stateful:
                    a, carry = fn(run_inst, carry)
                elif keys is not None:
                    a = fn(run_inst, keys[i])
                else:
                    a = fn(run_inst)
                jv[i, :n] = a.j.cpu().numpy()
                lv[i, :n] = a.l.cpu().numpy()
                if ccfg.enabled:
                    w, c = committed_loads(inst, a.j.cpu(), a.l.cpu())
                    phi_c[i] = compute_inflation(
                        carry.backlog_gamma + w, inst.gamma, ccfg).numpy()
                    phi_e[i] = comm_inflation(carry.backlog_eta + c, inst.eta, ccfg).numpy()
                    carry = dataclasses.replace(
                        carry,
                        backlog_gamma=step_backlog(carry.backlog_gamma, w, inst.gamma, ccfg),
                        backlog_eta=step_backlog(carry.backlog_eta, c, inst.eta, ccfg),
                        ema_util=ema_update(carry.ema_util, w, inst.gamma, ccfg),
                    )
            final_backlog[rep] = carry.backlog_gamma.numpy()

    aj, al = torch.from_numpy(jv), torch.from_numpy(lv)
    if ccfg.enabled:
        mbatch = dataclasses.replace(
            batch,
            ctime=congested_ctime(
                batch, torch.from_numpy(tq_flat), torch.from_numpy(phi_c),
                torch.from_numpy(phi_e),
            ),
        )
    else:
        mbatch = batch
    real = np.arange(n_pad)[None, :] < n_real[:, None]
    sat = satisfied_mask(mbatch, aj, al).numpy() & real      # (R*T, n_pad)
    us = mean_us(mbatch, aj, al).numpy()                      # (R*T,)
    served = (jv >= 0) & real

    timings = sw.as_dict()
    timings["total_s"] = time.perf_counter() - t_run0
    reqs_per_rep = n_real.reshape(n_rep, T).sum(1)
    sat_per_rep = sat.reshape(n_rep, T, n_pad).sum((1, 2))
    us_sum_per_rep = (us * n_pad).reshape(n_rep, T).sum(1)
    return FleetResult(
        n_rep=n_rep,
        n_frames=T,
        n_requests=int(reqs_per_rep.sum()),
        n_served=int(served.sum()),
        satisfied_per_rep=100.0 * sat_per_rep / np.maximum(reqs_per_rep, 1),
        mean_us_per_rep=us_sum_per_rep / np.maximum(reqs_per_rep, 1),
        final_backlog_per_rep=final_backlog if ccfg.enabled else None,
        mean_compute_inflation=float(np.mean(phi_c)) if ccfg.enabled else 1.0,
        n_devices=1,
        window=T,
        gen_s=gen_s,
        timings=timings,
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
