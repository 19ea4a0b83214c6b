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

**Resilience** (``cfg.impairments``, ``cfg.admission``): a
:class:`~repro_torch.core.impairments.ResilienceEngine`, built once per run
and the same for every replication, gives each frame its per-edge link
draw (scaling and delaying the transfer times in float64 on the host,
before the float32 narrowing) and its server up vector (masking the
budgets); both ride the carry.  Admission control sheds requests that
cannot meet their deadline under the pre-frame inflation estimate (their
candidates masked before the scheduler) and refuses assignments to servers
over their backlog cap (after it, before the committed work enters the
backlog), on every path: the sequential testbed, the dense fleet (one
launch per window while no frame depends on another), the host policies'
loop and the hierarchical fleet (at class level).

``window=`` bounds memory (frames are built and scheduled ``window`` at a
time, the carry threaded between windows; on a streaming scenario the
arrivals themselves are drawn a window at a time) and ``prefetch=``
overlaps the host build of window k+1 with the card's work on window k in
one producer thread.  All host RNG lives in the build, which runs the same
work in the same order inline or on the producer, so results are identical
either way.

**Telemetry** (``EngineOptions(metrics=True)``): every path returns one
:class:`~repro_torch.obs.metrics.MetricsFrame` row per decision as
``SimResult.metrics`` / ``FleetResult.metrics``.  ``simulate``, the host
policies' loop and the hierarchical fleet fill numpy rows from their own
counters, op for op the reference's; the dense fleet computes a window's
rows batched on the card (:func:`~repro_torch.core.queueing.frame_metrics`)
from the tensors its result fields come from, and copies them to the host
once per window.  With metrics off no extra op runs and every result field
is unchanged.  Spans carry the reference's categories and feed an active
trace recorder (:mod:`repro_torch.obs.trace`); scheduler calls and fleet
windows carry ``torch.profiler`` annotations (:mod:`repro_torch.obs.profiler`).

**Several devices** (``EngineOptions(devices=, rep_group=)``): the dense
fleet cuts the replication axis into groups of ``rep_group`` replications
(default: one group a device), each group's carry resident on its device,
round-robin over the devices, one worker thread a device (at most the
core count) driving them at once.  Every group runs the same per-frame
work as the single-device run, and the results are gathered back in
replication order, so the result is the single-device one bit for bit.
The hierarchical fleet cuts each window's utility and feasibility tensors
into contiguous class slabs, one a device, and runs the allocator on the
run's device (:func:`_hier_device_inputs`).  ``devices=None`` takes every
local device of the run's device type, at most ``n_rep``; more than exist
raise ``ValueError`` (:func:`_resolve_fleet_devices`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import queue as queue_mod
import threading
import time
import types
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels.hier import class_loads, hier_cells
from repro_torch.obs.metrics import QOS_ACC_EDGES, MetricsFrame, MetricsResult
from repro_torch.obs.profiler import annotate, step_annotation
from repro_torch.obs.trace import (
    CAT_BUILD,
    CAT_COMPILE,
    CAT_DISPATCH,
    CAT_GEN,
    CAT_METRICS,
    CAT_SCHED,
    Stopwatch,
    instant,
)

from . import prng
from .aggregation import QuantizationConfig, aggregate_requests
from .extensions import apply_mobility, as_batch
from .gus import Assignment
from .impairments import (
    AdmissionConfig,
    ImpairmentConfig,
    ResilienceEngine,
    admission_keep,
    apply_queue_cap,
    predicted_inflation,
)
from .instance import FlatInstance, pad_instance, resolve_device, stack_instances
from .options import EngineOptions, resolve_options
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
    frame_metrics,
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
    """The sequential testbed's result, field for field the reference's,
    the per-decision metric stream included."""

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
    #: fault-injection accounting: ``n_shed``, ``n_refused``,
    #: ``frames_with_down_server`` (None when both resilience switches are
    #: off)
    resilience_stats: Optional[Dict[str, float]] = None
    #: wall-clock seconds per phase: ``gen_s`` arrival generation / stream
    #: pulls, ``build_s`` frame building, ``sched_s`` scheduler calls (on
    #: the card: the H2D copy, the launch and the wait for ``j``/``l``),
    #: ``realize_s`` realized-delay accounting, ``total_s`` end to end
    timings: Optional[Dict[str, float]] = None
    #: per-decision metric stream (``metrics=True`` only; None otherwise):
    #: each row reports the backlog *entering* its decision
    metrics: Optional[MetricsResult] = None

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
    #: devices the replications ran on (``EngineOptions.devices``; 1 on the
    #: host policies' loop)
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
    #: per-(rep, frame) metric stream (``metrics=True`` only; None
    #: otherwise): each row reports the backlog carried *after* its frame
    metrics: Optional[MetricsResult] = None
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

    def as_dict(self) -> Dict[str, float]:
        """The reference's summary (the metric stream is left out)."""
        d = {
            "n_rep": self.n_rep,
            "n_requests": self.n_requests,
            "n_devices": self.n_devices,
            "satisfied_pct": self.satisfied_pct,
            "satisfied_std": self.satisfied_std,
            "served_pct": 100.0 * self.n_served / max(self.n_requests, 1),
            "mean_us": self.mean_us,
        }
        if self.final_backlog_per_rep is not None:
            d["mean_compute_inflation"] = self.mean_compute_inflation
            d["final_backlog_gamma"] = float(self.final_backlog_per_rep.sum(-1).mean())
        return d


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


#: the reference's replication-group width, the unit of its device dispatch
#: (``EngineOptions(rep_group=8)`` gives its layout; the port's default is
#: one group a device, :mod:`repro_torch.core.options`)
FLEET_REP_GROUP = 8


def _local_devices(dev: torch.device) -> List[torch.device]:
    """The devices a fleet on ``dev`` may spread its replications over:
    every CUDA device of the process for a CUDA run
    (:func:`~repro_torch.launch.mesh.make_fleet_mesh`), ``dev`` alone
    otherwise.  The one place the fleet asks what exists, so that a test
    can hand it several CPU "devices" (torch has no virtual ones)."""
    if dev.type == "cuda":
        from repro_torch.launch.mesh import make_fleet_mesh

        return make_fleet_mesh()
    return [dev]


def _resolve_fleet_devices(devices: Optional[int], n_rep: int,
                           dev: torch.device) -> List[torch.device]:
    """``EngineOptions.devices`` as the list of devices the replication
    axis runs on, the reference's ``_resolve_fleet_devices``: ``None`` is
    every local device, at most ``n_rep`` (more would schedule nothing);
    more than exist raise, never a fallback to fewer.  One device is
    ``dev`` itself."""
    local = _local_devices(dev)
    if devices is None:
        n = max(1, min(len(local), n_rep))
    else:
        n = int(devices)
        if n < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if n > len(local):
            raise ValueError(
                f"simulate_fleet requested devices={devices} but only {len(local)} "
                f"local device(s) of type {dev.type!r} are visible; lower devices="
            )
    return [dev] if n == 1 else list(local[:n])


def _device_scope(dev: torch.device):
    """``dev`` as the current CUDA device (the kernels launch on its
    current stream), or nothing to enter for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _group_rows(x, sl: slice, n_rep: int, Tc: int):
    """Replications ``sl`` of a frame-major window (row ``k * n_rep + r``),
    frame-major again; the whole window when ``sl`` covers every
    replication."""
    if sl.stop - sl.start == n_rep:
        return x
    return x.reshape((Tc, n_rep) + tuple(x.shape[1:]))[:, sl].reshape(
        (-1,) + tuple(x.shape[1:]))


def _frame_arrays(
    reqs, spec: ClusterSpec, cfg: SimConfig, now_ms, bw_est: float, link=None
) -> Dict[str, np.ndarray]:
    """Numpy request-row tensors for the given requests (a Request list or a
    :class:`RequestColumns` view), with ``now_ms`` a scalar or per request.

    ``link`` is an optional pair of per-request float64 ``(bandwidth_scale,
    extra_latency_ms)`` arrays from the resilience engine, gathered by each
    request's covering edge: the transfer time becomes ``size / bw /
    scale + lat`` (at identity values both operations are exact).

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
    if link is not None:
        bw_scale, extra_lat = link
        transfer = transfer / np.asarray(bw_scale, np.float64)[:, None] \
            + np.asarray(extra_lat, np.float64)[:, None]
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
    links=None,
) -> Dict[str, np.ndarray]:
    """Padded numpy leaves of a ``FlatInstance`` for a list of frames.

    ``links`` (optional, aligned with ``frames`` like ``budgets``) holds each
    frame's per-server ``(bandwidth_scale, extra_latency_ms)`` pair from the
    resilience engine; each request takes its covering edge's.

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
            link = None
            if links is not None:
                row = np.repeat(np.arange(F), lengths)
                cov = cat.cover.astype(np.intp)
                link = (np.stack([lk[0] for lk in links])[row, cov],
                        np.stack([lk[1] for lk in links])[row, cov])
            arr = _frame_arrays(cat, spec, cfg, now, spec.bandwidth_true, link=link)
            starts = np.cumsum(lengths) - lengths
            for i in range(F):
                n = int(lengths[i])
                if n:
                    put(i, arr, slice(int(starts[i]), int(starts[i]) + n), n)
    else:
        for i, (reqs, t0) in enumerate(zip(frames, frame_starts)):
            n = len(reqs)
            if n:
                link = None
                if links is not None:
                    sc, la = links[i]
                    cov = _covers(reqs)
                    link = (sc[cov], la[cov])
                arr = _frame_arrays(
                    reqs, spec, cfg, t0 + cfg.frame_ms, spec.bandwidth_true, link=link
                )
                put(i, arr, slice(None), n)
    return out


def _covers(reqs) -> np.ndarray:
    """The covering edges of a frame's requests (either layout) as indices."""
    if isinstance(reqs, RequestColumns):
        return reqs.cover.astype(np.intp)
    return np.array([r.cover for r in reqs], np.intp)


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
    spec: ClusterSpec, cfg: SimConfig, scn: Scenario, frame_starts_ms: np.ndarray,
    engine: Optional[ResilienceEngine] = None,
):
    """``(F, M)`` float64 gamma and eta budgets for a window of frame starts,
    masked by the scenario's capacity stream (outages) and then, with a
    resilience engine, by its outage stream (frame ``round(start /
    frame_ms)``)."""
    t = np.asarray(frame_starts_ms, np.float64)
    F = t.size
    g = np.repeat(spec.gamma_frame.astype(np.float64)[None, :], F, axis=0)
    e = np.repeat(spec.eta_frame.astype(np.float64)[None, :], F, axis=0)
    scale = scn.capacity_scale_batch(t, cfg, spec.n_edge, spec.n_servers)
    if scale is not None:
        g = g * scale
        e = e * scale
    if engine is not None:
        for i in range(F):
            up = engine.capacity_scale(int(round(t[i] / cfg.frame_ms)))
            if up is not None:
                g[i] = g[i] * up
                e[i] = e[i] * up
    return g, e


def _frame_budgets(spec: ClusterSpec, cfg: SimConfig, scn: Scenario, frame_start_ms: float,
                   engine: Optional[ResilienceEngine] = None):
    """Fresh float64 ``(gamma, eta)`` budgets of one frame: the window
    version at one frame start, which the reference's docstring states is
    bit-identical to its scalar ``_frame_budgets``."""
    g, e = _frame_budgets_batch(
        spec, cfg, scn, np.array([frame_start_ms], np.float64), engine=engine
    )
    return g[0].copy(), e[0].copy()


def _build_frame_instance(
    reqs, spec: ClusterSpec, cfg: SimConfig, now_ms: float, bw_est: float, max_cs: float,
    gamma, eta, link=None,
) -> FlatInstance:
    """The unpadded ``FlatInstance`` of the requests pending at ``now_ms``,
    on the CPU, priced with the scheduler's bandwidth estimate ``bw_est``
    and the per-request ``link`` draw, if any (the reference's
    ``_build_frame_instance``: float64 host math narrowed to float32 at the
    same points)."""
    N = len(reqs)
    arr = _frame_arrays(reqs, spec, cfg, now_ms, bw_est, link=link)
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
    to float32 where the reference's x32 arrays cast them, with the power
    its eager ``pow`` takes."""
    return fn(
        torch.from_numpy(np.asarray(load, np.float32)),
        torch.from_numpy(np.asarray(budget, np.float32)), ccfg, eager=True,
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
                # defers to the scenario, as in the reference
                reqs = scn.generate_arrivals(self.rng, n_edge, n_services, cfg)
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


def _build_window(sources, spec, cfg, scn, t0: int, t1: int, n_pad: int, sw, pin: bool,
                  engine: Optional[ResilienceEngine] = None):
    """Host build of frames ``[t0, t1)`` of every replication, frame-major
    (row ``k * n_rep + rep``): pull the buckets, fill the queueing delays,
    assemble the padded grid and stage it in host tensors (pinned when
    ``pin``).  Returns ``(host, n_real)``: the ``FlatInstance`` leaves plus
    ``tq`` as CPU tensors — and, with a resilience engine, ``link_up``, the
    ``(2, Tc, M)`` float32 link scale and up vector of each frame, the
    carry's per-frame values — and the real request count per row.  Pure
    numpy, the sources' own RNGs and the engine's traces, so it runs the
    same inline or on a producer thread (the only thread that extends the
    engine then)."""
    n_rep = len(sources)
    Tc = t1 - t0
    with sw.span("fleet/arrivals", CAT_GEN, t0=t0):
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
    with sw.span("fleet/grid_build", CAT_BUILD, t0=t0):
        gb, eb = _frame_budgets_batch(
            spec, cfg, scn, (t0 + np.arange(Tc)) * cfg.frame_ms, engine=engine
        )
        budgets = [(gb[k], eb[k]) for k in range(Tc) for _ in range(n_rep)]
        links = None
        if engine is not None:
            links_by_k = [engine.link_frame(t0 + k) for k in range(Tc)]
            links = [links_by_k[k] for k in range(Tc) for _ in range(n_rep)]
        arrays = _build_frame_batch(frames, spec, cfg, frame_starts, budgets, n_pad, links=links)
        arrays["tq"] = tq
        if engine is not None:
            arrays["link_up"] = np.stack([
                np.stack([lk[0] for lk in links_by_k]).astype(np.float32),
                np.stack([engine.server_up(t0 + k) for k in range(Tc)]),
            ])
        host = {k: torch.from_numpy(x) for k, x in arrays.items()}
    if pin:
        with sw.span("fleet/pin", CAT_BUILD, t0=t0):
            host = {k: x.pin_memory() for k, x in host.items()}
    return host, n_real


def _shed(run: FlatInstance, tq, backlog_g, backlog_e, gamma, eta, ccfg: CongestionConfig,
          eager: bool = False):
    """Deadline shedding: ``(run, keep)``, ``run`` with the candidates of
    every request that cannot meet its deadline under the pre-frame
    inflation estimate (the backlogs against the full budgets ``gamma``,
    ``eta``) masked out.  ``eager``: the host paths the reference runs op
    by op (:func:`~repro_torch.core.queueing.compute_inflation`)."""
    phi_pc, phi_pe = predicted_inflation(backlog_g, backlog_e, gamma, eta, ccfg, eager=eager)
    keep = admission_keep(run, tq, phi_pc, phi_pe)
    return dataclasses.replace(run, avail=run.avail & keep[..., None, None]), keep


def _cap(a: Assignment, frame: FlatInstance, backlog_g, backlog_e,
         acfg: AdmissionConfig, loads: bool) -> Assignment:
    """The queue cap on ``a`` against the carried backlogs.  With ``loads``
    the committed loads are needed: the scheduler's own sums stay when
    nothing was refused, else :func:`committed_loads` adds the survivors
    again in request order."""
    if not acfg.enabled:
        return a
    j = apply_queue_cap(a.j, frame, backlog_g, backlog_e, acfg)
    keep_loads = a.loads is not None and loads and not bool((j != a.j).any())
    return Assignment(j, a.l, a.loads if keep_loads else None)


def _step(call, frame: FlatInstance, carry, ccfg: CongestionConfig, acfg: AdmissionConfig,
          keys=None, tq=None, link_up=None, real=None):
    """One frame over the replication batch: shed (admission control), then
    schedule (against the backlog-reduced budgets when congestion is on),
    cap, then inflate and roll the backlog/EMA carry.  ``call(run, carry,
    keys) -> (Assignment, carry)`` is the bound policy in its mode;
    ``link_up`` the frame's ``(2, M)`` link scale and up vector, which a
    stateful policy reads from the carry.  Returns ``(carry, a, pc, pe,
    rows)``, the inflation factors ``None`` with congestion off.

    ``real`` (the frame's ``(R, N)`` real-row mask, ``metrics=True`` only)
    asks for the carry-dependent parts of the frame's metric row, taken
    after the backlog update as the reference's scan step takes them:
    ``rows`` is a :class:`_RowParts` (else ``None``)."""
    if link_up is not None:
        carry = dataclasses.replace(
            carry, link_bw=link_up[0].expand_as(carry.link_bw),
            server_up=link_up[1].expand_as(carry.server_up),
        )
    run = frame
    if ccfg.enabled:
        run = dataclasses.replace(
            frame,
            gamma=effective_capacity(frame.gamma, carry.backlog_gamma),
            eta=effective_capacity(frame.eta, carry.backlog_eta),
        )
    keep = None
    if acfg.enabled and acfg.shed:
        run, keep = _shed(run, tq, carry.backlog_gamma, carry.backlog_eta, frame.gamma,
                          frame.eta, ccfg)
    a, carry = call(run, carry, keys)
    pre = a
    a = _cap(a, frame, carry.backlog_gamma, carry.backlog_eta, acfg, ccfg.enabled)
    if not ccfg.enabled:
        rows = None if real is None else _RowParts.of(real, keep, pre, a, None, carry)
        return carry, a, None, None, rows
    w, c = a.loads if a.loads is not None else committed_loads(frame, a.j, a.l)
    pc = compute_inflation(carry.backlog_gamma + w, frame.gamma, ccfg)
    pe = comm_inflation(carry.backlog_eta + c, frame.eta, ccfg)
    carry = dataclasses.replace(
        carry,
        backlog_gamma=step_backlog(carry.backlog_gamma, w, frame.gamma, ccfg),
        backlog_eta=step_backlog(carry.backlog_eta, c, frame.eta, ccfg),
        ema_util=ema_update(carry.ema_util, w, frame.gamma, ccfg),
    )
    rows = None if real is None else _RowParts.of(real, keep, pre, a, (w, c), carry)
    return carry, a, pc, pe, rows


@dataclasses.dataclass
class _RowParts:
    """The carry-dependent parts of a batch of dense metric rows, on the
    device: ``n_shed`` (real rows the shed mask dropped), ``n_refused``
    (real rows whose assignment the queue cap rewrote to a drop),
    ``loads`` (the committed ``(w, c)``, or ``None`` to sum afterwards),
    ``stale`` (per row: the cap refused something, so ``loads`` taken
    before it is out of date; ``None`` when ``loads`` was taken after it)
    and the post-frame backlogs."""

    n_shed: torch.Tensor
    n_refused: torch.Tensor
    loads: Optional[tuple]
    stale: Optional[torch.Tensor]
    backlog_gamma: torch.Tensor
    backlog_eta: torch.Tensor

    @staticmethod
    def of(real, keep, pre: Assignment, a: Assignment, loads, carry) -> "_RowParts":
        """``pre``/``a``: the assignment before and after the cap; ``loads``
        the loads summed after the cap, or ``None`` to take the
        scheduler's (stale where the cap refused)."""
        zero = torch.zeros(real.shape[:-1], dtype=torch.int64, device=real.device)
        n_shed = (real & ~keep).sum(-1) if keep is not None else zero
        refused = real & (pre.j >= 0) & (a.j < 0)
        stale = None
        if loads is None:
            loads = pre.loads
            stale = None if a is pre else refused.any(-1)
        return _RowParts(n_shed, refused.sum(-1), loads, stale,
                         carry.backlog_gamma, carry.backlog_eta)

    @staticmethod
    def cat(parts: List["_RowParts"]) -> "_RowParts":
        """Frame-major concatenation of the frames' parts."""
        def cat(field):
            return torch.cat([getattr(p, field) for p in parts])

        loads = None
        if all(p.loads is not None for p in parts):
            loads = tuple(torch.cat([p.loads[i] for p in parts]) for i in range(2))
        stales = [p.stale for p in parts if p.stale is not None]
        return _RowParts(cat("n_shed"), cat("n_refused"), loads,
                         torch.cat(stales) if stales else None,
                         cat("backlog_gamma"), cat("backlog_eta"))


def _dense_rows(mbatch: FlatInstance, aj, al, n_real, n_edge: int, parts: _RowParts):
    """A window's metric rows (frame-major), from the instance the result
    fields are scored on (``mbatch``: congested ``ctime`` already in) and
    the assignment after the cap; the loads are the scheduler's unless
    missing or stale anywhere in the window (one check per window), else
    summed again in request order."""
    loads = parts.loads
    if loads is None or (parts.stale is not None and bool(parts.stale.any())):
        loads = committed_loads(mbatch, aj, al)
    return frame_metrics(
        mbatch, aj, al, None, None, None, n_real, n_edge,
        types.SimpleNamespace(backlog_gamma=parts.backlog_gamma,
                              backlog_eta=parts.backlog_eta),
        parts.n_shed, parts.n_refused, loads=loads,
    )


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """int32/float32 tensors with a common leading axis, in one
    device-to-host copy: the floats travel as their bits (an int32 view)
    and come back bit for bit."""
    B = tensors[0].shape[0]
    flat = [t.reshape(B, -1) for t in tensors]
    packed = torch.cat(
        [t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int32) for t in flat], 1
    ).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        x = packed[:, at:at + f.shape[1]]
        at += f.shape[1]
        x = x.view(np.float32) if t.dtype == torch.float32 else x
        out.append(np.ascontiguousarray(x).reshape(tuple(t.shape)))
    return out


def _metrics_store(n_rep: int, T: int, M: int) -> Dict[str, np.ndarray]:
    """Zeroed ``(n_rep, T, ...)`` arrays for every :class:`MetricsFrame`
    field, in the reference's dtypes."""
    nq = len(QOS_ACC_EDGES) + 1
    shapes = dict(tier_hist=(3,), qos_sat=(nq,), qos_count=(nq,), util_gamma=(M,),
                  util_eta=(M,), backlog_gamma=(M,), backlog_eta=(M,))
    floats = ("util_gamma", "util_eta", "backlog_gamma", "backlog_eta", "us_sum")
    return {
        f: np.zeros((n_rep, T) + shapes.get(f, ()), np.float32 if f in floats else np.int32)
        for f in MetricsFrame._fields
    }


def _fleet_metrics(store: Dict[str, np.ndarray], cfg: SimConfig, spec: ClusterSpec):
    """The fleet's :class:`MetricsResult` from its ``(n_rep, T, ...)`` store."""
    T = store["n_arrivals"].shape[1]
    return MetricsResult.from_stacked(
        MetricsFrame(**store), t_ms=(np.arange(T) + 1.0) * cfg.frame_ms,
        n_edge=spec.n_edge, frame_ms=cfg.frame_ms,
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


def _resolve_policy(scheduler, policy) -> Optional[Policy]:
    """The reference's ``_resolve_policy``: the :class:`Policy` asked for,
    by ``policy=`` or positionally through ``scheduler`` (a name or a
    :class:`Policy`), ``"gus"`` when neither is given; ``None`` when
    ``scheduler`` is a raw ``FlatInstance -> Assignment`` callable."""
    if policy is not None:
        if scheduler is not None:
            raise ValueError("pass either scheduler= or policy=, not both")
        return get_policy(policy)
    if scheduler is None or isinstance(scheduler, (str, Policy)):
        return get_policy("gus" if scheduler is None else scheduler)
    return None


def _raw_policy(scheduler: Callable, n_pad: Optional[int] = None) -> Policy:
    """A raw scheduler callable as a host policy.  Like the reference's, it
    takes one unbatched frame padded with dropped rows: :func:`simulate`
    pads each frame to its bucket (``pad=True``); the fleet's host loop
    pads its unpadded frames to the run's ``n_pad`` here and cuts the
    assignment back."""
    fn = scheduler
    if n_pad is not None:
        def fn(inst):
            n = inst.cover.shape[0]
            a = scheduler(pad_instance(inst, n_pad))
            return Assignment(a.j[:n], a.l[:n])
    return Policy(
        name=getattr(scheduler, "__name__", "scheduler"),
        description="a raw FlatInstance -> Assignment callable",
        make=lambda n_edge, n_servers: fn, vmappable=False, kind="raw",
    )


def _check_raw(opts: EngineOptions) -> None:
    """The reference's refusal of ``backend=`` beside a raw callable
    (``_apply_backend``): ``backend`` picks GUS's implementation."""
    if opts.backend is not None:
        raise ValueError("pass either scheduler= or backend=, not both")


def _fold_hier_scheduler(pol: Optional[Policy], opts: EngineOptions,
                         allow_backend: bool = False) -> Policy:
    """The hierarchical layout *is* the reference's ``gus-hier`` policy, so
    it composes only with ``"gus"`` or ``"gus-hier"`` (``pol``, resolved by
    :func:`_resolve_policy`); any other policy or a raw callable (``pol``
    None) is an error, not a silent override.  ``allow_backend=True`` (the
    fleet) lets ``backend=`` through, where it picks the class allocator's
    implementation; :func:`simulate`'s per-frame ``gus-hier`` is host-side,
    so there it raises.  Returns the policy."""
    if pol is None:
        raise ValueError(
            "EngineOptions(scheduler='hierarchical') does not compose with a raw "
            "scheduler callable; drop one of the two"
        )
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
    instant("compile/bind_policy", CAT_COMPILE, policy=pol.name)
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
    scheduler: Union[str, Policy, Callable[[FlatInstance], Assignment], None] = None,
    *,
    policy: Union[str, Policy, None] = None,
    scenario: Union[str, Scenario] = "paper-default",
    seed: int = 0,
    n_requests: Optional[int] = None,
    options: Optional[EngineOptions] = None,
    device=None,
) -> SimResult:
    """Run the virtual testbed (the reference's ``simulate``), deciding on
    ``device``.

    The signature mirrors :func:`simulate_fleet`: ``policy`` names a
    registered :class:`~repro_torch.core.policies.Policy` (or passes one;
    ``"gus"`` when neither it nor ``scheduler`` is given) and ``options``
    carries the engine options.  ``scheduler``, the third positional
    argument, takes a policy name or :class:`Policy` as ``policy=`` does,
    or a raw ``FlatInstance -> Assignment`` callable, which gets each
    frame padded to its bucket, unbatched, on the CPU (it raises beside
    ``policy=``, and beside ``options.backend``, as the reference's does).
    The reference's deprecated per-call keywords (``streaming=``,
    ``rng_mode=``, ``backend=``, ``metrics=``) are not taken: pass
    ``EngineOptions``.  Fleet-only options are ignored.

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

    With ``cfg.impairments`` on, the wall-clock frame of each decision
    (early-close decisions share it) indexes the resilience engine: its
    link draw prices the frame and impairs the realized channel, its up
    vector masks the budgets and both ride the carry.  With
    ``cfg.admission`` on, hopeless requests are shed before the decision
    and assignments to over-cap servers refused after it;
    ``SimResult.resilience_stats`` counts both and the frames with a down
    server.

    ``device=None`` means ``"cuda"`` (raises without a CUDA device).
    ``options.metrics=True`` records one
    :class:`~repro_torch.obs.metrics.MetricsFrame` per decision into
    ``SimResult.metrics``, from the host counters, as the reference does:
    each row is the delta of the run's counters across its decision, with
    the backlog *entering* it (the fleets report the backlog after the
    frame).  If ``n_requests`` is given, arrivals stop after that many submissions
    (the x-axis of the paper's Fig. 1(e)-(h)).
    """
    dev = resolve_device(device)
    scn = get_scenario(scenario)
    opts = resolve_options(options, scenario=scn)
    metrics = opts.metrics
    pol = _resolve_policy(scheduler, policy)
    if opts.scheduler == "hierarchical":
        pol = _fold_hier_scheduler(pol, opts)
        scheduler = pol.bind(spec.n_edge, spec.n_servers)
    elif pol is None:
        _check_raw(opts)
        pol = _raw_policy(scheduler)
    else:
        scheduler = _bind_policy(pol, spec, opts.backend)
    stateful = pol.stateful
    needs_key = pol.needs_key and not pol.stateful
    on_device = pol.vmappable
    ccfg = cfg.congestion
    acfg = cfg.admission
    rng = np.random.default_rng(seed)
    M, K, L = spec.proc_ms.shape
    move_prob = cfg.move_prob if scn.move_prob is None else scn.move_prob
    engine = (
        ResilienceEngine(cfg.impairments, spec.n_edge, M) if cfg.impairments.enabled else None
    )

    sw = Stopwatch()
    t_run0 = time.perf_counter()

    if opts.streaming:
        source = _ArrivalSource(
            stream=ArrivalStream(scn, seed, spec.n_edge, K, cfg, rng_mode=opts.rng_mode),
            limit=n_requests,
        )
    else:
        with sw.span("sim/generate_trace", CAT_GEN):
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

    # per-decision metric rows (metrics=True only)
    m_rows: List[MetricsFrame] = []
    m_times: List[float] = []
    m_qos_edges = np.asarray(QOS_ACC_EDGES, np.float64)
    m_nq = len(QOS_ACC_EDGES) + 1

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
    frame_budget_g, frame_budget_e = _frame_budgets(spec, cfg, scn, 0.0, engine=engine)
    rem_gamma = frame_budget_g.copy()
    rem_eta = frame_budget_e.copy()
    frame_boundary = cfg.frame_ms
    n_shed = n_refused = 0
    frames_down = 0

    while t < cfg.horizon_ms + 10 * cfg.frame_ms:
        frame_end = t + cfg.frame_ms
        # admit arrivals in this frame; queue_cap per covering server
        qlen = {e: sum(1 for r in pending if r.cover == e) for e in range(spec.n_edge)}
        early_close = None
        with sw.span("sim/arrival_pull", CAT_GEN):
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
                spec, cfg, scn, frame_boundary - cfg.frame_ms, engine=engine
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
            cov = _covers(pending)
            link = None
            if engine is not None:
                # the wall-clock frame of the decision indexes the streams
                # (early-close decisions share it)
                fi = int(round(frame_boundary / cfg.frame_ms)) - 1
                link_scale, link_lat = engine.link_frame(fi)
                up_now = engine.server_up(fi)
                frames_down += int((up_now < 1.0).any())
                link = (link_scale[cov], link_lat[cov])
                carry = dataclasses.replace(
                    carry,
                    link_bw=torch.from_numpy(link_scale.astype(np.float32)),
                    server_up=torch.from_numpy(up_now),
                )
            if metrics:
                # deltas of the run counters across this decision become its
                # row; the backlog is sampled entering the decision
                m_shed0, m_ref0 = n_shed, n_refused
                m_served0, m_sat0 = n_served, n_sat
                m_local0, m_cloud0, m_eo0 = n_local, n_cloud, n_eo
                m_us0 = us_sum
                m_backlog_g = backlog_g.astype(np.float32)
                m_backlog_e = backlog_e.astype(np.float32)
                m_qos_cnt = np.zeros(m_nq, np.int32)
                m_qos_sat = np.zeros(m_nq, np.int32)
                m_w = np.zeros(M)
                m_c = np.zeros(M)
            with sw.span("sim/frame_build", CAT_BUILD):
                inst = _build_frame_instance(
                    pending, spec, cfg, decision_time, bw_est, max_cs,
                    gamma=rem_gamma, eta=rem_eta, link=link,
                )
                if acfg.enabled and acfg.shed:
                    # against the pre-frame (backlog-only) estimate and the
                    # full budgets, in float32 as the reference's x32 arrays
                    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
                    inst, keep = _shed(
                        inst, f32([decision_time - r.arrival_ms for r in pending]),
                        f32(backlog_g), f32(backlog_e), f32(frame_budget_g),
                        f32(frame_budget_e), ccfg, eager=True,
                    )
                    n_shed += n_real - int(keep.sum())
                # padded rows are infeasible -> dropped; the host policies
                # see the raw frame
                frame_inst = pad_instance(inst, _pad_bucket(n_real)) if pol.pad else inst
            with sw.span("sim/schedule", CAT_SCHED, n=n_real), annotate("sim/schedule"):
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
            if acfg.enabled:
                # queue cap against the full frame budgets, in float64 as
                # the reference's (an inf cap times a zero budget is NaN and
                # refuses nothing)
                with np.errstate(invalid="ignore"):
                    over_c = backlog_g >= acfg.queue_cap_mult * frame_budget_g
                    over_e = backlog_e >= acfg.queue_cap_mult * frame_budget_e
                refuse = (jv >= 0) & (over_c[np.maximum(jv, 0)] | ((jv != cov) & over_e[cov]))
                n_refused += int(refuse.sum())
                jv = np.where(refuse, -1, jv)

            with sw.span("sim/realize", CAT_METRICS, n=n_real):
                # pass 1 — capacity commit (shared frame budget + backlog
                # growth)
                for idx, r in enumerate(pending):
                    j, l = int(jv[idx]), int(lv[idx])
                    if j < 0:
                        continue
                    local = j == r.cover
                    rem_gamma[j] -= spec.proc_ms[j, r.service, l]
                    committed_g[j] += spec.proc_ms[j, r.service, l]
                    if metrics:
                        m_w[j] += spec.proc_ms[j, r.service, l]
                    if not local:
                        rem_eta[r.cover] -= r.size_bytes / 1024.0
                        committed_e[r.cover] += r.size_bytes / 1024.0
                        if metrics:
                            m_c[r.cover] += r.size_bytes / 1024.0

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
                    if metrics:
                        m_cls = int(np.searchsorted(m_qos_edges, r.A, side="right"))
                        m_qos_cnt[m_cls] += 1
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
                        if engine is not None:  # the realized channel is impaired too
                            bw_real = bw_real * float(link_scale[r.cover])
                            extra = float(link_lat[r.cover])
                        comm = r.size_bytes / bw_real + extra + (
                            spec.cloud_extra_delay if is_cloud[j] else 0.0
                        )
                        # the estimator observes the *channel* (uninflated
                        # transfer, net of the link's extra latency)
                        observed_bw.append(r.size_bytes / max(comm - extra - (spec.cloud_extra_delay if is_cloud[j] else 0.0), 1e-6))
                    if ccfg.enabled:
                        proc = proc * phi_c[j]
                        comm = comm * phi_e[r.cover]
                    tq = decision_time - r.arrival_ms
                    ct = tq + proc + comm
                    acc = spec.acc[r.service, l]
                    sat = (ct <= r.C) and (acc >= r.A)
                    if metrics and sat:
                        m_qos_sat[m_cls] += 1
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
            if metrics:
                with np.errstate(invalid="ignore"):
                    m_ug = np.where(frame_budget_g > 0.0,
                                    m_w / np.maximum(frame_budget_g, 1e-9), 0.0)
                    m_ue = np.where(frame_budget_e > 0.0,
                                    m_c / np.maximum(frame_budget_e, 1e-9), 0.0)
                m_rows.append(MetricsFrame(
                    n_arrivals=np.int32(n_real),
                    n_served=np.int32(n_served - m_served0),
                    n_satisfied=np.int32(n_sat - m_sat0),
                    n_shed=np.int32(n_shed - m_shed0),
                    n_refused=np.int32(n_refused - m_ref0),
                    tier_hist=np.array(
                        [n_local - m_local0, n_eo - m_eo0, n_cloud - m_cloud0], np.int32),
                    qos_sat=m_qos_sat,
                    qos_count=m_qos_cnt,
                    util_gamma=m_ug.astype(np.float32),
                    util_eta=m_ue.astype(np.float32),
                    backlog_gamma=m_backlog_g,
                    backlog_eta=m_backlog_e,
                    us_sum=np.float32(us_sum - m_us0),
                ))
                m_times.append(decision_time)

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

    resilience_stats = None
    if engine is not None or acfg.enabled:
        resilience_stats = {
            "n_shed": float(n_shed),
            "n_refused": float(n_refused),
            "frames_with_down_server": float(frames_down),
        }

    n_total = source.n_total
    timings = {
        "gen_s": sw.total("sim/generate_trace", "sim/arrival_pull"),
        "build_s": sw.total("sim/frame_build"),
        "sched_s": sw.total("sim/schedule"),
        "realize_s": sw.total("sim/realize"),
        "total_s": time.perf_counter() - t_run0,
    }
    mres = None
    if metrics:
        mres = MetricsResult.from_rows(m_rows, m_times, spec.n_edge, cfg.frame_ms)
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
        resilience_stats=resilience_stats,
        timings=timings,
        metrics=mres,
    )


def simulate_fleet(
    spec: ClusterSpec,
    cfg: SimConfig,
    scheduler: Union[str, Policy, Callable[[FlatInstance], Assignment], None] = None,
    *,
    policy: Union[str, Policy, None] = None,
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
    run on :func:`_simulate_fleet_host`, on the CPU.  ``scheduler`` is
    :func:`simulate`'s: a name, a :class:`Policy` or a raw callable.  The
    reference calls a raw callable inside its jitted scan, once per
    (replication, frame) on a frame padded to the run's bucket; the port
    calls it so on the host loop, with the jitted path's inflation.

    Resilience composes with every layout.  The resilience engine is built
    once and is the same for every replication: frame ``t`` of every
    replication sees link draw and up vector ``t``.  On the dense layout
    each window's ``(Tc, M)`` link scales and up vectors go to the card in
    one copy; shedding masks ``avail`` before the policy and the queue cap
    rewrites its ``j`` after it.  With congestion off the inflation
    estimate is all ones and the backlog zero, so neither depends on the
    carry, and a stateless policy still schedules a whole window in one
    call.

    ``device=None`` means ``"cuda"`` (raises without a CUDA device);
    ``options`` takes the fields :func:`~repro_torch.core.options.
    resolve_options` resolves.  ``options.devices`` spreads the
    replications over that many devices of ``device``'s type (``None``:
    all of them, at most ``n_rep``; more than exist raise ``ValueError``,
    as does a host policy with more than one) in groups of
    ``options.rep_group`` (``None``: one group a device), and the
    hierarchical layout its class slabs; the results are the one-device
    run's bit for bit (module docstring).  ``options.backend`` picks the GUS
    implementation (dense; composes only with the ``"gus"`` policy) or the
    class allocator's (hierarchical).

    ``options.metrics=True`` returns one
    :class:`~repro_torch.obs.metrics.MetricsFrame` row per (replication,
    frame) as ``FleetResult.metrics``, each with the backlog carried after
    its frame.  On the dense layout a window's rows are computed on the
    card in one batched pass over the tensors the result fields are scored
    on, after the window's single launch when no frame depends on another
    (the backlog rows are then the zero carry) or from parts taken in each
    frame's step after its backlog update, and are copied to the host once
    per window: no host sync per frame, and the launch count is the one
    without metrics.
    """
    dev = resolve_device(device)
    scn = get_scenario(scenario)
    opts = resolve_options(options, scenario=scn)
    metrics = opts.metrics
    hier = opts.scheduler == "hierarchical"
    pol = _resolve_policy(scheduler, policy)
    if hier:
        pol = _fold_hier_scheduler(pol, opts, allow_backend=True)
    elif pol is None:
        _check_raw(opts)
    else:
        fn = _bind_policy(pol, spec, opts.backend)
    host_side = not hier and (pol is None or not pol.vmappable or not pol.pad)
    devs = _resolve_fleet_devices(opts.devices, n_rep, dev)  # impossible counts raise first
    if host_side and opts.devices is None:
        devs = [dev]  # the host loop drives one device
    elif host_side and len(devs) > 1:
        raise ValueError(
            f"policy {pol.name if pol is not None else 'scheduler'!r} schedules on the "
            f"host; devices={opts.devices} does not apply: the host loop drives one "
            "device (use devices=None or 1)"
        )
    ccfg = cfg.congestion
    acfg = cfg.admission
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
    with sw.span("fleet/generate_traces", CAT_GEN, n_rep=n_rep):
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
    engine = ResilienceEngine(cfg.impairments, spec.n_edge, M) if cfg.impairments.enabled else None
    if hier:
        return _simulate_fleet_hier(
            spec, cfg, scn, sources, n_rep=n_rep, T=T, W=W, opts=opts, dev=dev,
            gen_s=gen_s, sw=sw, t_run0=t_run0, engine=engine, metrics=metrics, devs=devs,
        )
    if host_side:
        return _simulate_fleet_host(
            spec, cfg, scn, pol or _raw_policy(scheduler, n_pad), sources, n_rep=n_rep,
            T=T, n_pad=n_pad, seed=seed, gen_s=gen_s, sw=sw, t_run0=t_run0, engine=engine,
            metrics=metrics, eager=pol is not None,
        )
    carry = fleet_policy_carry(
        n_rep, M, seed=seed, bandwidth_init=spec.bandwidth_true, device=dev
    )
    stateful = pol.stateful
    needs_key = pol.needs_key and not stateful
    shed = acfg.enabled and acfg.shed
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

    # --- replication groups, round-robin over the devices ------------------
    # Every frame is scheduled on its own (the kernel runs one block a frame,
    # the plain path one row a frame) and the loads are summed per
    # replication in a fixed order, so a group computes what the same
    # replications compute in the whole batch, on any device.  Nothing is
    # compiled per width, so the last group is narrower where rep_group
    # does not divide n_rep, with no padding replications.
    n_dev = len(devs)
    G = -(-n_rep // n_dev) if opts.rep_group is None else min(int(opts.rep_group), n_rep)
    groups = [slice(a, min(a + G, n_rep)) for a in range(0, n_rep, G)]
    group_dev = [devs[g % n_dev] for g in range(len(groups))]
    carries = [
        PolicyCarry(**{
            f.name: getattr(carry, f.name)[sl] if f.name == "key"
            else getattr(carry, f.name)[sl].to(gd)
            for f in dataclasses.fields(carry)
        })
        for sl, gd in zip(groups, group_dev)
    ]
    n_workers = min(n_dev, os.cpu_count() or 1)
    executor = ThreadPoolExecutor(n_workers, "fleet-device") if n_workers > 1 else None

    def each_group(work):
        """``work(g)`` for every group, each under its device, on the
        worker threads when there are several devices."""
        def run(g):
            with _device_scope(group_dev[g]):
                return work(g)

        if executor is None:
            return [run(g) for g in range(len(groups))]
        return list(executor.map(run, range(len(groups))))

    sat_frames = np.zeros((n_rep, T), np.int64)
    served_frames = np.zeros((n_rep, T), np.int64)
    us_frames = np.zeros((n_rep, T), np.float32)
    n_real_frames = np.zeros((n_rep, T), np.int32)
    phi_frames = np.ones((n_rep, T, M), np.float32) if ccfg.enabled else None
    m_store = _metrics_store(n_rep, T, M) if metrics else None

    def build_window(t0: int):
        return _build_window(sources, spec, cfg, scn, t0, min(t0 + W, T), n_pad, sw, pin, engine)

    def dispatch(g, host, n_real, t0: int, Tc: int):
        """Schedule group g's replications over the window on its device:
        ``(inst, tq, real, n_real, aj, al, pcs, pes, row_parts)``, the
        rows frame-major (frame ``t0 + k`` of the group's r-th replication
        at ``k * R + r``)."""
        sl, gd = groups[g], group_dev[g]
        R = sl.stop - sl.start
        carry = carries[g]
        rows = functools.partial(_group_rows, sl=sl, n_rep=n_rep, Tc=Tc)
        n_real = rows(n_real)
        inst = FlatInstance(**{k: rows(host[k]).to(gd, non_blocking=True) for k in _FIELDS})
        tq = rows(host["tq"]).to(gd, non_blocking=True) if ccfg.enabled or shed else None
        link_up = (host["link_up"].to(gd, non_blocking=True)
                   if engine is not None else None)
        real = torch.arange(n_pad, device=gd)[None, :] < torch.from_numpy(
            n_real).to(gd)[:, None]
        pcs = pes = None
        if ccfg.enabled or stateful:
            js, ls, pcs, pes, parts = [], [], [], [], []
            for k in range(Tc):
                fr = slice(k * R, (k + 1) * R)
                frame = FlatInstance(**{f: getattr(inst, f)[fr] for f in _FIELDS})
                carry, a, pc, pe, prt = _step(
                    call, frame, carry, ccfg, acfg,
                    None if keys_all is None else keys_all[sl, t0 + k],
                    None if tq is None else tq[fr],
                    None if link_up is None else link_up[:, k],
                    real[fr] if metrics else None,
                )
                js.append(a.j)
                ls.append(a.l)
                pcs.append(pc)
                pes.append(pe)
                parts.append(prt)
            aj, al = torch.cat(js), torch.cat(ls)
            row_parts = _RowParts.cat(parts) if metrics else None
        else:
            keys = (None if keys_all is None
                    else keys_all[sl, t0:t0 + Tc].transpose(1, 0, 2).reshape(-1, 2))
            # congestion off: unit inflation and an empty backlog, the
            # same for every frame, so admission needs no carry
            run = inst
            zero = torch.zeros_like(inst.gamma) if acfg.enabled or metrics else None
            keep = None
            if shed:
                run, keep = _shed(run, tq, zero, zero, inst.gamma, inst.eta, ccfg)
            pre, _ = call(run, carry, keys)
            a = _cap(pre, inst, zero, zero, acfg, False)
            aj, al = a.j, a.l
            row_parts = None
            if metrics:
                row_parts = _RowParts.of(
                    real, keep, pre, a, None,
                    types.SimpleNamespace(backlog_gamma=zero, backlog_eta=zero))
        carries[g] = carry
        if gd.type == "cuda":
            torch.cuda.synchronize(gd)
        return inst, tq, real, n_real, aj, al, pcs, pes, row_parts

    def score(g, out, Tc: int):
        """Group g's window scored on its device and brought to the host:
        ``(sat, served, us, phi, rows)``, each ``(R, Tc, ...)``."""
        inst, tq, real, n_real, aj, al, pcs, pes, row_parts = out
        R = groups[g].stop - groups[g].start

        def per_rep(x):  # frame-major (Tc * R, ...) -> (R, Tc, ...)
            return x.reshape((Tc, R) + x.shape[1:]).swapaxes(0, 1)

        phi = None
        if ccfg.enabled:
            phi_c = torch.cat(pcs)
            mbatch = dataclasses.replace(
                inst, ctime=congested_ctime(inst, tq, phi_c, torch.cat(pes))
            )
            phi = per_rep(phi_c.cpu().numpy())
        else:
            mbatch = inst
        sat = (satisfied_mask(mbatch, aj, al) & real).sum(-1)
        served = ((aj >= 0) & real).sum(-1)
        us = mean_us(mbatch, aj, al)
        rows = None
        if metrics:
            mf = _dense_rows(mbatch, aj, al, torch.from_numpy(n_real).to(aj.device),
                             spec.n_edge, row_parts)
            rows = [per_rep(x) for x in _to_host(list(mf))]
        return (per_rep(sat.cpu().numpy()), per_rep(served.cpu().numpy()),
                per_rep(us.cpu().numpy()), per_rep(n_real), phi, rows)

    window_starts = list(range(0, T, W))
    pipe = _WindowPipeline(build_window, window_starts, opts.prefetch, "fleet-window-producer")
    try:
        for wi, wi_t0 in enumerate(window_starts):
            with sw.span("fleet/window_wait", CAT_GEN, window=wi):
                host, n_real = pipe.next(wi_t0)
            t0, t1 = wi_t0, min(wi_t0 + W, T)
            Tc = t1 - t0
            with sw.span("fleet/dispatch", CAT_DISPATCH, window=wi), \
                    step_annotation("fleet/window", wi):
                outs = each_group(lambda g: dispatch(g, host, n_real, t0, Tc))
            with sw.span("fleet/window_metrics", CAT_METRICS, window=wi):
                scored = each_group(lambda g: score(g, outs[g], Tc))
                for sl, (sat, served, us, nr, phi, rows) in zip(groups, scored):
                    sat_frames[sl, t0:t1] = sat
                    served_frames[sl, t0:t1] = served
                    us_frames[sl, t0:t1] = us
                    n_real_frames[sl, t0:t1] = nr
                    if phi is not None:
                        phi_frames[sl, t0:t1] = phi
                    if metrics:
                        for f, x in zip(MetricsFrame._fields, rows):
                            m_store[f][sl, t0:t1] = x
                del outs, scored
    finally:
        pipe.close()
        if executor is not None:
            executor.shutdown()

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
        final_backlog_per_rep=(
            np.concatenate([c.backlog_gamma.cpu().numpy() for c in carries])
            if ccfg.enabled else None),
        mean_compute_inflation=float(np.mean(phi_frames)) if ccfg.enabled else 1.0,
        n_devices=n_dev,
        window=W,
        dispatch_s=sw.total("fleet/dispatch"),
        gen_s=gen_s,
        prefetch=opts.prefetch if pipe.thread is not None else 0,
        timings=timings,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        metrics=_fleet_metrics(m_store, cfg, spec) if metrics else None,
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
    engine: Optional[ResilienceEngine] = None,
    metrics: bool = False,
    eager: bool = True,
) -> FleetResult:
    """The fleet for the host policies (``vmappable=False`` or
    ``pad=False``: ``ilp``, ``lp-bound``, ``gus-hier``), the reference's
    ``_simulate_fleet_host``: each *unpadded* frame is scheduled on the CPU
    in a Python loop that threads each replication's carry frame by frame,
    and the assignments are re-padded with drops so the scoring is the
    dense path's.  Impairments and admission control follow the dense
    step, in its order.  Everything runs on the host; rows are
    replication-major (row ``rep * T + frame``).  The reference runs this
    loop op by op, so the inflations take its eager ``pow``; ``eager=False``
    (a raw callable, which the reference calls in its jitted scan) squares.  With ``metrics`` the
    rows are numpy, the reference's vectorized post-pass over the padded
    grid, with the loop's sheds, refusals, loads and post-frame
    backlogs."""
    ccfg = cfg.congestion
    acfg = cfg.admission
    M = spec.n_servers
    fleet_frames = []
    with sw.span("fleet/arrivals", CAT_GEN):
        for src in sources:
            fleet_frames.extend(src.take(T))
    raw_insts = []
    n_real = np.array([len(b) for b in fleet_frames], np.int32)
    tq_flat = np.zeros((len(fleet_frames), n_pad), np.float32)
    with sw.span("fleet/grid_build", CAT_BUILD):
        for i, bucket in enumerate(fleet_frames):
            frame_start = (i % T) * cfg.frame_ms
            gamma, eta = _frame_budgets(spec, cfg, scn, frame_start, engine=engine)
            link = None
            if engine is not None and len(bucket):
                sc, la = engine.link_frame(i % T)
                cov = _covers(bucket)
                link = (sc[cov], la[cov])
            raw_insts.append(_build_frame_instance(
                bucket, spec, cfg, frame_start + cfg.frame_ms, spec.bandwidth_true,
                cfg.max_cs, gamma=gamma, eta=eta, link=link,
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
    if metrics:
        F = len(raw_insts)
        m_shed = np.zeros(F, np.int32)
        m_refused = np.zeros(F, np.int32)
        m_w = np.zeros((F, M), np.float32)
        m_c = np.zeros((F, M), np.float32)
        m_bg = np.zeros((F, M), np.float32)
        m_be = np.zeros((F, M), np.float32)
    with sw.span("fleet/schedule_host", CAT_SCHED, n_rep=n_rep):
        for rep in range(n_rep):
            carry = init_policy_carry(
                M, seed=seed + rep, bandwidth_init=spec.bandwidth_true, device="cpu"
            )
            for tf in range(T):
                i = rep * T + tf
                inst, n = raw_insts[i], n_real[i]
                if engine is not None:
                    carry = dataclasses.replace(
                        carry,
                        link_bw=torch.from_numpy(engine.link_frame(tf)[0].astype(np.float32)),
                        server_up=torch.from_numpy(engine.server_up(tf)),
                    )
                if ccfg.enabled:
                    run_inst = dataclasses.replace(
                        inst,
                        gamma=effective_capacity(inst.gamma, carry.backlog_gamma),
                        eta=effective_capacity(inst.eta, carry.backlog_eta),
                    )
                else:
                    run_inst = inst
                if acfg.enabled and acfg.shed and n:
                    run_inst, keep = _shed(
                        run_inst, torch.from_numpy(tq_flat[i, :n]), carry.backlog_gamma,
                        carry.backlog_eta, inst.gamma, inst.eta, ccfg, eager=eager,
                    )
                    if metrics:
                        m_shed[i] = int(n) - int(keep.sum())
                if pol.stateful:
                    a, carry = fn(run_inst, carry)
                elif keys is not None:
                    a = fn(run_inst, keys[i])
                else:
                    a = fn(run_inst)
                if n:
                    pre = a
                    a = _cap(a, inst, carry.backlog_gamma, carry.backlog_eta, acfg, False)
                    if metrics:
                        m_refused[i] = int(((pre.j >= 0) & (a.j < 0)).sum())
                jv[i, :n] = a.j.cpu().numpy()
                lv[i, :n] = a.l.cpu().numpy()
                if ccfg.enabled or metrics:
                    w, c = committed_loads(inst, a.j.cpu(), a.l.cpu())
                    if metrics:
                        m_w[i] = w.numpy()
                        m_c[i] = c.numpy()
                if ccfg.enabled:
                    phi_c[i] = compute_inflation(
                        carry.backlog_gamma + w, inst.gamma, ccfg, eager=eager).numpy()
                    phi_e[i] = comm_inflation(
                        carry.backlog_eta + c, inst.eta, ccfg, eager=eager).numpy()
                    carry = dataclasses.replace(
                        carry,
                        backlog_gamma=step_backlog(carry.backlog_gamma, w, inst.gamma, ccfg),
                        backlog_eta=step_backlog(carry.backlog_eta, c, inst.eta, ccfg),
                        ema_util=ema_update(carry.ema_util, w, inst.gamma, ccfg),
                    )
                if metrics:  # the post-frame carried backlog, as the dense rows
                    m_bg[i] = carry.backlog_gamma.numpy()
                    m_be[i] = carry.backlog_eta.numpy()
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

    mres = None
    if metrics:
        # the reference's post-pass over the padded grid: served/sat
        # masked to real rows, utilization against the full frame budgets
        with sw.span("fleet/window_metrics", CAT_METRICS):
            local = served & (jv == batch.cover.numpy())
            cloudm = served & (jv >= spec.n_edge)
            eo = served & ~local & ~cloudm
            tier = np.stack([local.sum(-1), eo.sum(-1), cloudm.sum(-1)], -1).astype(np.int32)
            edges = np.asarray(QOS_ACC_EDGES, np.float32)
            cls = (batch.A.numpy()[..., None] >= edges).sum(-1)
            oh = cls[..., None] == np.arange(len(QOS_ACC_EDGES) + 1)
            qos_cnt = (oh & real[..., None]).sum(1).astype(np.int32)
            qos_sat = (oh & sat[..., None]).sum(1).astype(np.int32)
            gam = batch.gamma.numpy().astype(np.float64)
            eta_b = batch.eta.numpy().astype(np.float64)
            with np.errstate(invalid="ignore"):
                ug = np.where(gam > 0.0, m_w / np.maximum(gam, 1e-9), 0.0)
                ue = np.where(eta_b > 0.0, m_c / np.maximum(eta_b, 1e-9), 0.0)

            rows = dict(
                n_arrivals=n_real.astype(np.int32), n_served=served.sum(-1).astype(np.int32),
                n_satisfied=sat.sum(-1).astype(np.int32), n_shed=m_shed, n_refused=m_refused,
                tier_hist=tier, qos_sat=qos_sat, qos_count=qos_cnt,
                util_gamma=ug.astype(np.float32), util_eta=ue.astype(np.float32),
                backlog_gamma=m_bg, backlog_eta=m_be, us_sum=(us * n_pad).astype(np.float32),
            )
            mres = _fleet_metrics(  # rows are replication-major: (R * T, ...) -> (R, T, ...)
                {f: x.reshape((n_rep, T) + x.shape[1:]) for f, x in rows.items()}, cfg, spec)

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
        metrics=mres,
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
        tq_s=repc["tq"][order],
        cov=cov, svc=svc, A=A_r, C=C_r, size=size, tq=tq,
    )
    return rep_cols, info


def _member_accounting(spec: ClusterSpec, cfg: SimConfig, info, ci, jj, ll, lens, st,
                       pc_k=None, pe_k=None, link=None, rows: bool = False):
    """Per-member satisfaction of one frame's allocated cells: ``(served,
    satisfied, sum of US)`` and, with ``rows``, the frame's metric-row parts
    ``(tier histogram, satisfied per QoS class)``, numpy op for op as the
    reference fills them.

    The allocated members of each cell are the class's members from its
    ``start`` offset on, and every member's realized accuracy and
    completion time are recomputed from its *own* size, queueing delay and
    covering edge's link draw with the reference's op sequence (its
    float32/float64 mixing included); the class mean only steered the
    allocation.  ``pc_k``/``pe_k`` are the frame's congestion inflation
    factors, or ``None``; ``link`` the frame's per-server float64
    ``(bandwidth_scale, extra_latency_ms)``, or ``None``.
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
    if link is not None:  # the member's own link draw
        sc, la = link
        transfer = transfer / np.asarray(sc, np.float64)[cov_m] + np.asarray(la, np.float64)[cov_m]
    comm = transfer + np.where(jm >= spec.n_edge, spec.cloud_extra_delay, 0.0)
    comm = np.where(local_m, 0.0, comm)
    ct = ((Tq_m + proc_m) + comm).astype(np.float32)
    if pc_k is not None:  # congested_ctime, per member
        comm_f = ct - proc_m - Tq_m
        ct = ct + proc_m * (pc_k[jm] - 1.0) + comm_f * (pe_k[cov_m] - 1.0)
    sat_m = (acc_m >= A_m) & (ct <= C_m)
    us_m = cfg.w_a * (acc_m - A_m) / cfg.max_as + cfg.w_c * (C_m - ct) / cfg.max_cs
    if not rows:
        return tot, int(sat_m.sum()), float(us_m.sum())
    cloud_m = (jm >= spec.n_edge) & ~local_m
    eo_m = ~local_m & ~cloud_m
    tier = (int(local_m.sum()), int(eo_m.sum()), int(cloud_m.sum()))
    q_m = (A_m[:, None].astype(np.float64) >= np.asarray(QOS_ACC_EDGES, np.float64)).sum(-1)
    qos_sat = np.zeros(len(QOS_ACC_EDGES) + 1, np.int32)
    np.add.at(qos_sat, q_m, sat_m.astype(np.int64))
    return tot, int(sat_m.sum()), float(us_m.sum()), tier, qos_sat


def _build_hier_window(sources, spec, cfg, scn, t0: int, t1: int, quant, sw, pin: bool,
                       engine: Optional[ResilienceEngine] = None):
    """Host build of frames ``[t0, t1)`` of every replication for the
    class-aggregate fleet, frame-major (row ``k * n_rep + rep``): pull the
    buckets, aggregate each frame into sorted QoS classes, assemble the
    padded class grid with its member counts and the classes' float32
    queueing delays ``tq`` (which the congested shedding reads) and stage
    it in host tensors (pinned when ``pin``).  Returns
    ``(t0, Tc, host, infos, n_arr, links, budgets)``: the leaves, the
    per-frame member bookkeeping (``None`` for an empty frame), the
    ``(n_rep, Tc)`` arrival counts, with a resilience engine each frame's
    link draw (``None`` without), which travels with the window to the
    member accounting, and the float64 ``(Tc, M)`` frame budgets ``(gb,
    eb)`` the metric rows divide by.  Pure numpy, the sources' own RNGs and the engine's traces,
    so it runs the same inline or on a producer thread (the only thread
    that extends the engine then)."""
    n_rep = len(sources)
    Tc = t1 - t0
    with sw.span("fleet/hier_build", CAT_BUILD, t0=t0):
        gb, eb = _frame_budgets_batch(
            spec, cfg, scn, (t0 + np.arange(Tc)) * cfg.frame_ms, engine=engine
        )
        links_by_k = (
            [engine.link_frame(t0 + k) for k in range(Tc)] if engine is not None else None
        )
    with sw.span("fleet/arrivals", CAT_GEN, t0=t0):
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
            with sw.span("fleet/hier_aggregate", CAT_BUILD, frame=t0 + k):
                rep_cols, info = _aggregate_frame(bucket, frame_start + cfg.frame_ms, quant)
            frames_rc.append(rep_cols)
            infos.append(info)
            n_cls[rep, k] = len(rep_cols)
    Cp = _pad_bucket_fine(int(n_cls.max()))
    with sw.span("fleet/grid_build", CAT_BUILD, t0=t0):
        budgets = [(gb[k], eb[k]) for k in range(Tc) for _ in range(n_rep)]
        links = None if links_by_k is None else [
            links_by_k[k] for k in range(Tc) for _ in range(n_rep)
        ]
        arrays = _build_frame_batch(frames_rc, spec, cfg, frame_starts, budgets, Cp, links=links)
        count = np.zeros((Tc * n_rep, Cp), np.int32)
        tq = np.zeros((Tc * n_rep, Cp), np.float32)
        for i, info in enumerate(infos):
            if info is not None:
                count[i, : info["count_s"].shape[0]] = info["count_s"]
                tq[i, : info["tq_s"].shape[0]] = info["tq_s"]
        arrays["count"] = count
        arrays["tq"] = tq
        host = {k: torch.from_numpy(x) for k, x in arrays.items()}
    if pin:
        with sw.span("fleet/pin", CAT_BUILD, t0=t0):
            host = {k: x.pin_memory() for k, x in host.items()}
    return t0, Tc, host, infos, n_arr, links_by_k, (gb, eb)


def _cap_cells(take, gamma, eta, cover, backlog_g, backlog_e, acfg: AdmissionConfig):
    """The queue cap at class level: ``take`` ``(B, C, M, L)`` with the cells
    on over-cap servers zeroed (compute side by the serving server, comm side
    by the covering edge of offloaded cells), against the full budgets
    ``gamma``/``eta`` ``(B, M)``."""
    M = gamma.shape[-1]
    over_c = backlog_g >= acfg.queue_cap_mult * gamma
    over_e = backlog_e >= acfg.queue_cap_mult * eta
    offl = torch.arange(M, device=take.device)[None, None, :, None] != cover[..., None, None]
    over_e_cover = torch.gather(over_e, -1, cover.long())
    refuse = (take > 0) & (over_c[:, None, :, None] | (offl & over_e_cover[..., None, None]))
    return torch.where(refuse, 0, take)


#: the class grid's leaves with a class axis (dim 1), which the slabs cut
_PER_CLASS = ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")


def _hier_device_inputs(host, dev, devs: Sequence[torch.device] = ()):
    """A window's class grid on ``dev`` with its utility and feasibility:
    ``(inst, us, feas, count)``.

    With several ``devs``, the reference's ``_hier_class_tensors``: the
    padded class axis is cut into ``len(devs)`` contiguous slabs, each
    slab's ``us_tensor``/``hard_feasible`` is computed on its own device
    and the slabs are concatenated on ``dev``.  Both are elementwise per
    class row (no reduction across classes to reorder), so the values are
    the single-device ones bit for bit; the allocator stays on ``dev``, a
    sequential walk over the classes with the budgets as its carry."""
    inst = FlatInstance(**{k: host[k].to(dev, non_blocking=True) for k in _FIELDS})
    count = host["count"].to(dev, non_blocking=True)
    if len(devs) <= 1:
        return inst, us_tensor(inst), hard_feasible(inst), count
    cuts = np.linspace(0, host["A"].shape[1], len(devs) + 1).astype(int)
    us_p, fe_p = [], []
    for d, lo, hi in zip(devs, cuts[:-1], cuts[1:]):
        if lo == hi:
            continue
        sub = FlatInstance(**{
            k: (host[k][:, lo:hi] if k in _PER_CLASS else host[k]).to(d) for k in _FIELDS
        })
        with _device_scope(d):
            us_p.append(us_tensor(sub).to(dev))
            fe_p.append(hard_feasible(sub).to(dev))
    return inst, torch.cat(us_p, 1), torch.cat(fe_p, 1), count


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
    engine: Optional[ResilienceEngine] = None,
    metrics: bool = False,
    devs: Sequence[torch.device] = (),
) -> FleetResult:
    """Class-aggregate fleet for ``EngineOptions(scheduler="hierarchical")``,
    the reference's ``_simulate_fleet_hier``.

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

    Resilience: the engine's outage stream masks the budgets and its link
    draws price the class grid and, at deaggregation, each member's own
    transfer.  Admission control runs at class level, in the dense step's
    order: shedding masks ``feas`` before the allocator, against the
    pre-frame inflation estimate on the class representatives' queueing
    delays; the queue cap zeroes the cells on over-cap servers after it,
    before the committed loads (re-added in the allocator's fixed order
    when a cell was refused) enter the backlog.  With congestion off the
    estimate is unit inflation, where admission's candidate test is
    exactly ``feas`` (the reference's own precomputed mask,
    ``feas.any((-1, -2))``): shedding then leaves ``feas`` as it is, and
    the window keeps its single launch.

    With ``metrics`` the card also returns, per frame, the committed loads
    after the cap, the shed and refused member counts and the post-frame
    backlogs (one copy per window with the cells), and the host fills
    numpy rows from them and from the member accounting, op for op as the
    reference does; the single launch of a congestion-off window returns
    its loads too.
    """
    ccfg = cfg.congestion
    acfg = cfg.admission
    # with congestion off shedding leaves feas as it is (see above)
    congested_shed = acfg.enabled and acfg.shed and ccfg.enabled
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
    m_store = _metrics_store(n_rep, T, M) if metrics else None
    edges_q = np.asarray(QOS_ACC_EDGES, np.float64)

    def build_window(t0: int):
        return _build_hier_window(sources, spec, cfg, scn, t0, min(t0 + W, T), quant, sw, pin,
                                  engine)

    def dispatch(host, Tc):
        """Enqueue one window on the card; returns its device outputs (and,
        with ``metrics``, the rows' parts ``(w, c_load, bg, be, n_shed,
        n_refused)`` in the ``(n_rep, Tc, ...)`` layout)."""
        nonlocal bg, be
        inst, us, feas, count = _hier_device_inputs(host, dev, devs)
        if not ccfg.enabled:
            out = hier_cells(
                us, feas, inst.v, inst.u, inst.cover, count, inst.gamma, inst.eta,
                backend=opts.backend, loads=metrics,
            )
            take, start = out[:2]
            capped = take
            if acfg.enabled:
                zero = torch.zeros_like(inst.gamma)
                capped = _cap_cells(take, inst.gamma, inst.eta, inst.cover, zero, zero, acfg)
            if not metrics:
                return capped, start, None, None, None
            # the kernel's loads, or the survivors' when the cap ran
            w, c_load = (class_loads(capped, inst.v, inst.u, inst.cover) if acfg.enabled
                         else out[2:])
            # at unit inflation the shed test is exactly feas (see above)
            n_shed = torch.zeros_like(count[:, 0])
            if acfg.enabled and acfg.shed:
                n_shed = torch.where(feas.any((-1, -2)), 0, count).sum(-1)
            zero = torch.zeros_like(w)
            parts = [x.reshape((Tc, n_rep) + x.shape[1:]).transpose(0, 1) for x in (
                w, c_load, zero, zero, n_shed, (take - capped).sum((1, 2, 3)))]
            return capped, start, None, None, parts
        tq = host["tq"].to(dev, non_blocking=True) if congested_shed else None
        takes, starts, pcs, pes, parts = [], [], [], [], []
        for k in range(Tc):
            sl = slice(k * n_rep, (k + 1) * n_rep)
            g, e = inst.gamma[sl], inst.eta[sl]
            feas_k = feas[sl]
            keep = None
            if congested_shed:
                frame = FlatInstance(**{f: getattr(inst, f)[sl] for f in _FIELDS})
                _, keep = _shed(frame, tq[sl], bg, be, g, e, ccfg)
                feas_k = feas_k & keep[..., None, None]
            t_k, s_k, w, c_load = hier_cells(
                us[sl], feas_k, inst.v[sl], inst.u[sl], inst.cover[sl], count[sl],
                effective_capacity(g, bg), effective_capacity(e, be),
                backend=opts.backend, loads=True,
            )
            n_refused = None
            if acfg.enabled:
                capped = _cap_cells(t_k, g, e, inst.cover[sl], bg, be, acfg)
                if bool((capped != t_k).any()):
                    w, c_load = class_loads(capped, inst.v[sl], inst.u[sl], inst.cover[sl])
                if metrics:
                    n_refused = (t_k - capped).sum((1, 2, 3))
                t_k = capped
            pcs.append(compute_inflation(bg + w, g, ccfg))
            pes.append(comm_inflation(be + c_load, e, ccfg))
            bg = step_backlog(bg, w, g, ccfg)
            be = step_backlog(be, c_load, e, ccfg)
            takes.append(t_k)
            starts.append(s_k)
            if metrics:
                zero = torch.zeros_like(count[sl, 0])
                parts.append((
                    w, c_load, bg, be,
                    torch.where(keep, 0, count[sl]).sum(-1) if keep is not None else zero,
                    n_refused if n_refused is not None else zero,
                ))
        rows = [torch.stack(x, 1) for x in zip(*parts)] if metrics else None
        return (torch.cat(takes), torch.cat(starts), torch.stack(pcs, 1), torch.stack(pes, 1),
                rows)

    def fetch(outs):
        """The window's nonzero cells (row-major ``(frame, c, j, l)``) with
        their take and start, the inflation factors and the metric rows'
        parts, on the host."""
        take, start, pc, pe, rows = outs
        nz = torch.nonzero(take)
        idx = nz.unbind(1)
        return (
            nz.cpu().numpy(), take[idx].cpu().numpy(), start[idx].cpu().numpy(),
            None if pc is None else pc.cpu().numpy(),
            None if pe is None else pe.cpu().numpy(),
            None if rows is None else _to_host(rows),
        )

    def post(wi, t0, Tc, infos, n_arr, links_by_k, budgets, fetched):
        nonlocal phi_sum, phi_cnt
        nz, vals, starts, pc, pe, rows = fetched
        with sw.span("fleet/hier_post", CAT_METRICS, window=wi):
            if ccfg.enabled:  # pc: (n_rep, Tc, M), the reference's layout
                phi_sum += float(pc.sum())
                phi_cnt += pc.size
            reqs_per_rep[:] += n_arr.sum(1)
            if metrics:
                w_a, c_a, bg_a, be_a, shed_a, ref_a = rows
                gb, eb = budgets
                tf = slice(t0, t0 + Tc)
                m_store["n_arrivals"][:, tf] = n_arr
                m_store["n_shed"][:, tf] = shed_a
                m_store["n_refused"][:, tf] = ref_a
                with np.errstate(invalid="ignore"):
                    m_store["util_gamma"][:, tf] = np.where(
                        gb > 0.0, w_a / np.maximum(gb, 1e-9), 0.0)
                    m_store["util_eta"][:, tf] = np.where(
                        eb > 0.0, c_a / np.maximum(eb, 1e-9), 0.0)
                m_store["backlog_gamma"][:, tf] = bg_a
                m_store["backlog_eta"][:, tf] = be_a
            bounds = np.searchsorted(nz[:, 0], np.arange(Tc * n_rep + 1))
            for rep in range(n_rep):
                for k in range(Tc):
                    i = k * n_rep + rep
                    lo, hi = bounds[i], bounds[i + 1]
                    if infos[i] is None:
                        continue
                    if metrics:
                        q_all = (infos[i]["A"][:, None] >= edges_q).sum(-1)
                        np.add.at(m_store["qos_count"][rep, t0 + k], q_all, 1)
                    if lo == hi:
                        continue
                    acct = _member_accounting(
                        spec, cfg, infos[i], nz[lo:hi, 1], nz[lo:hi, 2], nz[lo:hi, 3],
                        vals[lo:hi], starts[lo:hi],
                        None if pc is None else pc[rep, k], None if pe is None else pe[rep, k],
                        None if links_by_k is None else links_by_k[k], rows=metrics,
                    )
                    tot, n_sat, us_sum = acct[:3]
                    served_per_rep[rep] += tot
                    sat_per_rep[rep] += n_sat
                    us_sum_per_rep[rep] += us_sum
                    if metrics:
                        m_store["n_served"][rep, t0 + k] = tot
                        m_store["n_satisfied"][rep, t0 + k] = n_sat
                        m_store["tier_hist"][rep, t0 + k] = acct[3]
                        m_store["qos_sat"][rep, t0 + k] = acct[4]
                        m_store["us_sum"][rep, t0 + k] = us_sum

    window_starts = list(range(0, T, W))
    pipe = _WindowPipeline(build_window, window_starts, opts.prefetch, "fleet-hier-producer")
    pending = None
    try:
        for wi, wi_t0 in enumerate(window_starts):
            with sw.span("fleet/window_wait", CAT_GEN, window=wi):
                t0, Tc, host, infos, n_arr, links_by_k, budgets = pipe.next(wi_t0)
            with sw.span("fleet/dispatch", CAT_DISPATCH, window=wi), \
                    step_annotation("fleet/hier_window", wi):
                # the previous window's results first (this waits for the
                # card), then the next window's work, so the card computes
                # while the host accounts the previous window
                fetched = fetch(pending[-1]) if pending is not None else None
                outs = dispatch(host, Tc)
            if pending is not None:
                post(*pending[:-1], fetched)
            pending = (wi, t0, Tc, infos, n_arr, links_by_k, budgets, outs)
        if pending is not None:
            with sw.span("fleet/dispatch", CAT_DISPATCH, window=pending[0]):
                fetched = fetch(pending[-1])
            post(*pending[:-1], fetched)
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
        n_devices=max(1, len(devs)),
        window=W,
        dispatch_s=sw.total("fleet/dispatch"),
        gen_s=gen_s,
        prefetch=opts.prefetch if pipe.thread is not None else 0,
        timings=timings,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        metrics=_fleet_metrics(m_store, cfg, spec) if metrics else None,
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
