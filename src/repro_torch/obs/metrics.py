"""Per-frame metric streams: the ``MetricsFrame`` rows and their rollups.

The port's counterpart of ``repro.obs.metrics``, name for name.  The
simulators' opt-in ``metrics=True`` path emits one :class:`MetricsFrame`
per scheduling decision: per-server utilization and carried backlog,
admission-shed and queue-cap-refusal counts, per-QoS-class satisfaction,
and the local/edge-offload/cloud assignment histogram.  Inside the dense
``simulate_fleet`` a window's rows are computed batched on the device
(:func:`repro_torch.core.queueing.frame_metrics`, leaves are device
tensors until then) and copied to the host once per window, so there is no
host sync per frame; ``simulate``, the host policies' loop and the
hierarchical fleet fill numpy rows from their own counters, as the
reference does.  :class:`MetricsResult` holds numpy arrays.

This module imports nothing of :mod:`repro_torch.core` (the core imports
it).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ["QOS_ACC_EDGES", "MetricsFrame", "MetricsResult"]

#: accuracy-requirement thresholds defining the QoS classes of the
#: per-class satisfaction stream: class q holds requests with
#: ``edges[q-1] <= A_i < edges[q]`` (the paper's testbed pins A_i = 50,
#: i.e. class 1; spread-QoS scenarios populate all four)
QOS_ACC_EDGES: Tuple[float, ...] = (45.0, 55.0, 65.0)


class MetricsFrame(NamedTuple):
    """One decision's metrics: scalars and small vectors.

    ``M`` = number of servers, ``Q`` = ``len(QOS_ACC_EDGES) + 1`` QoS
    classes.  The leaves may carry leading batch axes (``(B, ...)`` from
    the fleet's batched rows, ``(T, ...)`` or ``(R, T, ...)`` stacked), and
    may be numpy arrays or torch tensors.
    """

    n_arrivals: Any    # ()  int32 — real (non-padded) requests decided
    n_served: Any      # ()  int32 — assigned a (server, variant)
    n_satisfied: Any   # ()  int32 — served and QoS met
    n_shed: Any        # ()  int32 — dropped by deadline shedding (admission)
    n_refused: Any     # ()  int32 — refused by the backlog queue cap
    tier_hist: Any     # (3,) int32 — [local, edge-offload, cloud] assignments
    qos_sat: Any       # (Q,) int32 — satisfied per QoS class
    qos_count: Any     # (Q,) int32 — decided per QoS class
    util_gamma: Any    # (M,) float32 — committed compute / frame budget
    util_eta: Any      # (M,) float32 — committed comm / frame budget
    backlog_gamma: Any  # (M,) float32 — carried compute backlog after the frame
    backlog_eta: Any   # (M,) float32 — carried comm backlog after the frame
    us_sum: Any        # ()  float32 — summed US of this decision's requests


_SCALAR_FIELDS = ("n_arrivals", "n_served", "n_satisfied", "n_shed", "n_refused",
                  "us_sum")
_SERVER_FIELDS = ("util_gamma", "util_eta", "backlog_gamma", "backlog_eta")
TIER_NAMES = ("local", "edge_offload", "cloud")


def _host(x) -> np.ndarray:
    """A leaf as a numpy array: torch tensors (any device) copied to the
    host, anything else through ``np.asarray``."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class MetricsResult:
    """Stacked per-frame metrics plus the aggregation/export API.

    ``data`` maps each :class:`MetricsFrame` field to a numpy array whose
    leading axes are ``(T, ...)`` for a single run or ``(R, T, ...)`` for
    a fleet.  ``t_ms`` holds each frame's decision time (single run: the
    actual decision instants, early closes included; fleet: frame
    boundaries).
    """

    data: Dict[str, np.ndarray]
    t_ms: np.ndarray
    n_edge: int
    frame_ms: float
    qos_edges: Tuple[float, ...] = QOS_ACC_EDGES

    # -- shape ------------------------------------------------------------
    @property
    def fleet(self) -> bool:
        return self.data["n_arrivals"].ndim == 2

    @property
    def n_rep(self) -> int:
        return self.data["n_arrivals"].shape[0] if self.fleet else 1

    @property
    def n_frames(self) -> int:
        return self.data["n_arrivals"].shape[-1]

    @property
    def n_servers(self) -> int:
        return self.data["util_gamma"].shape[-1]

    def series(self, field: str, rep: Optional[int] = None) -> np.ndarray:
        """The per-frame series of one field, ``(T, ...)``; ``rep`` picks
        a fleet replication (default 0 when the result is a fleet)."""
        x = self.data[field]
        if self.fleet:
            return x[0 if rep is None else rep]
        return x

    # -- aggregation ------------------------------------------------------
    def total(self, field: str) -> float:
        return float(np.sum(self.data[field]))

    def percentiles(
        self, field: str, qs: Sequence[float] = (50.0, 90.0, 99.0)
    ) -> Dict[str, float]:
        """Percentiles of a per-frame series across every (rep, frame)
        cell; vector fields are reduced to their per-frame server mean."""
        x = np.asarray(self.data[field], np.float64)
        if field in _SERVER_FIELDS:
            x = x.mean(-1)
        return {f"p{g:g}": float(np.percentile(x, g)) for g in qs}

    def per_edge_rollup(self) -> Dict[str, List[float]]:
        """Time-mean utilization/backlog per edge server (the cloud tiers
        sit past ``n_edge`` in the same vectors)."""
        out: Dict[str, List[float]] = {}
        for f in _SERVER_FIELDS:
            x = np.asarray(self.data[f], np.float64)
            mean = x.reshape(-1, x.shape[-1]).mean(0)
            out[f] = [round(float(v), 6) for v in mean[: self.n_edge]]
            out[f + "_cloud"] = [round(float(v), 6) for v in mean[self.n_edge:]]
        return out

    def aggregate(self) -> Dict[str, float]:
        """Run totals and rates — the cross-check against ``SimResult`` /
        ``FleetResult`` (satisfaction counts match those exactly)."""
        n_arr = self.total("n_arrivals")
        tier = np.asarray(self.data["tier_hist"], np.int64).reshape(-1, 3).sum(0)
        qos_sat = np.asarray(self.data["qos_sat"], np.int64)
        qos_cnt = np.asarray(self.data["qos_count"], np.int64)
        q_axis = tuple(range(qos_sat.ndim - 1))
        out = {
            "n_frames": self.n_frames,
            "n_rep": self.n_rep,
            "n_arrivals": int(n_arr),
            "n_served": int(self.total("n_served")),
            "n_satisfied": int(self.total("n_satisfied")),
            "n_shed": int(self.total("n_shed")),
            "n_refused": int(self.total("n_refused")),
            "satisfied_pct": 100.0 * self.total("n_satisfied") / max(n_arr, 1),
            "us_sum": self.total("us_sum"),
        }
        for t, name in enumerate(TIER_NAMES):
            out[f"n_{name}"] = int(tier[t])
        out["qos_sat"] = [int(v) for v in qos_sat.sum(q_axis)]
        out["qos_count"] = [int(v) for v in qos_cnt.sum(q_axis)]
        return out

    # -- export -----------------------------------------------------------
    def iter_rows(self) -> Iterable[Dict[str, Any]]:
        """One JSON-ready dict per (rep, frame) — the JSONL row stream."""
        reps = range(self.n_rep) if self.fleet else (None,)
        for rep in reps:
            for t in range(self.n_frames):
                row: Dict[str, Any] = {"frame": t, "t_ms": float(self.t_ms[t])}
                if rep is not None:
                    row["rep"] = rep
                pick = (lambda f: self.data[f][rep, t]) if self.fleet else (
                    lambda f: self.data[f][t])
                for f in ("n_arrivals", "n_served", "n_satisfied", "n_shed",
                          "n_refused"):
                    row[f] = int(pick(f))
                row["us_sum"] = float(pick("us_sum"))
                th = np.asarray(pick("tier_hist"))
                row["tier"] = {n: int(th[i]) for i, n in enumerate(TIER_NAMES)}
                row["qos_sat"] = [int(v) for v in np.asarray(pick("qos_sat"))]
                row["qos_count"] = [int(v) for v in np.asarray(pick("qos_count"))]
                for f in _SERVER_FIELDS:
                    row[f] = [round(float(v), 6) for v in np.asarray(pick(f))]
                yield row

    def to_jsonl(self, path, writer=None) -> int:
        """Write the per-frame stream as JSONL; returns the row count.

        ``writer`` may be an :class:`repro_torch.obs.export.AsyncJsonlWriter`
        (rows are handed to its queue and flushed off-thread); default is
        a plain synchronous write.
        """
        n = 0
        if writer is not None:
            for row in self.iter_rows():
                writer.write(row)
                n += 1
            return n
        os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
        with open(path, "w") as f:
            for row in self.iter_rows():
                f.write(json.dumps(row) + "\n")
                n += 1
        return n

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_stacked(
        stacked: "MetricsFrame", t_ms, n_edge: int, frame_ms: float,
        qos_edges: Tuple[float, ...] = QOS_ACC_EDGES,
    ) -> "MetricsResult":
        """From a stacked :class:`MetricsFrame` (leaves already carrying
        ``(T, ...)`` or ``(R, T, ...)`` axes, numpy arrays or torch
        tensors on any device)."""
        data = {f: _host(getattr(stacked, f)) for f in MetricsFrame._fields}
        return MetricsResult(
            data=data, t_ms=np.asarray(t_ms, np.float64), n_edge=n_edge,
            frame_ms=frame_ms, qos_edges=qos_edges,
        )

    @staticmethod
    def from_rows(
        rows: Sequence["MetricsFrame"], t_ms, n_edge: int, frame_ms: float,
        qos_edges: Tuple[float, ...] = QOS_ACC_EDGES,
    ) -> "MetricsResult":
        """From a host-side list of per-decision frames (``simulate``)."""
        data = {
            f: np.stack([np.asarray(getattr(r, f)) for r in rows])
            if rows else np.zeros((0,), np.int32)
            for f in MetricsFrame._fields
        }
        return MetricsResult(
            data=data, t_ms=np.asarray(t_ms, np.float64), n_edge=n_edge,
            frame_ms=frame_ms, qos_edges=qos_edges,
        )
