"""Hierarchical class-aggregate scheduling — the host part, in numpy.

A copy of the class-building code of ``repro.core.aggregation`` (the port
imports nothing of the reference package), op for op, so the same frame
gives the same classes in both packages.

The QoS space is tiny next to the request count: requests differ only in
(covering edge, service, accuracy floor ``A``, deadline ``C``, payload size,
queueing age), and with discrete QoS tiers most of those axes collapse.
Requests are bucketed into **QoS classes**; the class aggregates form an
``(n_classes, M, L)`` candidate grid with per-class member counts, which the
analytic allocator (:func:`repro_torch.kernels.hier.hier_cells`) schedules
in *chunks*; :func:`deaggregate` maps the class-level result back to
requests, each class's members consumed in ascending request index.

* :func:`aggregate_requests` keys raw request columns on
  :func:`class_keys` — the fleet path, which never builds a dense
  ``N x M x L`` grid;
* :func:`aggregate_instance` keys the rows of an already-built
  :class:`~repro_torch.core.instance.FlatInstance` on its grid content
  (exact values, or ``ctime``/``u`` rounded to ``decimals``) — the per-frame
  ``gus-hier`` policy and the tests build class grids with it;
* :func:`hier_assign` is the global pass over one frame's classes: in
  ``exact`` mode it consumes members one at a time with float32 budgets,
  the reference's host loop, so lossless classes reproduce dense GUS bit
  for bit; otherwise it sizes chunks analytically through the class
  allocator's plain version (:func:`repro_torch.kernels.hier.hier_cells_ref`
  on the CPU), the fleet's op sequence;
* :func:`make_gus_hier` / :func:`hier_schedule_np` are the per-frame
  ``gus-hier`` scheduler: host-side numpy in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.hier import NEG, hier_cells_ref

from .gus import Assignment
from .instance import FlatInstance, resolve_device
from .satisfaction import hard_feasible, us_tensor

__all__ = [
    "AggregateClasses",
    "QuantizationConfig",
    "aggregate_instance",
    "aggregate_requests",
    "class_batch",
    "class_keys",
    "deaggregate",
    "hier_assign",
    "hier_schedule_np",
    "make_gus_hier",
]


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """How request attributes are bucketed into QoS classes (fleet path).

    ``acc_decimals`` / ``deadline_decimals`` round the accuracy floor and
    deadline with :func:`numpy.round` (negative = coarser than integer), so
    discrete QoS tiers collapse losslessly.  ``size_bin_bytes`` /
    ``tq_bin_ms`` are *anchored* absolute-width bins (``floor(x / width)``):
    a request's class key depends only on its own attributes, never on
    which other requests share the frame, so keys are invariant to chunking,
    windowing and the rng mode.
    """

    acc_decimals: int = 0
    deadline_decimals: int = -2
    size_bin_bytes: float = 12_500.0
    tq_bin_ms: float = 750.0


@dataclasses.dataclass(frozen=True)
class AggregateClasses:
    """Class-aggregate view of one frame: grouping plus per-class rows.

    ``members`` lists request indices grouped by class and ascending within
    each class; class ``c`` owns ``members[offsets[c]:offsets[c + 1]]``.
    ``us`` / ``feas`` / ``v`` / ``u`` are the representative rows on the
    ``(n_classes, M, L)`` candidate grid.
    """

    count: np.ndarray      # (n_c,) int64 member counts
    first_idx: np.ndarray  # (n_c,) int64 lowest member request index
    members: np.ndarray    # (N,)  int64 request indices, class-grouped
    offsets: np.ndarray    # (n_c + 1,) int64 slice bounds into ``members``
    cover: np.ndarray      # (n_c,) int64 covering edge
    us: np.ndarray         # (n_c, M, L) f32 utility of the representative
    feas: np.ndarray       # (n_c, M, L) bool hard feasibility
    v: np.ndarray          # (n_c, M, L) f32 compute cost
    u: np.ndarray          # (n_c, M, L) f32 comm cost

    @property
    def n_classes(self) -> int:
        return self.count.shape[0]


def _group(inv: np.ndarray, n_classes: int):
    """Grouping arrays from a class-id-per-request vector."""
    n = inv.shape[0]
    count = np.bincount(inv, minlength=n_classes).astype(np.int64)
    first_idx = np.full(n_classes, n, np.int64)
    np.minimum.at(first_idx, inv, np.arange(n, dtype=np.int64))
    members = np.argsort(inv, kind="stable").astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(count)]).astype(np.int64)
    return count, first_idx, members, offsets


def aggregate_instance(inst: FlatInstance, decimals: Optional[int] = None) -> AggregateClasses:
    """Bucket an unbatched :class:`FlatInstance`'s rows into QoS classes.

    Two requests share a class iff their scheduling problem is identical:
    same covering edge, same QoS (``A``, ``C``, weights) and the same
    ``ctime``/``v``/``u``/``acc``/``avail`` rows.  ``decimals=None`` keys on
    exact values (lossless classes); an integer rounds ``ctime`` and ``u``
    first (``numpy.round``), merging near-identical requests.  The
    representative of each class is its lowest-index member, whose
    *unrounded* rows feed utility and feasibility.
    """
    a = inst.numpy()
    A = a["A"]
    N = A.shape[0]
    ct = a["ctime"].astype(np.float64)
    uu = a["u"].astype(np.float64)
    if decimals is not None:
        ct = np.round(ct, decimals)
        uu = np.round(uu, decimals)
    mat = np.concatenate(
        [
            a["cover"].astype(np.float64)[:, None],
            A.astype(np.float64)[:, None],
            a["C"].astype(np.float64)[:, None],
            a["w_a"].astype(np.float64)[:, None],
            a["w_c"].astype(np.float64)[:, None],
            ct.reshape(N, -1),
            uu.reshape(N, -1),
            a["v"].astype(np.float64).reshape(N, -1),
            a["acc"].astype(np.float64).reshape(N, -1),
            a["avail"].astype(np.float64).reshape(N, -1),
        ],
        axis=1,
    )
    _, inv = np.unique(mat, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    count, first_idx, members, offsets = _group(inv, int(inv.max()) + 1 if N else 0)

    # representative rows: the dense schedulers' utility and feasibility,
    # gathered at each class's first member
    rep = first_idx
    us = us_tensor(inst).cpu().numpy()[rep]
    feas = hard_feasible(inst).cpu().numpy()[rep]
    return AggregateClasses(
        count=count,
        first_idx=first_idx,
        members=members,
        offsets=offsets,
        cover=a["cover"][rep].astype(np.int64),
        us=us,
        feas=feas,
        v=a["v"][rep],
        u=a["u"][rep],
    )


def class_batch(insts: Sequence[FlatInstance], pad_to: Optional[int] = None, device=None):
    """The class allocator's inputs for a list of unbatched instances.

    Each instance's lossless classes (:func:`aggregate_instance`) are
    sorted by first member — the order the allocator walks them — padded
    with zero-count rows to ``pad_to`` classes (default: the largest class
    count), and stacked on a leading frame axis.  Returns ``(us, feas, v,
    u, cover, count, gamma, eta)`` tensors on ``device``, in
    :func:`repro_torch.kernels.hier.hier_cells`'s argument order.
    ``device`` follows :func:`resolve_device`: ``None`` means the card.
    """
    device = resolve_device(device)
    aggs = [aggregate_instance(i) for i in insts]
    Cp = max([pad_to or 0] + [a.n_classes for a in aggs])
    M, L = aggs[0].us.shape[1:] if aggs else (0, 0)
    B = len(aggs)
    us = np.zeros((B, Cp, M, L), np.float32)
    feas = np.zeros((B, Cp, M, L), bool)
    v = np.zeros((B, Cp, M, L), np.float32)
    u = np.zeros((B, Cp, M, L), np.float32)
    cover = np.zeros((B, Cp), np.int32)
    count = np.zeros((B, Cp), np.int32)
    for b, a in enumerate(aggs):
        o = np.argsort(a.first_idx, kind="stable")
        n = a.n_classes
        us[b, :n], feas[b, :n], v[b, :n], u[b, :n] = a.us[o], a.feas[o], a.v[o], a.u[o]
        cover[b, :n], count[b, :n] = a.cover[o], a.count[o]
    gamma = np.stack([i.gamma.cpu().numpy() for i in insts]).astype(np.float32)
    eta = np.stack([i.eta.cpu().numpy() for i in insts]).astype(np.float32)
    return tuple(
        torch.from_numpy(x).to(device) for x in (us, feas, v, u, cover, count, gamma, eta)
    )


def class_keys(
    cover: np.ndarray,
    service: np.ndarray,
    A: np.ndarray,
    C: np.ndarray,
    size: np.ndarray,
    tq: np.ndarray,
    quant: Optional[QuantizationConfig] = None,
) -> np.ndarray:
    """(n, 6) int64 class keys: (cover, service, rounded A, rounded C,
    payload-size bin, queueing-age bin).

    Every column is a pure per-request function — anchored ``floor(x /
    width)`` bins, no frame-level statistics — so a request's key is
    invariant to chunking, windowing and the arrival generator's rng mode.
    """
    quant = quant or QuantizationConfig()
    return np.column_stack(
        [
            np.asarray(cover).astype(np.int64),
            np.asarray(service).astype(np.int64),
            np.round(np.asarray(A, np.float64) * 10.0 ** quant.acc_decimals).astype(np.int64),
            np.round(
                np.asarray(C, np.float64) * 10.0 ** quant.deadline_decimals
            ).astype(np.int64),
            np.floor(np.asarray(size, np.float64) / quant.size_bin_bytes).astype(np.int64),
            np.floor(np.asarray(tq, np.float64) / quant.tq_bin_ms).astype(np.int64),
        ]
    )


def _unique_inverse_rows(key: np.ndarray) -> np.ndarray:
    """Inverse indices of ``np.unique(key, axis=0)`` via mixed-radix packing.

    Shifting each column to zero and packing most-significant-first keeps
    the scalar order identical to lexicographic row order, so the inverse
    (and every class index downstream) equals the ``axis=0`` path's, without
    its slow row sort.  Falls back to ``axis=0`` when the packed radix would
    overflow int64.
    """
    lo = key.min(axis=0)
    k = key - lo
    span = k.max(axis=0).astype(object) + 1
    radix = 1
    for s in span:
        radix *= int(s)
    if radix >= np.iinfo(np.int64).max:
        _, inv = np.unique(key, axis=0, return_inverse=True)
        return inv.reshape(-1)
    packed = k[:, 0]
    for c in range(1, key.shape[1]):
        packed = packed * int(span[c]) + k[:, c]
    _, inv = np.unique(packed, return_inverse=True)
    return inv


def aggregate_requests(
    cover: np.ndarray,
    service: np.ndarray,
    A: np.ndarray,
    C: np.ndarray,
    size: np.ndarray,
    tq: np.ndarray,
    quant: Optional[QuantizationConfig] = None,
):
    """Bucket raw request columns into QoS classes (fleet path, no grid).

    Classes key on :func:`class_keys`.  Returns ``(count, first_idx,
    members, offsets, rep)`` where ``rep`` is a dict of per-class
    ``cover``/``service`` (exact) and *count-weighted mean* ``A``/``C``/
    ``size``/``tq``; the caller builds the ``(n_classes, M, L)`` candidate
    grid from ``rep``.
    """
    quant = quant or QuantizationConfig()
    n = cover.shape[0]
    if n == 0:
        empty = np.zeros(0, np.int64)
        rep = dict(
            cover=empty,
            service=empty,
            A=np.zeros(0),
            C=np.zeros(0),
            size=np.zeros(0),
            tq=np.zeros(0),
        )
        return empty, empty, empty, np.zeros(1, np.int64), rep

    key = class_keys(cover, service, A, C, size, tq, quant)
    inv = _unique_inverse_rows(key)
    n_c = int(inv.max()) + 1
    count, first_idx, members, offsets = _group(inv, n_c)

    fcount = count.astype(np.float64)

    def _mean(x):
        return np.bincount(inv, weights=np.asarray(x, np.float64), minlength=n_c) / fcount

    rep = dict(
        cover=cover.astype(np.int64)[first_idx],
        service=service.astype(np.int64)[first_idx],
        A=_mean(A),
        C=_mean(C),
        size=_mean(size),
        tq=_mean(tq),
    )
    return count, first_idx, members, offsets, rep


def deaggregate(agg: AggregateClasses, chunks: np.ndarray, n_requests: int):
    """Map class-level ``(class, j, l, take)`` chunks back to per-request
    ``(j, l)`` assignments.

    Each chunk consumes its class's members in ascending request index, so
    the result is deterministic; unallocated members stay dropped (``-1``).
    """
    out_j = np.full(n_requests, -1, np.int32)
    out_l = np.full(n_requests, -1, np.int32)
    ptr = agg.offsets[:-1].copy()
    for c, j, l, take in chunks:
        sel = agg.members[ptr[c] : ptr[c] + take]
        out_j[sel] = j
        out_l[sel] = l
        ptr[c] += take
    return out_j, out_l


def hier_assign(
    agg: AggregateClasses,
    gamma: np.ndarray,
    eta: np.ndarray,
    *,
    exact: bool = False,
) -> np.ndarray:
    """Global pass: chunked greedy over one frame's class aggregates.

    Classes are taken in first-request-index order (the order dense GUS
    visits their members).  Each class repeats: pick the feasible
    utility-argmax cell (first occurrence on the flat ``j * L + l`` axis),
    fit as many members as the ``gamma``/``eta`` budgets allow, commit,
    until the class is exhausted or nothing fits.  Local cells charge only
    the server's ``gamma``; offload cells also the covering edge's ``eta``.

    ``exact=True`` consumes members one at a time with float32 budget
    subtraction (the reference's loop, op for op), reproducing dense GUS on
    lossless classes; ``exact=False`` sizes chunks analytically through the
    class allocator's plain version on the CPU, the fleet's op sequence.

    Returns an ``(n_chunks, 4)`` int64 array of ``(class, j, l, take)`` in
    allocation order.
    """
    if agg.n_classes == 0:
        return np.zeros((0, 4), np.int64)

    if not exact:  # analytic mode: the class allocator's cells, one frame
        order_all = np.argsort(agg.first_idx, kind="stable")

        def one(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[order_all], dtype))[None]

        take, start = hier_cells_ref(
            one(agg.us, np.float32), one(agg.feas, bool), one(agg.v, np.float32),
            one(agg.u, np.float32), one(agg.cover, np.int32), one(agg.count, np.int32),
            torch.tensor(np.asarray(gamma, np.float32))[None],
            torch.tensor(np.asarray(eta, np.float32))[None],
        )
        take, start = take[0].numpy(), start[0].numpy()
        ci, jj, ll = np.nonzero(take > 0)
        if ci.size == 0:
            return np.zeros((0, 4), np.int64)
        # classes allocate strictly in order and within a class ``start`` is
        # the running member offset, so (class position, start) IS the
        # allocation order
        o = np.lexsort((start[ci, jj, ll], ci))
        return np.column_stack(
            [order_all[ci], jj, ll, take[ci, jj, ll]]
        )[o].astype(np.int64)

    gamma = np.asarray(gamma, np.float32).copy()
    eta = np.asarray(eta, np.float32).copy()
    M = gamma.shape[0]
    L = agg.us.shape[-1]
    server = np.arange(M)

    # pass-1 screening: classes infeasible everywhere never enter the queue
    alive = agg.feas.any(axis=(1, 2))
    order = np.argsort(agg.first_idx, kind="stable")
    order = order[alive[order]]

    chunks = []
    for c in order:
        rem = int(agg.count[c])
        s = int(agg.cover[c])
        row_us = agg.us[c]
        row_v = np.asarray(agg.v[c], np.float32)
        row_u = np.asarray(agg.u[c], np.float32)
        local = (server == s)[:, None]
        feas = agg.feas[c]
        while rem > 0:
            ok = feas & (row_v <= gamma[:, None]) & (local | (row_u <= eta[s]))
            if not ok.any():
                break
            flat = int(np.argmax(np.where(ok, row_us, NEG)))
            j, l = divmod(flat, L)
            vv = row_v[j, l]
            uv = row_u[j, l]
            take = 0
            while take < rem:
                if vv > gamma[j] or (j != s and uv > eta[s]):
                    break
                gamma[j] -= vv
                if j != s:
                    eta[s] -= uv
                take += 1
            if take <= 0:
                break  # float edge: argmax cell passed ``ok`` but fits zero
            chunks.append((int(c), j, l, take))
            rem -= take
    if not chunks:
        return np.zeros((0, 4), np.int64)
    return np.asarray(chunks, np.int64)


def make_gus_hier(decimals: Optional[int] = None):
    """A scheduler callable running GUS over one frame's class aggregates
    (host-side numpy; the frame's tensors are read on the CPU).

    ``decimals=None`` (the registered ``gus-hier`` default) keys classes on
    exact row content and allocates in exact mode — bit-parity with dense
    GUS on every frame whose classes are index-contiguous, which includes
    all frames with singleton classes.  Pass ``decimals`` to merge
    near-identical requests (lossy, bounded satisfaction drift).
    """

    def schedule(inst: FlatInstance) -> Assignment:
        n = int(inst.A.shape[0])
        if n == 0:
            z = torch.zeros(0, dtype=torch.int32)
            return Assignment(z, z)
        agg = aggregate_instance(inst, decimals=decimals)
        chunks = hier_assign(
            agg, inst.gamma.cpu().numpy(), inst.eta.cpu().numpy(), exact=True
        )
        out_j, out_l = deaggregate(agg, chunks, n)
        return Assignment(torch.from_numpy(out_j), torch.from_numpy(out_l))

    return schedule


def hier_schedule_np(inst: FlatInstance) -> Assignment:
    """Module-level exact-mode entry point (see :func:`make_gus_hier`)."""
    return make_gus_hier()(inst)
