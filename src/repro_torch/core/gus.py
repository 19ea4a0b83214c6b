"""GUS — the paper's greedy scheduler (Algorithm 1) in PyTorch.

Three implementations, held to bit-identical integer assignments with each
other and with the reference ``repro.core.gus`` (exact equality, not a
tolerance):

* :func:`gus_schedule_np` — the NumPy oracle, a copy of the reference's
  line-by-line transcription of Algorithm 1;
* ``backend="torch"`` — the plain PyTorch loop over requests with a batched
  masked argmax per step (:func:`repro_torch.kernels.gus.gus_assign_ref`,
  the reference's ``_gus_body`` with the batch axis written out);
* ``backend="cuda"`` — the hand-written Hopper kernel
  (:func:`repro_torch.kernels.gus.gus_assign`).

The tie-break rule is shared: among equal-utility feasible candidates, the
lowest flat ``j * L + l`` index wins (first-occurrence argmax; the oracle
uses a stable descending sort).

:func:`gus_schedule` and :func:`gus_schedule_batch` run on the card unless
the caller asks for the CPU (``device=None`` means ``"cuda"``; without a
CUDA device they raise).  The backend follows
:func:`repro_torch.core.options.resolve_backend`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.gus import gus_assign, gus_assign_ref
from repro_torch.obs.profiler import annotate

from .instance import FlatInstance, resolve_device
from .options import BACKENDS, resolve_backend
from .satisfaction import us_tensor

__all__ = [
    "Assignment",
    "GUS_BACKENDS",
    "gus_schedule",
    "gus_schedule_np",
    "gus_schedule_batch",
]

GUS_BACKENDS = BACKENDS


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Scheduling decision per request: server j and variant l (-1 = dropped).

    ``loads`` is the ``(w, c)`` pair of per-server committed compute and
    offloaded uplink, summed in request order, when the scheduler computed
    it (the GUS backends do); ``None`` otherwise.
    """

    j: torch.Tensor  # (..., N) int32
    l: torch.Tensor  # (..., N) int32
    loads: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def gus_schedule_np(inst: FlatInstance) -> Assignment:
    """Algorithm 1, line by line, in NumPy (one unbatched instance)."""
    cover = inst.cover.cpu().numpy()
    A = inst.A.cpu().numpy()
    C = inst.C.cpu().numpy()
    acc = inst.acc.cpu().numpy()
    ctime = inst.ctime.cpu().numpy()
    v = inst.v.cpu().numpy()
    u = inst.u.cpu().numpy()
    avail = inst.avail.cpu().numpy()
    gamma = inst.gamma.cpu().numpy().copy()
    eta = inst.eta.cpu().numpy().copy()
    N, M, L = acc.shape

    us = us_tensor(inst).cpu().numpy()
    out_j = np.full(N, -1, np.int32)
    out_l = np.full(N, -1, np.int32)

    for i in range(N):  # foreach request (line 1)
        s_i = cover[i]  # line 2
        # line 3: candidates by US descending; the stable sort keeps
        # equal-utility candidates in ascending flat (j*L + l) order
        order = np.argsort(-us[i], axis=None, kind="stable")
        for flat in order:
            j, l = divmod(int(flat), L)
            # line 4: placement, deadline, accuracy floor, compute capacity
            if not avail[i, j, l]:
                continue
            if ctime[i, j, l] > C[i] or acc[i, j, l] < A[i]:
                continue
            if v[i, j, l] > gamma[j]:
                continue
            if j == s_i:  # lines 5-9: local processing
                out_j[i], out_l[i] = j, l
                gamma[j] -= v[i, j, l]
                break
            elif u[i, j, l] <= eta[s_i]:  # lines 10-14: offload
                out_j[i], out_l[i] = j, l
                gamma[j] -= v[i, j, l]
                eta[s_i] -= u[i, j, l]
                break
    return Assignment(torch.from_numpy(out_j), torch.from_numpy(out_l))


def _relaxed_budgets(inst: FlatInstance, relax_compute: bool, relax_comm: bool):
    """The Happy-* budget substitution: a relaxed constraint gets +inf."""
    gamma0 = torch.full_like(inst.gamma, float("inf")) if relax_compute else inst.gamma
    eta0 = torch.full_like(inst.eta, float("inf")) if relax_comm else inst.eta
    return gamma0, eta0


def _run_batch(
    batch: FlatInstance, backend: str, relax_compute: bool, relax_comm: bool, prio=None,
    single: bool = False,
):
    """One GUS call over a batch of frames, under a profiler annotation
    naming the implementation (``gus/cuda_kernel[_batch]`` or
    ``gus/torch[_batch]``; ``single``: a batch of one from
    :func:`gus_schedule`)."""
    B = batch.A.shape[0]
    gamma0, eta0 = _relaxed_budgets(batch, relax_compute, relax_comm)
    fn = gus_assign if backend == "cuda" else gus_assign_ref
    label = ("gus/cuda_kernel" if backend == "cuda" else "gus/torch") + ("" if single else "_batch")
    with annotate(label):
        j, l, w, c = fn(
            batch.cover.contiguous(), batch.A.contiguous(), batch.C.contiguous(),
            batch.w_a.contiguous(), batch.w_c.contiguous(), batch.acc.contiguous(),
            batch.ctime.contiguous(), batch.v.contiguous(), batch.u.contiguous(),
            batch.avail.contiguous(), gamma0.contiguous(), eta0.contiguous(),
            batch.max_as.expand(B).contiguous(), batch.max_cs.expand(B).contiguous(),
            None if prio is None else prio.contiguous(),
        )
    return Assignment(j, l, (w, c))


def gus_schedule_batch(
    batch: FlatInstance,
    *,
    relax_compute: bool = False,
    relax_comm: bool = False,
    backend: Optional[str] = None,
    prio=None,
    device=None,
) -> Assignment:
    """GUS over a leading instance-batch axis (one kernel launch for the
    whole batch on the ``"cuda"`` backend).  ``relax_*`` implement the
    paper's Happy-Computation / Happy-Communication baselines; ``prio``
    (``(B, N)`` float32, optional) scales each request's utility once
    (the reference's priority weights)."""
    dev = resolve_device(device)
    batch = batch.to(dev)
    if prio is not None:
        prio = prio.to(device=dev, dtype=torch.float32)
    return _run_batch(
        batch, resolve_backend(backend, dev), relax_compute, relax_comm, prio
    )


def gus_schedule(
    inst: FlatInstance,
    *,
    relax_compute: bool = False,
    relax_comm: bool = False,
    backend: Optional[str] = None,
    device=None,
) -> Assignment:
    """Run GUS on one instance (a batch of one)."""
    dev = resolve_device(device)
    one = FlatInstance(
        **{f.name: getattr(inst, f.name)[None] for f in dataclasses.fields(inst)}
    ).to(dev)
    a = _run_batch(one, resolve_backend(backend, dev), relax_compute, relax_comm, single=True)
    return Assignment(a.j[0], a.l[0], (a.loads[0][0], a.loads[1][0]))
