"""GUS assignment kernel (Algorithm 1 over a batch of frames) and its plain
PyTorch version.

:func:`gus_assign` is the port of the TPU kernel
``repro/kernels/gus_pallas.py::gus_assign_pallas``.  On CUDA tensors it
launches the hand-written Hopper kernel in ``csrc/gus_assign.cu`` (built
with ``nvcc`` at first use, bound with ``ctypes``) or raises; on CPU tensors
it runs :func:`gus_assign_ref`, the plain version.  There is no fallback
from the kernel to the plain version.  ``gus_assign.launches`` counts the
kernel launches.

Both take an optional per-row ``prio`` ``(B, N)`` float32: each row's
utility is multiplied by it once, after it is formed and before the argmax
(the reference's ``us * priority[:, None, None]`` in
``repro.core.extensions.gus_schedule_ordered``).  On the card that is a
second C entry, ``gus_assign_launch_scaled``, the same kernel template with
the scale compiled in; ``gus_assign_launch`` keeps its interface.

Both return ``(j, l, w, c)``: int32 ``(B, N)`` assignments with -1 = drop,
and float32 ``(B, M)`` per-server committed compute ``w`` and offloaded
uplink ``c``, each summed in request order.  That order is the reference's
sequential scatter-add (``repro.core.queueing.committed_loads``), and the
congested fleet's backlog depends on it bit for bit; a scatter with float
atomics on the card would sum in no fixed order.

This module depends only on torch, never on ``repro_torch.core`` (the
core's GUS module imports it).  The utility and feasibility expressions are
op for op those of ``repro_torch.core.satisfaction``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .build import load_library

__all__ = ["MAX_CELLS", "MAX_SERVERS", "NEG", "gus_assign", "gus_assign_ref"]

#: the masked-out candidate score; served iff the best score is > NEG
NEG = -1e30

_N_ARGS = 18  # pointers passed to gus_assign_launch before the sizes (one more when scaled)
#: the widest request row the kernel's shared-memory ring takes (one row per
#: stage), as MAX_CELLS and MAX_SERVERS in csrc/gus_assign.cu
MAX_CELLS = 4096
MAX_SERVERS = 1024


def gus_assign_ref(
    cover, A, C, w_a, w_c, acc, ctime, v, u, avail, gamma, eta, max_as, max_cs, prio=None
):
    """Plain PyTorch GUS over a batch of frames, on the tensors' device.

    A Python loop over the N requests, each step a masked first-occurrence
    argmax over the (M, L) slab of every frame at once — the reference's
    ``_gus_body`` with a batch axis written out.  ``prio`` (optional,
    ``(B, N)``) scales each row's utility once.
    """
    B, N, M, L = acc.shape
    dev = acc.device
    out_j = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    out_l = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    w = torch.zeros((B, M), dtype=torch.float32, device=dev)
    c = torch.zeros((B, M), dtype=torch.float32, device=dev)
    if N == 0 or B == 0:
        return out_j, out_l, w, c
    acc_term = (acc - A[..., :, None, None]) / max_as[:, None, None, None]
    time_term = (C[..., :, None, None] - ctime) / max_cs[:, None, None, None]
    us = w_a[..., :, None, None] * acc_term + w_c[..., :, None, None] * time_term
    if prio is not None:
        us = us * prio[..., :, None, None]
    feas = avail & (acc >= A[..., :, None, None]) & (ctime <= C[..., :, None, None])

    gamma = gamma.clone()
    eta = eta.clone()
    rows = torch.arange(B, device=dev)
    servers = torch.arange(M, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    for i in range(N):
        s = cover[:, i].long()
        row_v = v[:, i].reshape(B, M * L)
        row_u = u[:, i].reshape(B, M * L)
        eta_s = eta[rows, s]
        is_local = servers[None, :] == s[:, None]
        ok = (
            feas[:, i]
            & (v[:, i] <= gamma[:, :, None])
            & (is_local[:, :, None] | (u[:, i] <= eta_s[:, None, None]))
        )
        score = torch.where(ok, us[:, i], neg).reshape(B, M * L)
        flat = score.argmax(dim=1)
        served = score.gather(1, flat[:, None])[:, 0] > NEG
        j = flat // L
        v_pick = row_v.gather(1, flat[:, None])[:, 0]
        u_pick = row_u.gather(1, flat[:, None])[:, 0]
        offload = served & (j != s)
        gamma[rows, j] = gamma[rows, j] + torch.where(served, -v_pick, zero)
        eta[rows, s] = eta[rows, s] + torch.where(offload, -u_pick, zero)
        w[rows, j] = w[rows, j] + torch.where(served, v_pick, zero)
        c[rows, s] = c[rows, s] + torch.where(offload, u_pick, zero)
        out_j[:, i] = torch.where(served, j, -1).to(torch.int32)
        out_l[:, i] = torch.where(served, flat % L, -1).to(torch.int32)
    return out_j, out_l, w, c


def _library() -> ctypes.CDLL:
    lib = load_library("gus_assign")
    if not getattr(lib, "_argtypes_set", False):
        for fn, n_ptr in ((lib.gus_assign_launch, _N_ARGS),
                          (lib.gus_assign_launch_scaled, _N_ARGS + 1)):
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gus_error_string.argtypes = [ctypes.c_int]
        lib.gus_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"gus_assign: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"gus_assign: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"gus_assign: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"gus_assign: {name} is not contiguous")


def gus_assign(
    cover, A, C, w_a, w_c, acc, ctime, v, u, avail, gamma, eta, max_as, max_cs, prio=None
):
    """GUS over a batch of frames: the Hopper kernel on CUDA tensors, the
    plain version on CPU tensors.

    Shapes: ``cover/A/C/w_a/w_c`` ``(B, N)`` (cover int32, the rest
    float32); ``acc/ctime/v/u`` ``(B, N, M, L)`` float32; ``avail``
    ``(B, N, M, L)`` bool; ``gamma/eta`` ``(B, M)`` and ``max_as/max_cs``
    ``(B,)`` float32; ``prio`` ``None`` or ``(B, N)`` float32.  Every tensor
    is contiguous and on one device.  The
    kernel takes rows of at most ``MAX_CELLS`` cells and ``MAX_SERVERS``
    servers and raises ``RuntimeError`` on a wider one before the launch.
    """
    dev = acc.device
    if dev.type == "cpu":
        return gus_assign_ref(
            cover, A, C, w_a, w_c, acc, ctime, v, u, avail, gamma, eta, max_as, max_cs, prio
        )
    if dev.type != "cuda":
        raise ValueError(f"gus_assign runs on CUDA or CPU tensors, not {dev.type}")
    B, N, M, L = acc.shape
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("cover", cover, torch.int32, (B, N)), ("A", A, f32, (B, N)),
        ("C", C, f32, (B, N)), ("w_a", w_a, f32, (B, N)), ("w_c", w_c, f32, (B, N)),
        ("acc", acc, f32, (B, N, M, L)), ("ctime", ctime, f32, (B, N, M, L)),
        ("v", v, f32, (B, N, M, L)), ("u", u, f32, (B, N, M, L)),
        ("avail", avail, torch.bool, (B, N, M, L)),
        ("gamma", gamma, f32, (B, M)), ("eta", eta, f32, (B, M)),
        ("max_as", max_as, f32, (B,)), ("max_cs", max_cs, f32, (B,)),
    ) + ((("prio", prio, f32, (B, N)),) if prio is not None else ()):
        _check(name, t, dtype, shape, dev)
    if M * L > MAX_CELLS or M > MAX_SERVERS:
        raise RuntimeError(
            f"gus_assign: a request row of M={M} servers x L={L} variants is wider than "
            f"the kernel takes (M * L <= {MAX_CELLS} cells, M <= {MAX_SERVERS} servers)"
        )
    out_j = torch.empty((B, N), dtype=torch.int32, device=dev)
    out_l = torch.empty((B, N), dtype=torch.int32, device=dev)
    w = torch.zeros((B, M), dtype=f32, device=dev)
    c = torch.zeros((B, M), dtype=f32, device=dev)
    if N == 0 or B == 0:
        return out_j, out_l, w, c
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ins = [
            cover.data_ptr(), A.data_ptr(), C.data_ptr(), w_a.data_ptr(),
            w_c.data_ptr(), acc.data_ptr(), ctime.data_ptr(), v.data_ptr(),
            u.data_ptr(), avail.view(torch.uint8).data_ptr(), gamma.data_ptr(),
            eta.data_ptr(), max_as.data_ptr(), max_cs.data_ptr(),
        ]
        if prio is None:
            entry = lib.gus_assign_launch
        else:
            entry = lib.gus_assign_launch_scaled
            ins.append(prio.data_ptr())
        err = entry(
            *ins, out_j.data_ptr(), out_l.data_ptr(), w.data_ptr(), c.data_ptr(),
            B, N, M, L, stream,
        )
    if err != 0:
        msg = lib.gus_error_string(err).decode()
        raise RuntimeError(f"gus_assign kernel launch failed: CUDA error {err} ({msg})")
    with _COUNT_LOCK:  # the multi-device fleet launches from several threads
        gus_assign.launches += 1
    return out_j, out_l, w, c


#: kernel launches since the count was last set to 0
gus_assign.launches = 0
_COUNT_LOCK = threading.Lock()
