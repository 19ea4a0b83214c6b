"""Hierarchical class allocator (analytic chunk greedy over QoS classes) and
its plain PyTorch version.

:func:`hier_cells` is the port of the TPU kernel
``repro/kernels/hier_pallas.py::hier_cells_pallas``.  Per frame it walks
the ``C`` classes in order, carrying the per-server budgets ``gamma``/``eta``
across them; per class it repeats a masked argmax over the ``(M, L)`` cells,
sizes a chunk analytically (``floor(budget / cost)``) and commits it, until
the class is exhausted or nothing fits.  On CUDA tensors it launches the
hand-written Hopper kernel in ``csrc/hier_cells.cu`` (built with ``nvcc`` at
first use, bound with ``ctypes``) or raises; on CPU tensors it runs
:func:`hier_cells_ref`, the plain version.  There is no fallback from the
kernel to the plain version.  ``hier_cells.launches`` counts the kernel
launches.

Both return ``(take, start)``, int32 ``(B, C, M, L)``: ``take[b, c, j, l]``
members of class ``c`` run variant ``l`` on server ``j``, starting at member
offset ``start[b, c, j, l]`` — and, with ``loads=True``, the float32
``(B, M)`` committed compute ``w`` and offloaded uplink ``c_load``.

The float32 op sequence is the parity contract, op for op that of the
reference's NumPy oracle, XLA scan and Pallas kernel:

* ``cap_g = floor(gamma[j] / v)`` if ``v > 0`` else the remainder;
  ``cap_e = floor(eta[s] / u)`` if offloaded and ``u > 0`` else the
  remainder; ``t = int(min(rem, min(cap_g, cap_e)))`` — the ``min`` against
  the remainder comes *before* the int cast (the overflow guard for tiny
  costs);
* the commit ``gamma[j] + (-(f32(t) * v))``, and ``eta[s]`` likewise when
  offloaded;
* first-occurrence argmax on the flat ``j * L + l`` axis, sentinel
  ``-1e30``; a class with a zero count or no feasible cell never touches
  the budgets.

Committed loads are summed in a fixed order, the same on every device:
``w[j]`` adds ``f32(take) * v`` over classes in order and, within a class,
over ``l``; ``c_load[cover[c]]`` adds each class's ``sum(f32(take) * u)``
(its cells in row-major ``(j, l)`` order) in class order.  A scatter with
float atomics would add in no fixed order, and with congestion on a 1-ulp
backlog change can flip a later greedy decision.  XLA's own reduction of
the same sums (tree-blocked above 32 classes, with fused multiply-adds on
the CPU) is not reproduced: ROADMAP.md §3 gives the measured difference.

This module depends only on torch (and, for ``backend=None``, on the
port's option resolution); the fleet imports it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import load_library

__all__ = ["NEG", "class_loads", "hier_cells", "hier_cells_ref"]

#: the masked-out cell score; a cell is usable iff its score is > NEG
NEG = -1e30

_N_ARGS = 12  # pointers passed to hier_cells_launch before the sizes
#: classes per block of the plain version's skip test
_SKIP_BLOCK = 256


def hier_cells_ref(us, feas, v, u, cover, count, gamma, eta, *, loads: bool = False):
    """Plain PyTorch class allocator over a batch of frames, on the tensors'
    device.

    A Python loop over classes and, inside it, over chunk steps until no
    frame of the batch is still allocating that class; each step is the
    masked first-occurrence argmax and the analytic chunk of every frame at
    once — the reference's ``_hier_cells_xla`` with the batch axis written
    out.  Frames that are done take a no-op step (a zero chunk).  Classes
    that can no longer place anyone are skipped (an exact shortcut, see
    below).
    """
    B, C, M, L = us.shape
    dev = us.device
    take = torch.zeros((B, C, M, L), dtype=torch.int32, device=dev)
    start = torch.zeros_like(take)
    gamma = gamma.clone()
    eta = eta.clone()
    rows = torch.arange(B, device=dev)
    servers = torch.arange(M, device=dev)
    live = (count > 0).any(0).nonzero() if B else count[:0]
    n_live = int(live.max()) + 1 if live.numel() else 0  # trailing padding rows
    for c0 in range(0, n_live, _SKIP_BLOCK):
        # a class none of whose cells fits the current budgets never will
        # (budgets only shrink) and leaves them untouched: skip it.  The
        # test runs on a block of classes at once, so an overloaded frame
        # walks only the classes that can still place someone.
        blk = slice(c0, min(c0 + _SKIP_BLOCK, n_live))
        s_b = cover[:, blk].long()
        fits = (
            feas[:, blk]
            & (v[:, blk] <= gamma[:, None, :, None])
            & ((servers[None, None, :] == s_b[:, :, None])[..., None]
               | (u[:, blk] <= eta.gather(1, s_b)[:, :, None, None]))
        )
        walk = ((count[:, blk] > 0) & fits.flatten(2).any(2)).any(0).nonzero()[:, 0]
        for c in (walk + c0).tolist():
            _walk_class(c, us, feas, v, u, cover, count, gamma, eta, take, start, rows, servers)
    return (take, start) + class_loads(take, v, u, cover) if loads else (take, start)


def _walk_class(c, us, feas, v, u, cover, count, gamma, eta, take, start, rows, servers):
    """Allocate class ``c`` of every frame in place: chunk steps until no
    frame is still placing members of it."""
    B, _, M, L = us.shape
    ML = M * L
    neg = torch.tensor(NEG, dtype=torch.float32, device=us.device)
    zero = torch.tensor(0.0, dtype=torch.float32, device=us.device)
    one = torch.tensor(1.0, dtype=torch.float32, device=us.device)
    s = cover[:, c].long()
    rem = count[:, c].clone()
    used = torch.zeros_like(rem)
    us_c = us[:, c].reshape(B, ML)
    feas_c = feas[:, c]
    v_c, u_c = v[:, c], u[:, c]
    is_local = (servers[None, :] == s[:, None])[:, :, None]
    active = (rem > 0) & feas_c.reshape(B, ML).any(1)
    while bool(active.any()):
        eta_s = eta[rows, s]
        ok = feas_c & (v_c <= gamma[:, :, None]) & (is_local | (u_c <= eta_s[:, None, None]))
        score = torch.where(ok.reshape(B, ML), us_c, neg)
        flat = score.argmax(1)
        any_ok = score.gather(1, flat[:, None])[:, 0] > NEG
        j = flat // L
        l = flat % L
        vv = v_c.reshape(B, ML).gather(1, flat[:, None])[:, 0]
        uv = u_c.reshape(B, ML).gather(1, flat[:, None])[:, 0]
        offl = j != s
        rem_f = rem.to(torch.float32)
        g_j = gamma[rows, j]
        cap_g = torch.where(vv > 0, torch.floor(g_j / torch.where(vv > 0, vv, one)), rem_f)
        cap_e = torch.where(
            offl & (uv > 0), torch.floor(eta_s / torch.where(uv > 0, uv, one)), rem_f
        )
        t = torch.minimum(rem_f, torch.minimum(cap_g, cap_e)).to(torch.int32)
        do = active & any_ok & (t >= 1)
        t = torch.where(do, t, 0)
        tf32 = t.to(torch.float32)
        gamma[rows, j] = g_j + (-(tf32 * vv))
        eta[rows, s] = eta_s + torch.where(offl, -(tf32 * uv), zero)
        cell = take[rows, c, j, l]
        start[rows, c, j, l] = torch.where(do & (cell == 0), used, start[rows, c, j, l])
        take[rows, c, j, l] = cell + t
        used = used + t
        rem = rem - t
        active = do & (rem > 0)


def class_loads(take, v, u, cover):
    """Committed per-server loads ``(w, c_load)`` of an allocation, float32
    ``(B, M)``, in the allocator's fixed order: ``w[j]`` adds
    ``f32(take) * v`` over classes in order and, within a class, over
    ``l``; ``c_load[cover[c]]`` adds each class's ``sum(f32(take) * u)``
    (its cells in row-major ``(j, l)`` order) in class order.

    Only allocated cells are added: the rest would add exact zeros.  Per
    class, the ``k``-th allocated cell of every frame is added at once; a
    frame with fewer cells adds an exact zero.
    """
    B, C, M, L = take.shape
    ML = M * L
    dev = take.device
    w = torch.zeros((B, M), dtype=torch.float32, device=dev)
    c_load = torch.zeros_like(w)
    rows = torch.arange(B, device=dev)
    flats = torch.arange(ML, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_cells = (take.reshape(B, C, ML) > 0).sum(-1).amax(0).tolist() if B else []
    for c, k_max in enumerate(n_cells):
        if not k_max:
            continue
        tf = take[:, c].reshape(B, ML).to(torch.float32)
        pv = tf * v[:, c].reshape(B, ML)
        pu = tf * u[:, c].reshape(B, ML)
        order = torch.where(tf > 0, flats[None, :], ML).sort(dim=1).values[:, :k_max]
        valid = order < ML
        order = order.clamp_max(ML - 1)
        sc = torch.zeros(B, dtype=torch.float32, device=dev)
        for k in range(k_max):
            f = order[:, k : k + 1]
            ok = valid[:, k]
            j = f[:, 0] // L
            w[rows, j] = w[rows, j] + torch.where(ok, pv.gather(1, f)[:, 0], zero)
            sc = sc + torch.where(ok, pu.gather(1, f)[:, 0], zero)
        s = cover[:, c].long()
        c_load[rows, s] = c_load[rows, s] + sc
    return w, c_load


def _library() -> ctypes.CDLL:
    lib = load_library("hier_cells")
    if not getattr(lib, "_argtypes_set", False):
        lib.hier_cells_launch.argtypes = (
            [ctypes.c_void_p] * _N_ARGS + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        lib.hier_cells_launch.restype = ctypes.c_int
        lib.hier_error_string.argtypes = [ctypes.c_int]
        lib.hier_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"hier_cells: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"hier_cells: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"hier_cells: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"hier_cells: {name} is not contiguous")


def hier_cells(
    us, feas, v, u, cover, count, gamma, eta, *,
    backend: Optional[str] = None, loads: bool = False,
):
    """The class allocator over a batch of frames.

    Shapes: ``us/v/u`` ``(B, C, M, L)`` float32, ``feas`` ``(B, C, M, L)``
    bool, ``cover/count`` ``(B, C)`` int32 (classes pre-sorted by first
    member), ``gamma/eta`` ``(B, M)`` float32, all on one device.

    ``backend`` takes the port's GUS backend names: ``"torch"`` is the plain
    version on the tensors' device, ``"cuda"`` the kernel; ``None`` defers
    to ``REPRO_TORCH_GUS_BACKEND``, else follows the device.  CPU tensors
    always take the plain version; CUDA tensors on ``"cuda"`` launch the
    kernel or raise.
    """
    dev = us.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"hier_cells runs on CUDA or CPU tensors, not {dev.type}")
    from repro_torch.core.options import resolve_backend

    if dev.type == "cpu" or resolve_backend(backend, dev) == "torch":
        return hier_cells_ref(us, feas, v, u, cover, count, gamma, eta, loads=loads)
    B, C, M, L = us.shape
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("us", us, f32, (B, C, M, L)), ("feas", feas, torch.bool, (B, C, M, L)),
        ("v", v, f32, (B, C, M, L)), ("u", u, f32, (B, C, M, L)),
        ("cover", cover, i32, (B, C)), ("count", count, i32, (B, C)),
        ("gamma", gamma, f32, (B, M)), ("eta", eta, f32, (B, M)),
    ):
        _check(name, t, dtype, shape, dev)
    take = torch.zeros((B, C, M, L), dtype=i32, device=dev)
    start = torch.zeros_like(take)
    w = torch.zeros((B, M), dtype=f32, device=dev)
    c_load = torch.zeros_like(w)
    out = (take, start, w, c_load) if loads else (take, start)
    if B == 0 or C == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hier_cells_launch(
            us.data_ptr(), feas.view(torch.uint8).data_ptr(), v.data_ptr(),
            u.data_ptr(), cover.data_ptr(), count.data_ptr(), gamma.data_ptr(),
            eta.data_ptr(), take.data_ptr(), start.data_ptr(), w.data_ptr(),
            c_load.data_ptr(),
            B, C, M, L, int(loads), stream,
        )
    if err != 0:
        msg = lib.hier_error_string(err).decode()
        raise RuntimeError(f"hier_cells kernel launch failed: CUDA error {err} ({msg})")
    hier_cells.launches += 1
    return out


#: kernel launches since the count was last set to 0
hier_cells.launches = 0
