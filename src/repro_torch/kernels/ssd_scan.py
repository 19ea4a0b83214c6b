"""Mamba-2 chunked SSD scan: the Hopper kernel and its plain PyTorch versions.

:func:`ssd_scan` is the port of the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``.  On CUDA tensors it launches one
of two hand-written kernels (built with ``nvcc`` at first use, bound with
``ctypes``) or raises; on CPU tensors it runs :func:`ssd_scan_ref`.  There
is no fallback from a kernel to the plain version or to the other kernel.
The route is chosen before the launch by :func:`ssd_route`, from the dtype
and the shape alone:

* ``"wgmma"``: ``csrc/ssd_scan_wgmma.cu``, bf16 at head dim 64, state 64
  or 128 and chunk 128 (the serving models' shapes), all four products on
  the tensor cores (wgmma), x/B/C tiles fed by TMA.  Its operands W, the
  state and ``x * exp(cs_Q - cs) * dt`` are each split into two bf16 terms
  (hi + lo) for the products, so it agrees with the f32 form to within a
  bf16 step of y;
* ``"simt"``: ``csrc/ssd_scan.cu``, f32 and every other shape, f32
  products on the CUDA cores.

Each launch counts one ``kernel.launches.ssd.<route>``, and each call
that runs the plain version one ``...plain`` (``obs.counters``).

Kernel layout: x ``(B, H, S, P)``, dt ``(B, H, S)``, A ``(H,)`` f32,
Bm/Cm ``(B, G, S, N)`` with query head h reading SSM group
``h // (H // G)`` (the groups are never repeated over heads), y
``(B, H, S, P)`` in x's dtype, and optionally the final state
``(B, H, N, P)`` in f32.  The scan starts from ``initial_state`` (B, H,
N, P), f32 contiguous on the kernel route (the reference's
``ssd_reference(initial_state=)``), or from a zero state.  The kernel
reads x, Bm, Cm and y through their strides (unit stride on the last
axis; dt any strides), so ``ops.ssd``
hands it transposed views of the model's ``(B, S, ...)`` tensors and an
output view.  Unlike the Pallas kernel it takes any S: positions past S in
the last chunk count as dt = 0, the reference's own padding rule, which is
exact; and it can write out the final state, which the serving prefill
needs.  The ``"wgmma"`` route describes x, Bm and Cm to TMA, which needs a
16-byte aligned base and strides that are multiples of 16 bytes, and
writes y two values at a time (even strides, 4-byte aligned base): the
wrapper checks both and raises otherwise, with no copy.

:func:`ssd_reference` is the port's copy of the reference's chunked einsum
form (``repro/models/ssm.py::ssd_reference``, model layout, with its
right-padding rule for a ragged S); :func:`ssd_scan_ref` is the port's copy
of ``repro/kernels/ref.py::ssd_ref`` (kernel layout), which calls it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..obs import counters
from .build import load_library
from .common import DTYPES, check_no_grad, check_tensor, resolve_model_backend, tma_strides

__all__ = [
    "MAX_CHUNK",
    "MAX_STATE",
    "MAX_HEAD_DIM",
    "ssd_reference",
    "ssd_route",
    "ssd_scan",
    "ssd_scan_ref",
    "check_ssd_inputs",
]

_LAUNCHED = counters.launch_names("ssd")  # route -> launch counter

#: the kernel's limits: chunk Q <= 128 and state N <= 128 (both multiples
#: of 4), head dim P <= 64
MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 64
#: the tensor-core route's shapes (bf16 only): head dim, state sizes, chunk
WGMMA_HEAD_DIM, WGMMA_STATES, WGMMA_CHUNK = 64, (64, 128), 128


def ssd_route(dtype, P: int, N: int, chunk: int) -> str:
    """The kernel a CUDA launch takes: ``"wgmma"`` for bf16 at head dim
    :data:`WGMMA_HEAD_DIM`, a state size of :data:`WGMMA_STATES` and chunk
    :data:`WGMMA_CHUNK`, else ``"simt"``."""
    wgmma = (dtype == torch.bfloat16 and P == WGMMA_HEAD_DIM and N in WGMMA_STATES
             and chunk == WGMMA_CHUNK)
    return "wgmma" if wgmma else "simt"


def _segsum(x):
    """x: (..., Q).  (..., Q, Q) with out[i, j] = sum_{j < m <= i} x_m for
    i >= j, -inf otherwise (log of the causal decay matrix)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_reference(x, dt, A, B, C, chunk: int, initial_state=None, return_final_state=False):
    """Chunked SSD (the Mamba-2 paper's matmul form), model layout.

    x : (b, S, H, P)   inputs per head
    dt: (b, S, H)      positive step sizes (softplus already applied)
    A : (H,)           negative decay rates
    B : (b, S, G, N)   input projections  (G groups, broadcast over H)
    C : (b, S, G, N)   output projections
    -> y: (b, S, H, P) in x's dtype [, final_state (b, H, N, P) f32]
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:
        # Right-pad with dt=0 tokens: decay exp(0)=1 and zero dt-weighted
        # contribution, so both outputs at real positions and the final state
        # are exactly preserved (outputs at pad positions are sliced off).
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        out = ssd_reference(x, dt, A, B, C, chunk, initial_state, return_final_state)
        if return_final_state:
            return out[0][:, :S], out[1]
        return out[:, :S]
    nc, Q = S // chunk, chunk
    rep = H // G

    in_dtype = x.dtype
    # the recurrence is done in f32 (exp/cumsum are precision-critical)
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()

    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bh = B.reshape(b, nc, Q, G, N).repeat_interleave(rep, dim=3)  # (b, nc, Q, H, N)
    Ch = C.reshape(b, nc, Q, G, N).repeat_interleave(rep, dim=3)
    dA = dtc * A.float()                                           # (b, nc, Q, H), negative

    # ---- intra-chunk (quadratic within the chunk) ---------------------------
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))                 # (b, nc, H, Q, Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)            # (b, nc, H, Q, Q)
    w = scores * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w, xc)

    # ---- chunk states -------------------------------------------------------
    dA_cum = torch.cumsum(dA, dim=2)                               # (b, nc, Q, H)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)        # (b, nc, Q, H)
    states = torch.einsum("bcqhn,bcqhp->bchnp", Bh * (decay_to_end * dtc)[..., None], xc)

    # ---- inter-chunk recurrence (scan over chunks) --------------------------
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                   # (b, nc, H)
    s = (torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                         # (b, nc, H, N, P)

    # ---- inter-chunk output -------------------------------------------------
    in_decay = torch.exp(dA_cum)                                   # decay from chunk start
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch * in_decay[..., None], prev_states)
    y = (y_intra + y_inter).reshape(b, S, H, P).to(in_dtype)
    if return_final_state:
        return y, s
    return y


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int, return_final_state=False, initial_state=None):
    """Plain PyTorch SSD on the tensors' device, kernel layout: x
    (B, H, S, P), dt (B, H, S), A (H,), Bm/Cm (B, G, S, N) -> y (B, H, S, P)
    in x's dtype [, final state (B, H, N, P) f32], from ``initial_state``
    (B, H, N, P; taken in f32) or a zero state.  With G = H and no initial
    state this is the reference's ``ref.ssd_ref``."""
    out = ssd_reference(
        x.transpose(1, 2), dt.transpose(1, 2), A, Bm.transpose(1, 2), Cm.transpose(1, 2),
        chunk, initial_state=initial_state, return_final_state=return_final_state,
    )
    if return_final_state:
        return out[0].transpose(1, 2), out[1]
    return out.transpose(1, 2)


def check_ssd_inputs(x, dt, A, Bm, Cm, chunk: int, *, out=None, state_out=None,
                     initial_state=None) -> None:
    """Raise unless the kernel takes these tensors: one device, x/dt/Bm/Cm
    (and out) f32 or bf16 of one dtype, A f32, the shapes of the kernel
    layout with H % G == 0, chunk and N multiples of 4 up to 128, P up to
    64, a unit stride on the last axis of x, Bm, Cm and out, and the state
    output and the initial state (B, H, N, P) f32 contiguous."""
    dev = x.device
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError("ssd_scan: x and Bm must be 4-D (B, H, S, P) and (B, G, S, N)")
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: dtype {x.dtype} is not float32 or bfloat16")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: {H} heads do not split into {G} groups")
    if chunk % 4 or not 4 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} must be a multiple of 4 in [4, {MAX_CHUNK}]")
    if N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size {N} must be a multiple of 4 in [4, {MAX_STATE}]")
    if not 1 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: head dim {P} must be in [1, {MAX_HEAD_DIM}]")
    for name, t, shape in (
        ("x", x, (Bsz, H, S, P)), ("Bm", Bm, (Bsz, G, S, N)), ("Cm", Cm, (Bsz, G, S, N)),
    ) + ((("out", out, (Bsz, H, S, P)),) if out is not None else ()):
        check_tensor("ssd_scan", name, t, x.dtype, shape, dev)
    if dt.device != dev or dt.dtype != x.dtype or tuple(dt.shape) != (Bsz, H, S):
        raise ValueError(f"ssd_scan: dt must be a ({Bsz}, {H}, {S}) {x.dtype} tensor on {dev}")
    if A.device != dev or A.dtype != torch.float32 or tuple(A.shape) != (H,) or (
            H > 1 and A.stride(0) != 1):
        raise ValueError(f"ssd_scan: A must be a contiguous ({H},) float32 tensor on {dev}")
    for name, t in (("state_out", state_out), ("initial_state", initial_state)):
        if t is not None and (
                t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (Bsz, H, N, P) or not t.is_contiguous()):
            raise ValueError(
                f"ssd_scan: {name} must be a contiguous ({Bsz}, {H}, {N}, {P}) float32 "
                f"tensor on {dev}")


def _library() -> ctypes.CDLL:
    lib = load_library("ssd_scan")
    if not getattr(lib, "_argtypes_set", False):
        lib.ssd_scan_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_void_p]
        )
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _wgmma_library() -> ctypes.CDLL:
    lib = load_library("ssd_scan_wgmma")
    if not getattr(lib, "_argtypes_set", False):
        lib.ssd_scan_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_void_p]
        )
        lib.ssd_scan_wgmma_launch.restype = ctypes.c_int
        lib.ssd_scan_wgmma_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_wgmma_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _pair_strides(name: str, t: torch.Tensor):
    """``t``'s element strides but the last, or raise unless the kernel can
    write it two bf16 values (4 bytes) at a time."""
    if t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:-1]):
        raise ValueError(
            f"ssd_scan: {name} needs a 4-byte aligned base and even strides (got "
            f"{tuple(t.stride())})")
    return list(t.stride()[:-1])


def ssd_scan(
    x, dt, A, Bm, Cm, *, chunk: int = 128, return_final_state: bool = False,
    initial_state: Optional[torch.Tensor] = None, backend: Optional[str] = None,
    out: Optional[torch.Tensor] = None,
):
    """SSD in kernel layout: x (B, H, S, P), dt (B, H, S), A (H,) f32, Bm/Cm
    (B, G, S, N) -> y (B, H, S, P) in x's dtype, written into ``out`` when
    given (any strides, unit last stride); with ``return_final_state``,
    ``(y, final_state)`` with the state (B, H, N, P) in f32; the
    recurrence starts from ``initial_state`` (B, H, N, P; f32 contiguous on
    the kernel route, which refuses anything else), or from a zero state.

    ``backend`` as for the attention kernels: ``"torch"`` is the plain
    version on the tensors' device, ``"cuda"`` the kernel; ``None`` defers
    to ``REPRO_TORCH_MODEL_BACKEND`` (the model kernels' switch), else
    follows the device.  CPU tensors always take the plain version (a
    ``plain`` call, no launch); CUDA tensors on ``"cuda"`` launch the kernel of
    :func:`ssd_route` or raise, and refuse inputs that require a gradient
    while grad mode is on (``common.check_no_grad``).
    """
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not {dev.type}")
    if dev.type == "cpu" or resolve_model_backend(backend, dev) == "torch":
        counters.add(_LAUNCHED["plain"])
        res = ssd_scan_ref(x, dt, A, Bm, Cm, chunk, return_final_state, initial_state)
        if out is None:
            return res
        if return_final_state:
            return out.copy_(res[0]), res[1]
        return out.copy_(res)
    check_no_grad("ssd_scan", x, dt, A, Bm, Cm,
                  *(() if initial_state is None else (initial_state,)))
    Bsz, H, S, P = x.shape
    N = Bm.shape[3]
    if out is None:
        out = torch.empty((Bsz, H, S, P), dtype=x.dtype, device=dev)
    state = (torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
             if return_final_state else None)
    check_ssd_inputs(x, dt, A, Bm, Cm, chunk, out=out, state_out=state,
                     initial_state=initial_state)
    if Bsz == 0 or H == 0 or S == 0:
        if state is not None:
            return out, (state.zero_() if initial_state is None else state.copy_(initial_state))
        return out
    h0 = initial_state.data_ptr() if initial_state is not None else None
    route = ssd_route(x.dtype, P, N, chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            lib = _wgmma_library()
            strides = (ctypes.c_longlong * 15)(
                *tma_strides("ssd_scan", "x", x), *dt.stride(),
                *tma_strides("ssd_scan", "Bm", Bm), *tma_strides("ssd_scan", "Cm", Cm),
                *_pair_strides("out", out),
            )
            err = lib.ssd_scan_wgmma_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                out.data_ptr(), state.data_ptr() if state is not None else None, h0,
                Bsz, H, Bm.shape[1], S, N, strides, stream,
            )
            errstr = lib.ssd_scan_wgmma_error_string
        else:
            lib = _library()
            strides = (ctypes.c_longlong * 15)(
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
                *out.stride()[:3]
            )
            err = lib.ssd_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                out.data_ptr(), state.data_ptr() if state is not None else None, h0,
                DTYPES[x.dtype], Bsz, H, Bm.shape[1], S, P, N, chunk, strides, stream,
            )
            errstr = lib.ssd_scan_error_string
    if err != 0:
        msg = errstr(err).decode()
        raise RuntimeError(f"ssd_scan ({route}) kernel launch failed: CUDA error {err} ({msg})")
    counters.add(_LAUNCHED[route])
    return (out, state) if return_final_state else out
