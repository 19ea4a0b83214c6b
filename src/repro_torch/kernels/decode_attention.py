"""One-token grouped-query decode attention over a KV cache: the Hopper
kernel (split-K flash-decoding) and its plain PyTorch version.

:func:`decode_attention` is the port of the TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.  On CUDA tensors
it launches the hand-written kernel in ``csrc/decode_attention.cu`` (built
with ``nvcc`` at first use, bound with ``ctypes``) or raises; on CPU
tensors it runs :func:`decode_attention_ref`.  There is no fallback from
the kernel to the plain version.  Each launch counts one
``kernel.launches.decode_attention.cuda``, and each call that runs the
plain version one ``...plain`` (``obs.counters``).

The kernel cuts the cache axis T into the spans of :func:`decode_splits`,
one block per (span, KV group, sequence), and combines the spans' f32
partials in span order inside the same launch (the last block of a group
to finish does it), so its result does not depend on the blocks' order.
The partials live in scratch the wrapper allocates per call; the blocks
find the last one through a per-group counter that the wrapper keeps per
device (zeros, which every launch leaves at zero), so launches of one
device run on one stream at a time.

Kernel layout: q ``(B, KV, rep, hd)`` (the rep query heads of each KV
group), k/v ``(B, KV, T, hd)``, valid ``(B, T)`` bool, out
``(B, KV, rep, hd)`` in q's dtype.  Every tensor is read through its
strides (unit stride on the last axis of q, k, v and out; valid may be
broadcast over B), so ``ops.decode_attention`` passes the layer's slice of
the ring-buffer cache as a transposed view and copies nothing.

The plain version is the whole-matrix form of the Pallas arithmetic (see
``flash_attention.masked_softmax_pv``); a head with no valid position gets
zeros, as the kernel gives, where the reference's ``ref.py`` oracle gives a
uniform average.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..obs import counters
from .build import load_library
from .common import DTYPES, check_no_grad, check_tensor, resolve_model_backend, vector_loads
from .flash_attention import check_head_dim, default_scale, masked_softmax_pv

__all__ = ["MAX_REP", "decode_attention", "decode_attention_ref", "decode_splits"]

_LAUNCHED = counters.launch_names("decode_attention")  # route -> launch counter

#: query heads per KV group the kernel takes, and rep * hd at most this
MAX_REP = 32
MAX_REP_HD = 4096
#: cache positions of the kernel's tile; a span is a whole number of tiles
TILE = 64
#: blocks the grid should reach, in waves of the card's SMs
WAVES = 2

_COUNTERS = {}  # device -> int32 zeros, one counter per (sequence, KV group)


@functools.lru_cache(maxsize=None)
def decode_splits(B: int, KV: int, T: int, sms: int = 132):
    """``(n_split, span)``: how the kernel cuts T positions.  The target is
    ``WAVES`` waves of ``sms`` SMs, ``B * KV * n_split`` blocks, or one span
    per ``TILE`` positions where T has fewer tiles; the spans are the fewest
    of one whole-tile length that reach it (the last span may be shorter),
    ``(n_split - 1) * span < T <= n_split * span``."""
    if T <= 0:
        return 1, TILE
    target = max(1, min(-(-WAVES * sms // max(B * KV, 1)), -(-T // TILE)))
    n = target
    while True:
        span = -(-(-(-T // n)) // TILE) * TILE
        if -(-T // span) >= target:
            return -(-T // span), span
        n += 1


def _counters(dev, n: int) -> torch.Tensor:
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = _COUNTERS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return c


def decode_attention_ref(q, k, v, valid, *, scale: Optional[float] = None):
    """Plain PyTorch decode attention on the tensors' device, kernel layout:
    q (B, KV, rep, hd), k/v (B, KV, T, hd), valid (B, T) bool ->
    (B, KV, rep, hd) in q's dtype, the scores times ``scale`` (default
    1/sqrt(hd))."""
    hd = q.shape[-1]
    s = torch.einsum("bgrd,bgtd->bgrt", q.float(), k.float()) * default_scale(hd, scale)
    return masked_softmax_pv(s, valid[:, None, None, :], v.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = load_library("decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.decode_attention_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def decode_attention(
    q, k, v, valid, *, backend: Optional[str] = None, out: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """Decode attention in kernel layout: q (B, KV, rep, hd), k/v
    (B, KV, T, hd), valid (B, T) bool -> (B, KV, rep, hd) in q's dtype,
    written into ``out`` when given; the scores times ``scale`` (default
    1/sqrt(hd)).

    ``backend`` as for ``flash_attention``: CPU tensors always take the
    plain version (a ``plain`` call, no launch); CUDA tensors on ``"cuda"`` launch the
    kernel or raise, and refuse inputs that require a gradient while grad
    mode is on (``common.check_no_grad``).
    """
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, not {dev.type}")
    if dev.type == "cpu" or resolve_model_backend(backend, dev) == "torch":
        counters.add(_LAUNCHED["plain"])
        res = decode_attention_ref(q, k, v, valid, scale=scale)
        return res if out is None else out.copy_(res)
    check_no_grad("decode_attention", q, k, v)
    B, KV, rep, hd = q.shape
    T = k.shape[2]
    check_head_dim("decode_attention", hd, q.dtype)
    if rep > MAX_REP or rep * hd > MAX_REP_HD:
        raise ValueError(
            f"decode_attention: {rep} heads per group of head_dim {hd} exceed the kernel's "
            f"{MAX_REP} heads and {MAX_REP_HD} accumulators"
        )
    if out is None:
        out = torch.empty((B, KV, rep, hd), dtype=q.dtype, device=dev)
    for name, t, shape in (
        ("q", q, (B, KV, rep, hd)), ("k", k, (B, KV, T, hd)), ("v", v, (B, KV, T, hd)),
        ("out", out, (B, KV, rep, hd)),
    ):
        check_tensor("decode_attention", name, t, q.dtype, shape, dev)
    if valid.device != dev or valid.dtype != torch.bool or tuple(valid.shape) != (B, T):
        raise ValueError(f"decode_attention: valid must be a ({B}, {T}) bool tensor on {dev}")
    if B == 0 or KV == 0 or rep == 0:
        return out
    lib = _library()
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *valid.stride(), *out.stride()[:3]
    )
    with torch.cuda.device(dev):
        n_split, span = decode_splits(B, KV, T, _sm_count(dev))
        part = arrivals = None
        if n_split > 1:
            part = torch.empty(B * KV * n_split * rep * (hd + 2), dtype=torch.float32,
                               device=dev)
            arrivals = _counters(dev, B * KV)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.view(torch.uint8).data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if arrivals is None else arrivals.data_ptr(), DTYPES[q.dtype], B, KV, rep,
            T, hd, span, n_split, strides, default_scale(hd, scale),
            int(vector_loads((q, k, v), hd)), stream,
        )
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err} ({msg})")
    counters.add(_LAUNCHED["cuda"])
    return out
