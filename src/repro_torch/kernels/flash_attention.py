"""Prefill attention (causal / sliding window, grouped-query): the Hopper
kernels and their plain PyTorch version.

:func:`flash_attention` is the port of the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  On CUDA tensors it
launches one of two hand-written kernels (built with ``nvcc`` at first use,
bound with ``ctypes``) or raises; on CPU tensors it runs
:func:`flash_attention_ref`.  There is no fallback from a kernel to the
plain version or to the other kernel.  The route is chosen before the
launch by :func:`flash_route`, from the dtype and the head dim alone:

* ``"wgmma"``: ``csrc/flash_attention_wgmma.cu``, bf16 at head_dim 64 or
  128, both products on the tensor cores (wgmma), tiles fed by TMA;
* ``"simt"``: ``csrc/flash_attention.cu``, f32 and every other head dim
  (a multiple of 4 up to 256), f32 products on the CUDA cores.

``flash_attention.launches`` counts every launch and
``flash_attention.route_launches`` the launches of each route.

Kernel layout: q ``(B, H, S, hd)``, k/v ``(B, KV, T, hd)``, out
``(B, H, S, hd)`` in q's dtype.  Both kernels read every tensor through its
strides (unit stride on the last axis), so ``ops.flash_attention`` hands
them transposed views of the model's ``(B, S, H, hd)`` tensors and an
output view, and nothing is copied.  The ``"wgmma"`` route describes each
tensor to TMA, which needs a 16-byte aligned base and strides that are
multiples of 16 bytes: the wrapper checks that and raises otherwise.

The plain version is the whole-matrix form of the Pallas arithmetic, which
is what the kernels compute: f32 scores times ``1/sqrt(hd)``, ``-1e30``
where masked, softmax with ``p`` zeroed where masked, ``P.V`` in f32, and a
zero row where the denominator is 0.  It differs from the reference's
``repro/kernels/ref.py`` oracle in two places: that oracle casts the
weights to q's dtype before ``P.V`` (as the ``"wgmma"`` kernel does), and
gives a fully masked row a uniform average instead of zeros.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import load_library
from .common import DTYPES, check_tensor, resolve_model_backend

__all__ = [
    "NEG_INF",
    "MAX_HEAD_DIM",
    "attention_mask",
    "masked_softmax_pv",
    "WGMMA_HEAD_DIMS",
    "flash_attention",
    "flash_attention_ref",
    "flash_route",
]

NEG_INF = -1e30
#: largest head dimension the kernels take (and hd % 4 == 0)
MAX_HEAD_DIM = 256
#: head dimensions of the tensor-core kernel (bf16 only)
WGMMA_HEAD_DIMS = (64, 128)


def flash_route(dtype, hd: int) -> str:
    """The kernel a CUDA launch takes: ``"wgmma"`` for bf16 at a head dim
    of :data:`WGMMA_HEAD_DIMS`, else ``"simt"``."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "simt"


def attention_mask(S: int, T: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(S, T) bool: query row i sees key column j iff ``j <= i`` (causal)
    and ``j > i - window`` (window), as the Pallas kernel masks."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask


def masked_softmax_pv(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(s) @ v`` in f32 with the Pallas kernels' masking: ``-1e30``
    where masked, ``p`` forced to 0 there, a zero row where the denominator
    is 0.  ``s`` (..., S, T) f32 scores, ``mask`` broadcast to it, ``v``
    (..., T, hd) f32."""
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    denom = p.sum(-1, keepdim=True)
    return (p @ v) / torch.where(denom > 0, denom, 1.0)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Plain PyTorch prefill attention on the tensors' device, kernel layout:
    q (B, H, S, hd), k/v (B, KV, T, hd) -> (B, H, S, hd) in q's dtype.
    Query head h reads KV head ``h // (H // KV)``."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    qg = q.float().unflatten(1, (KV, H // KV))                   # (B, KV, rep, S, hd)
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * (1.0 / math.sqrt(hd))
    mask = attention_mask(S, T, causal, window, q.device)
    out = masked_softmax_pv(s, mask, v.float()[:, :, None])       # (B, KV, rep, S, hd)
    return out.flatten(1, 2).to(q.dtype)


def check_head_dim(kernel: str, hd: int, dtype) -> None:
    if dtype not in DTYPES:
        raise TypeError(f"{kernel}: dtype {dtype} is not float32 or bfloat16")
    if hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {hd} must be a multiple of 4 and <= {MAX_HEAD_DIM}")


def vector_loads(tensors, hd: int) -> bool:
    """True when every row the kernel stages starts on a 16-byte boundary,
    so it may load 16 bytes at a time."""
    per16 = 16 // tensors[0].element_size()
    return hd % per16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % per16 == 0 for s in t.stride()[:-1])
        for t in tensors
    )


def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _wgmma_library() -> ctypes.CDLL:
    lib = load_library("flash_attention_wgmma")
    if not getattr(lib, "_argtypes_set", False):
        lib.flash_attention_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_wgmma_launch.restype = ctypes.c_int
        lib.flash_attention_wgmma_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_wgmma_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def tma_strides(kernel: str, name: str, t: torch.Tensor):
    """``t``'s element strides but the last, as a TMA tensor map takes them,
    or raise: the base must be 16-byte aligned and every stride a multiple
    of 16 bytes.  The stride of an axis of size 1 is never followed, so it
    is replaced by one past the tensor's extent, which TMA takes."""
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary for TMA")
    past = -(-max(st * n for st, n in zip(t.stride(), t.shape)) // per16) * per16
    out = []
    for st, n in zip(t.stride()[:-1], t.shape[:-1]):
        if n == 1:
            st = past
        elif st % per16:
            raise ValueError(
                f"{kernel}: {name}'s strides {tuple(t.stride())} must be multiples of 16 bytes "
                "for TMA")
        out.append(st)
    return out


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    backend: Optional[str] = None, out: Optional[torch.Tensor] = None,
):
    """Prefill attention in kernel layout: q (B, H, S, hd), k/v
    (B, KV, T, hd) -> (B, H, S, hd) in q's dtype, written into ``out`` when
    given (any strides, unit last stride).

    ``backend``: ``"torch"`` is the plain version on the tensors' device,
    ``"cuda"`` the kernel; ``None`` defers to ``REPRO_TORCH_MODEL_BACKEND``,
    else follows the device.  CPU tensors always take the plain version and
    count no launch; CUDA tensors on ``"cuda"`` launch the kernel or raise.
    """
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {dev.type}")
    if dev.type == "cpu" or resolve_model_backend(backend, dev) == "torch":
        res = flash_attention_ref(q, k, v, causal=causal, window=window)
        return res if out is None else out.copy_(res)
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    check_head_dim("flash_attention", hd, q.dtype)
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not split into {KV} KV groups")
    if out is None:
        out = torch.empty((B, H, S, hd), dtype=q.dtype, device=dev)
    for name, t, shape in (
        ("q", q, (B, H, S, hd)), ("k", k, (B, KV, T, hd)), ("v", v, (B, KV, T, hd)),
        ("out", out, (B, H, S, hd)),
    ):
        check_tensor("flash_attention", name, t, q.dtype, shape, dev)
    if B == 0 or H == 0 or S == 0:
        return out
    route = flash_route(q.dtype, hd)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            if T == 0:  # no key at all: every row is a zero row
                return out.zero_()
            lib = _wgmma_library()
            strides = (ctypes.c_longlong * 12)(*(
                st for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
                for st in tma_strides("flash_attention", name, t)))
            err = lib.flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, S, T, hd,
                strides, int(causal), int(window is not None), int(window or 0),
                1.0 / math.sqrt(hd), stream,
            )
            errstr = lib.flash_attention_wgmma_error_string
        else:
            lib = _library()
            strides = (ctypes.c_longlong * 12)(
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
            )
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
                B, H, KV, S, T, hd, strides, int(causal), int(window is not None),
                int(window or 0), 1.0 / math.sqrt(hd), int(vector_loads((q, k, v), hd)), stream,
            )
            errstr = lib.flash_attention_error_string
    if err != 0:
        msg = errstr(err).decode()
        raise RuntimeError(
            f"flash_attention ({route}) kernel launch failed: CUDA error {err} ({msg})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


#: kernel launches since the count was last set to 0, in all and by route
flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "simt": 0}
