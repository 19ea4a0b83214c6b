"""Mamba-2's depthwise causal conv with its bias and SiLU: the Hopper kernel
and its plain PyTorch version.

The JAX package computes this conv with ``jnp`` (``repro/models/ssm.py::
_causal_conv``) and has no Pallas kernel for it, so the kernel replaces
none: it exists because the eager expression (:func:`causal_conv_ref` and
``F.silu``) makes about 12 passes over xBC in every Mamba-2 layer, and the
kernel one (``csrc/causal_conv.cu``, built with ``nvcc`` at first use and
bound with ``ctypes``).

:func:`causal_conv` launches the kernel for CUDA tensors when the
model backend resolves to ``"cuda"`` (``common.resolve_model_backend``,
the test the attention and SSD wrappers make), and refuses there inputs
that require a gradient while grad mode is on (``common.check_no_grad``).
CPU tensors and the ``"torch"`` backend (the train step's) run the plain
version.  DTensors (the sharded steps) reach it through ``ops.causal_conv``,
which calls it on each rank's shards.  The plain version is the model's own
expression, as the reference's conv had no kernel, so it counts nothing;
each launch counts one ``kernel.launches.causal_conv.cuda``
(``obs.counters``).

The kernel reads xBC through its strides (the ``in_proj`` output's slice,
copied nowhere) and writes a contiguous ``(B, S, Ch)`` result in xBC's
dtype, the layout the model's split into x, B and C sees from the plain
version too; with the new conv state (the last W-1 rows of
``[conv_state; xBC]``) where asked.  It rounds where the plain version
rounds (``csrc/causal_conv.cu``): its output equals the plain one bit for
bit before the SiLU and within one step of the dtype after it.  The
published configurations' width, W 4, keeps its window in registers; any
other W takes a kernel that reads each output's W rows anew.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..obs import counters
from .build import load_library
from .common import DTYPES, check_no_grad, check_tensor, resolve_model_backend, vector_loads

__all__ = ["causal_conv", "causal_conv_ref"]

_LAUNCHED = counters.launch_names("causal_conv")["cuda"]

#: the grid's z axis holds the batch
MAX_BATCH = 65535


def causal_conv_ref(xBC, w, b, conv_state=None):
    """Depthwise causal conv1d.  xBC: (B, S, Ch); w: (W, Ch).
    If conv_state (B, W-1, Ch) is given, it is prepended (decode/streaming).
    The taps are summed in the reference's order, starting from Python's 0,
    since that order decides the bf16 rounding."""
    W = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], W - 1, xBC.shape[2]), dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, xBC], dim=1)                        # (B, S+W-1, Ch)
    out = sum(xp[:, i : i + xBC.shape[1], :] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1) :, :] if W > 1 else None
    return out + b, new_state


def _library() -> ctypes.CDLL:
    lib = load_library("causal_conv")
    if not getattr(lib, "_argtypes_set", False):
        lib.causal_conv_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.causal_conv_launch.restype = ctypes.c_int
        lib.causal_conv_error_string.argtypes = [ctypes.c_int]
        lib.causal_conv_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def causal_conv(xBC, w, b, conv_state=None, *, return_state: bool = True, silu: bool = True,
                backend: Optional[str] = None):
    """``(silu(conv(xBC) + b), new conv state)``: xBC (B, S, Ch), w (W, Ch),
    b (Ch,), conv_state (B, W-1, Ch) or ``None`` (zeros) -> (B, S, Ch) and
    (B, W-1, Ch) (``None`` where W is 1 or ``return_state`` is off).
    ``silu=False`` leaves the activation out (the conv and the bias alone,
    as :func:`causal_conv_ref`); only the checks of the kernel against the
    plain version before the SiLU use it.  The route is the module
    docstring's: the kernel or a raise for CUDA tensors on the ``"cuda"``
    backend, the plain version for CPU tensors and the ``"torch"``
    backend."""
    tensors = [xBC, w, b] + ([] if conv_state is None else [conv_state])
    if not (xBC.device.type == "cuda" and resolve_model_backend(backend, xBC.device) == "cuda"):
        out, new_state = causal_conv_ref(xBC, w, b, conv_state)
        return (F.silu(out) if silu else out), (new_state if return_state else None)
    check_no_grad("causal_conv", *tensors)
    dev, dtype = xBC.device, xBC.dtype
    if dtype not in DTYPES:
        raise TypeError(f"causal_conv: the kernel takes float32 or bfloat16, not {dtype}")
    if xBC.dim() != 3 or w.dim() != 2:
        raise ValueError(f"causal_conv: xBC must be (B, S, Ch) and w (W, Ch), got "
                         f"{tuple(xBC.shape)} and {tuple(w.shape)}")
    B, S, Ch = xBC.shape
    W = w.shape[0]
    if W < 1 or B > MAX_BATCH:
        raise ValueError(f"causal_conv: the kernel takes W >= 1 and B <= {MAX_BATCH}, "
                         f"got W {W}, B {B}")
    check_tensor("causal_conv", "xBC", xBC, dtype, (B, S, Ch), dev)
    check_tensor("causal_conv", "w", w, dtype, (W, Ch), dev)
    check_tensor("causal_conv", "b", b, dtype, (Ch,), dev)
    if conv_state is not None:
        check_tensor("causal_conv", "conv_state", conv_state, dtype, (B, W - 1, Ch), dev)
    w, b = w.contiguous(), b.contiguous()
    out = torch.empty((B, S, Ch), dtype=dtype, device=dev)
    state = (torch.empty((B, W - 1, Ch), dtype=dtype, device=dev)
             if return_state and W > 1 else None)
    if B == 0 or Ch == 0 or S == 0:  # nothing to launch: the state is the prefix
        if state is not None:
            state.zero_() if conv_state is None else state.copy_(conv_state)
        return out, state
    reads = (xBC, w, b) + (() if conv_state is None else (conv_state,))
    prefix_strides = conv_state.stride()[:2] if conv_state is not None else (0, 0)
    strides = (ctypes.c_longlong * 4)(*xBC.stride()[:2], *prefix_strides)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.causal_conv_launch(
            xBC.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if conv_state is None else conv_state.data_ptr(), out.data_ptr(),
            None if state is None else state.data_ptr(), DTYPES[dtype], B, S, Ch, W, strides,
            int(vector_loads(reads, Ch)), int(silu), stream,
        )
    if err != 0:
        msg = lib.causal_conv_error_string(err).decode()
        raise RuntimeError(f"causal_conv kernel launch failed: CUDA error {err} ({msg})")
    counters.add(_LAUNCHED)
    return out, state
