"""What the model kernels (attention, SSD and the causal conv) share: the
dtype codes of their C interfaces, the per-tensor input check, the
16-byte load test, the strides a TMA tensor map takes, and the backend
switch.

The model kernels' backend is chosen as GUS's is: an explicit ``backend=``
(``"torch"`` for the plain version, ``"cuda"`` for the kernel), else the
scope of :func:`model_backend`, else the environment variable
``REPRO_TORCH_MODEL_BACKEND`` (``core.options.ENV_MODEL_BACKEND``), else
the tensors' device.

The kernels have no backward, as the reference's Pallas kernels have none:
on the ``"cuda"`` route a wrapper refuses inputs that require a gradient
while grad mode is on (:func:`check_no_grad`).  The train step asks for
the plain route by :func:`model_backend`, as the reference trains with
``use_pallas=False``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = [
    "DTYPES", "check_no_grad", "check_tensor", "model_backend", "resolve_model_backend",
    "tma_strides", "vector_loads",
]

#: dtype codes of the C interfaces
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: the backend of the innermost open :func:`model_backend` block, if any
_scoped: Optional[str] = None


@contextlib.contextmanager
def model_backend(backend: str):
    """Within the block, the model kernels that get no ``backend=`` take
    ``backend`` (``"torch"`` or ``"cuda"``), before the environment
    variable and the device.  The choice is process-wide, as the
    environment variable is, so that it also holds where autograd
    recomputes a checkpointed block on its own threads.  So the block must
    not overlap model calls on another thread that expect the kernels (a
    server's): while it is open, they take ``backend`` too."""
    from repro_torch.core.options import BACKENDS

    global _scoped
    if backend not in BACKENDS:
        raise ValueError(f"unknown model-kernel backend {backend!r}; expected one of "
                         f"{', '.join(BACKENDS)}")
    outer, _scoped = _scoped, backend
    try:
        yield
    finally:
        _scoped = outer


def resolve_model_backend(backend: Optional[str], device: torch.device) -> str:
    """Explicit ``backend=`` > :func:`model_backend`'s scope >
    ``REPRO_TORCH_MODEL_BACKEND`` > the device's own."""
    from repro_torch.core.options import ENV_MODEL_BACKEND, resolve_backend

    return resolve_backend(backend if backend is not None else _scoped, device,
                           var=ENV_MODEL_BACKEND)


def check_no_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise before a kernel launch that autograd would not see: grad mode
    on and an input that requires a gradient.  The output would carry no
    ``grad_fn``, and the gradient of every input would be lost without a
    word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward (nor had the reference's Pallas "
            "kernel), and an input requires a gradient; run it under torch.no_grad(), or "
            "take the plain route for training (backend='torch' or "
            "kernels.common.model_backend('torch'), as the train step does)"
        )


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is what the kernel takes: device, dtype, shape and
    a unit stride on the last axis (any other strides are fine)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{kernel}: {name} needs a unit stride on its last axis")


def vector_loads(tensors, n: int) -> bool:
    """True when every row the kernel stages starts on a 16-byte boundary
    and its ``n`` elements fill whole 16-byte vectors, so it may load 16
    bytes at a time."""
    per16 = 16 // tensors[0].element_size()
    return n % per16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % per16 == 0 for s in t.stride()[:-1])
        for t in tensors
    )


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
