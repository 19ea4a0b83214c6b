"""Model-layout adapters for the model kernels (attention, SSD, causal conv).

The port's counterpart of ``repro/kernels/ops.py``: the model keeps q
``(B, S, H, hd)`` and k/v ``(B, T, KV, hd)``; the attention kernels take
``(B, H, S, hd)`` and ``(B, KV, T, hd)``.  The SSD adapter likewise turns
x ``(B, S, H, P)``, dt ``(B, S, H)`` and B/C ``(B, S, G, N)`` into the
kernel's head-major layout.  Every kernel reads through strides, so the
adapters pass transposed views (and an output view) instead of copies;
decode's k/v are the layer's slice of the ring-buffer cache, read in place.

Unlike the reference's ``ops.ssd``, the SSD adapter neither repeats B and
C over heads (the kernel reads group ``h // (H // G)`` by index) nor falls
back to the plain version when ``S % chunk != 0`` (the kernel takes a
ragged last chunk itself, by the reference's dt = 0 padding rule).
The causal conv's adapter only splits DTensors: the kernel takes the
model's layout as it is.

**DTensor inputs** (the sharded steps of ``launch/steps.py``): each rank
runs the kernel (or, on the CPU and the plain route, the plain version) on
its own shards, and the result is wrapped back as a DTensor with q's (x's)
placements.  Batch and heads are local work: a mesh dimension that shards
q's batch must shard k/v's batch, one that shards the heads gives each rank
``H / n`` query heads, and where the KV heads are replicated (yi-9b's 4 KV
heads on a model axis of 8) each rank takes the KV heads its query heads
read (head ``h`` reads ``h // rep``), so the local ``rep`` stays the
global one.  The causal conv works per channel, so its batch and channel
shards are local work, each rank taking the matching channels of the
taps, the bias and the conv state.  Any other layout of q (a partial sum,
a sharded sequence) is first redistributed to a local one.  A KV cache
sharded on its sequence (the ``kv_seq`` rules) raises on the kernel route,
never falls back; the plain route gathers the sequence first.  The
no-backward guard and the TMA stride checks of the wrappers apply to the
local shards unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .causal_conv import causal_conv as _conv_kernel
from .common import resolve_model_backend
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .ssd_scan import ssd_scan as _ssd_kernel

__all__ = ["flash_attention", "decode_attention", "ssd", "causal_conv", "on_local_heads"]


def _keep_only(t: DTensor, local_dims) -> DTensor:
    """``t`` with every mesh dimension that does not shard one of
    ``local_dims`` replicated (a partial sum reduced, another dimension
    gathered)."""
    pl = tuple(p if isinstance(p, Shard) and p.dim in local_dims else Replicate()
               for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


def _offset(t: DTensor, dim: int):
    """``(start, size)`` of this rank's shard of ``t``'s dimension ``dim``
    (split in mesh-dimension order, the outer first, evenly)."""
    mesh = t.device_mesh
    n, start = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(i)
            start += mesh.get_local_rank(i) * n
    return start, n


def _match(kv: DTensor, q: DTensor, q_batch: int, q_heads: int, kv_batch: int, kv_seq: int,
           kv_heads: int, kernel: bool, name: str) -> DTensor:
    """k or v laid out for local work beside q: sharded on the batch where
    q is, on its heads where q's heads are (or replicated there), and
    nowhere else.  A sharded sequence raises on the kernel route."""
    if kernel and any(isinstance(p, Shard) and p.dim == kv_seq for p in kv.placements):
        raise ValueError(
            f"{name}: the KV cache is sharded on its sequence axis (kv_seq), which the "
            "kernel does not take; run the plain route (backend='torch') for this layout"
        )
    pl = []
    for qp, p in zip(q.placements, kv.placements):
        if isinstance(qp, Shard) and qp.dim == q_batch:
            pl.append(Shard(kv_batch))
        elif isinstance(qp, Shard) and qp.dim == q_heads and isinstance(p, Shard) \
                and p.dim == kv_heads:
            pl.append(p)
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    return kv if pl == tuple(kv.placements) else kv.redistribute(kv.device_mesh, pl)


def _local(t: DTensor, q: DTensor) -> torch.Tensor:
    """This rank's shard of an input of q's local work.  Where q is split
    over a mesh dimension and ``t`` is replicated on it, each rank's work
    reads only part of ``t``, so its gradient there is a partial sum."""
    grad = [Partial() if isinstance(qp, Shard) and isinstance(p, Replicate) else p
            for qp, p in zip(q.placements, t.placements)]
    return t.to_local(grad_placements=grad)


def _kv_head_span(H: int, KV: int, h0: int, hl: int, name: str):
    """``(start, count)`` of the KV heads that query heads ``[h0, h0 + hl)``
    of ``H`` read, with ``KV`` KV heads (head ``h`` reads ``h // (H //
    KV)``).  Raises where the local heads would not keep the grouping."""
    rep = H // KV
    lo, hi = h0 // rep, (h0 + hl - 1) // rep + 1
    if hl % (hi - lo) or not (h0 % rep == 0 and hl % rep == 0 or rep % hl == 0):
        raise ValueError(
            f"{name}: query heads [{h0}, {h0 + hl}) do not cover whole KV groups of "
            f"{rep} or lie in one, so the local heads cannot keep the grouping"
        )
    return lo, hi - lo


def _local_kv(q: DTensor, kv: DTensor, q_heads: int, kv_heads: int, name: str) -> torch.Tensor:
    """This rank's k or v: its own shard, cut to the KV heads its query
    heads read where the KV heads are replicated but q's are sharded."""
    local = _local(kv, q)
    H, KV = q.shape[q_heads], kv.shape[kv_heads]
    h0, hl = _offset(q, q_heads)
    kl = _offset(kv, kv_heads)[1]
    if hl == H or kl < KV:  # heads not split, or the KV heads split beside them
        return local
    return local.narrow(kv_heads, *_kv_head_span(H, KV, h0, hl, name))


def _laid(t, x: DTensor, dims) -> DTensor:
    """``t`` (a plain tensor is the same on every rank) sharded where ``x``
    shards the dimensions ``dims`` maps (x's dimension -> t's), replicated
    elsewhere."""
    mesh = x.device_mesh
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pl = tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
               for p in x.placements)
    return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)


def _wrap(local: torch.Tensor, like: DTensor, placements=None) -> DTensor:
    """A rank's output shard as a DTensor on ``like``'s mesh (the shards
    are even: the rules shard only dimensions the mesh axes divide)."""
    return DTensor.from_local(local, like.device_mesh,
                              like.placements if placements is None else placements,
                              run_check=False)


def _kernel_route(backend: Optional[str], t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and resolve_model_backend(backend, t.device) == "cuda"


def on_local_heads(fn, q: DTensor, k, v, *, kernel: bool = False, name: str = "attention"):
    """``fn(q, k, v) -> (B, S, H, hd)`` in model layout (q (B, S, H, hd),
    k/v (B, T, KV, hd)) run on each rank's shards of the batch and the
    heads (module docstring) and wrapped back as a DTensor with q's
    placements.  ``kernel``: ``fn`` launches a kernel, which refuses a KV
    cache sharded on its sequence."""
    q = _keep_only(q, (0, 2))
    k = _match(k, q, 0, 2, 0, 1, 2, kernel, name)
    v = _match(v, q, 0, 2, 0, 1, 2, kernel, name)
    return _wrap(fn(q.to_local(), _local_kv(q, k, 2, 2, name), _local_kv(q, v, 2, 2, name)), q)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128, backend: Optional[str] = None,
                    scale: Optional[float] = None):
    """Model layout: q (B, S, H, hd); k/v (B, T, KV, hd) -> (B, S, H, hd),
    the scores times ``scale`` (default 1/sqrt(hd)).
    DTensors: on each rank's shards (module docstring).  ``block_q`` and
    ``block_k`` are the Pallas kernel's tile sizes, taken and not read: the
    Hopper kernels fix their own tiles (128 keys a tile on both routes)."""
    if isinstance(q, DTensor):
        return on_local_heads(
            lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal, window=window,
                                               backend=backend, scale=scale),
            q, k, v, kernel=_kernel_route(backend, q.to_local()), name="flash_attention")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash_kernel(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, backend=backend, out=out.transpose(1, 2), scale=scale,
    )
    return out


def decode_attention(q, k, v, valid, *, block_k: int = 512, backend: Optional[str] = None,
                     scale: Optional[float] = None):
    """Model layout: q (B, H, hd) one token, head ``g * rep + r`` serving
    KV group g; k/v cache (B, T, KV, hd); valid (B, T) bool -> (B, H, hd),
    the scores times ``scale`` (default 1/sqrt(hd)).
    DTensors: on each rank's shards (module docstring); ``valid`` may be a
    plain tensor, the same on every rank.  ``block_k`` is the Pallas
    kernel's tile size, taken and not read: the Hopper kernel sizes its
    split-K spans itself (``decode_attention.decode_splits``)."""
    if isinstance(q, DTensor):
        q = _keep_only(q, (0, 1))
        kern = _kernel_route(backend, q.to_local())
        k = _match(k, q, 0, 1, 0, 1, 2, kern, "decode_attention")
        v = _match(v, q, 0, 1, 0, 1, 2, kern, "decode_attention")
        b0, bl = _offset(q, 0)
        if isinstance(valid, DTensor):
            valid = valid.full_tensor()
        y = decode_attention(q.to_local(), _local_kv(q, k, 1, 2, "decode_attention"),
                             _local_kv(q, v, 1, 2, "decode_attention"),
                             valid.narrow(0, b0, bl), backend=backend, scale=scale)
        return _wrap(y, q)
    B, H, hd = q.shape
    KV = k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _decode_kernel(
        q.unflatten(1, (KV, H // KV)), k.transpose(1, 2), v.transpose(1, 2), valid,
        backend=backend, out=out.unflatten(1, (KV, H // KV)), scale=scale,
    )
    return out


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128, return_final_state: bool = False,
        initial_state=None, backend: Optional[str] = None):
    """Model layout: x (B, S, H, P), dt (B, S, H), A (H,) f32, Bm/Cm
    (B, S, G, N) -> y (B, S, H, P) [, final state (B, H, N, P) f32], the
    scan from ``initial_state`` (B, H, N, P), taken in f32, or from a zero
    state.  DTensors: on each rank's shards of batch, heads and head
    channels (module docstring), the groups of B/C cut to the local heads'
    where they are replicated, the initial state laid out as the final
    one."""
    if isinstance(x, DTensor):
        x = _keep_only(x, (0, 2, 3))
        kw = dict(chunk=chunk, return_final_state=return_final_state, backend=backend)
        dt = _laid(dt, x, {0: 0, 2: 2})
        A = _laid(A, x, {2: 0})
        Bm = _match(_laid(Bm, x, {0: 0}), x, 0, 2, 0, 1, 2, False, "ssd")
        Cm = _match(_laid(Cm, x, {0: 0}), x, 0, 2, 0, 1, 2, False, "ssd")
        if initial_state is not None:
            kw["initial_state"] = _local(_laid(initial_state, x, {0: 0, 2: 1, 3: 3}), x)
        res = ssd(x.to_local(), _local(dt, x), _local(A, x), _local_kv(x, Bm, 2, 2, "ssd"),
                  _local_kv(x, Cm, 2, 2, "ssd"), **kw)
        y, fin = res if return_final_state else (res, None)
        y = _wrap(y, x)
        if not return_final_state:
            return y
        fin_pl = tuple(Shard({0: 0, 2: 1, 3: 3}[p.dim]) if isinstance(p, Shard) else p
                       for p in x.placements)
        return y, _wrap(fin, x, fin_pl)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    res = _ssd_kernel(
        x.transpose(1, 2), dt.transpose(1, 2), A, Bm.transpose(1, 2), Cm.transpose(1, 2),
        chunk=chunk, return_final_state=return_final_state,
        initial_state=None if initial_state is None else initial_state.float().contiguous(),
        backend=backend, out=y.transpose(1, 2),
    )
    return (y, res[1]) if return_final_state else y


def causal_conv(xBC, w, b, conv_state=None, *, return_state: bool = True,
                backend: Optional[str] = None):
    """Model layout: xBC (B, S, Ch), w (W, Ch), b (Ch,), conv_state
    (B, W-1, Ch) or ``None`` -> (silu(conv(xBC) + b) (B, S, Ch), the new
    conv state (B, W-1, Ch) or ``None``), by ``kernels.causal_conv``.
    DTensors: on each rank's shards of the batch and the channels (module
    docstring); the outputs keep xBC's placements."""
    if isinstance(xBC, DTensor):
        x = _keep_only(xBC, (0, 2))
        if conv_state is not None:
            conv_state = _local(_laid(conv_state, x, {0: 0, 2: 2}), x)
        out, state = causal_conv(x.to_local(), _local(_laid(w, x, {2: 1}), x),
                                 _local(_laid(b, x, {2: 0}), x), conv_state,
                                 return_state=return_state, backend=backend)
        return _wrap(out, x), None if state is None else _wrap(state, x)
    return _conv_kernel(xBC, w, b, conv_state, return_state=return_state, backend=backend)
