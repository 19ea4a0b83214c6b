"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

The port's counterpart of ``repro/models/moe.py``, op for op, for both MoE
flavours of the registry:

  * qwen2-moe-a2.7b — 4 *shared* (always-on) experts summed with 60 routed
    top-4 experts;
  * arctic-480b     — 128 routed top-2 experts in parallel with a *dense
    residual* MLP.

Dispatch: f32 router -> softmax -> top-k (renormalised gates) ->
position-in-expert cumsum in token-major order -> capacity ``C`` slots per
expert (overflowing choices are dropped: they go to the overflow slot ``C``
and the sentinel row, both cut off) -> gather to (E, C, D) -> gated expert
FFN -> weighted combine.  On one device the reference takes the *grouped*
dispatch (per batch row, capacity from S) for S > 1 and the *global* one
(capacity from B*S) for decode; the port has no mesh, so that rule is all
of :func:`apply_moe`'s choice, with one exception.  A decode step whose
rows are each at their own position (``DecodeCache.index`` a (B,)
tensor, the ``ContinuousBatcher``'s step) is the reference's batch-1
decode ``vmap``-ed over slots: each slot routes its one token alone with
``capacity(1)`` = 8 slots an expert, and nothing drops.  The global
dispatch over B tokens (``C = capacity(B)``) can drop choices once B > 8,
so that step passes ``grouped=True``: one group a row, ``C = capacity(1)``,
which equals the vmapped reference.

Four choices keep the port's integers and sums the reference's:

* the router product is full float32 on the card too: TF32, where it is
  on, is held off for that one product (:func:`_f32_product`);
* top-k is a stable descending sort, so equal probabilities pick the lower
  expert first, as ``jax.lax.top_k`` does (``torch.topk`` breaks ties
  otherwise);
* the combine adds each token's kept contributions in ascending expert
  order to a zero in ``x.dtype``, rounding after each add, which is the
  order in which XLA's scatter-add applies the flattened (e, c) updates;
  it is a gather and a fixed-order sum, never an atomic ``index_add_``;
* each contribution ``ye * gate`` is rounded to ``x.dtype`` before it is
  added, as the reference's ``ye * gate_map`` is.

The expert products stay ``torch.bmm``: plain matrix products, which the
reference computes outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ..configs.base import ModelConfig
from ..sharding import shard
from .layers import ParamDecl, _act, apply_mlp, mlp_decl

__all__ = [
    "moe_decl", "apply_moe", "router_aux_loss", "capacity", "dispatch", "combine", "Dispatch",
]


# dtype of the dispatch one-hot/cumsum intermediates; int16 halves the bytes
# of the rank tensor (safe while a group routes fewer than 32768 choices) —
# the reference's perf variant (launch/perf.py), read at each call
DISPATCH_DTYPE = "int32"


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: 128-multiples at 128
    or above, else 8-multiples, at least 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    if c >= 128:
        return -(-c // 128) * 128
    return max(8, -(-c // 8) * 8)


def moe_decl(cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.effective_moe_d_ff
    E = cfg.n_experts
    decl: Dict[str, Any] = {
        "router": ParamDecl((d, E), ("embed", "experts"), "normal", 0.02),
        "w_gate": ParamDecl((E, d, f), ("experts", "embed", "expert_ff")),
        "w_up": ParamDecl((E, d, f), ("experts", "embed", "expert_ff")),
        "w_down": ParamDecl((E, f, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.shared_expert_d_ff or f
        decl["shared"] = mlp_decl(cfg, d_ff=fs * cfg.n_shared_experts)
        decl["shared_gate"] = ParamDecl((d, 1), ("embed", None), "normal", 0.02)
    if cfg.dense_residual:
        decl["dense"] = mlp_decl(cfg)
    return decl


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig,
              grouped: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss): by default the grouped dispatch for
    S > 1, the global one for decode (S == 1); ``grouped=True`` takes the
    grouped one at any S (a decode step with one position a row)."""
    return _apply_moe(p, x, cfg, grouped=x.shape[1] > 1 if grouped is None else grouped)


class Dispatch(NamedTuple):
    """The routing and slot assignment of one MoE call, over G groups of n
    tokens (grouped: G = B rows of S; global: G = 1 group of B*S)."""

    probs: torch.Tensor       # (G, n, E) f32
    expert_idx: torch.Tensor  # (G, n, K) int64
    pos: torch.Tensor         # (G, n*K) int32 rank of each choice in its expert
    keep: torch.Tensor        # (G, n*K) bool: pos < capacity
    tok_map: torch.Tensor     # (G, E, C) int32: the token in each slot, n where none
    gate_map: torch.Tensor    # (G, E, C) x.dtype: its gate, 0 where none
    capacity: int


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 on the card too: where cuBLAS may take
    TF32 for float32 products, it is held off for this one product and the
    setting put back.  The router's last bits decide the routing at
    near-ties."""
    matmul = torch.backends.cuda.matmul
    was = matmul.fp32_precision  # reflects the legacy ``allow_tf32`` too
    if not a.is_cuda or was != "tf32":
        return a @ b
    matmul.fp32_precision = "ieee"
    try:
        return a @ b
    finally:
        matmul.fp32_precision = was


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """(probs, gate_vals, expert_idx) over the last axis of x: the f32
    router (never TF32), softmax, top-k by a stable descending sort (ties
    to the lower expert) and the renormalised gates."""
    logits = _f32_product(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[..., :cfg.top_k], expert_idx[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def dispatch(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, *,
             grouped: bool) -> Dispatch:
    """Route x (B, S, D) and assign slots: per batch row with capacity C(S)
    (``grouped``), or over all B*S tokens with C(B*S).  Choices are ranked
    within their expert in token-major order, so earlier tokens win slots;
    a dropped choice goes to the overflow slot C, which is cut off.

    On DTensors (the sharded steps) the routing runs on the whole batch,
    the same on every rank, and its tensors come back replicated."""
    if isinstance(x, DTensor):
        full = dispatch(x.full_tensor(), _full(router), cfg, grouped=grouped)
        rep = [Replicate()] * x.device_mesh.ndim
        return Dispatch(*(
            DTensor.from_local(t, x.device_mesh, rep, run_check=False)
            if isinstance(t, torch.Tensor) else t for t in full
        ))
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xs = x if grouped else x.reshape(1, B * S, D)
    G, n = xs.shape[:2]
    C = capacity(n, cfg)
    probs, gate_vals, expert_idx = route(xs, router, cfg)
    e_f = expert_idx.reshape(G, n * K)
    idt = getattr(torch, DISPATCH_DTYPE)
    onehot = F.one_hot(e_f, E).to(idt)                            # (G, n*K, E)
    pos = torch.cumsum(onehot, dim=1, dtype=idt) - onehot
    pos = (pos * onehot).sum(-1, dtype=torch.int32)
    keep = pos < C
    slot = torch.where(keep, pos, C).long()
    t_f = (torch.arange(n * K, device=x.device) // K).expand(G, n * K)
    tok = torch.where(keep, t_f, n).to(torch.int32)
    g_f = gate_vals.reshape(G, n * K).to(x.dtype)
    rows = torch.arange(G, device=x.device)[:, None]
    tok_map = torch.full((G, E, C + 1), n, dtype=torch.int32, device=x.device)
    tok_map[rows, e_f, slot] = tok
    gate_map = torch.zeros((G, E, C + 1), dtype=x.dtype, device=x.device)
    gate_map[rows, e_f, slot] = torch.where(keep, g_f, torch.zeros_like(g_f))
    return Dispatch(probs, expert_idx, pos, keep, tok_map[..., :C], gate_map[..., :C], C)


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _expert_ffn(xe: torch.Tensor, p, cfg: ModelConfig, axes) -> torch.Tensor:
    """(E, N, D) rows -> (E, N, D): the gated expert FFN, three bmm.
    ``axes``: the logical names of the first two axes (the reference's
    sharding of its expert activations)."""
    xe = shard(xe, *axes, "embed")
    h = _act(cfg, torch.bmm(xe, p["w_gate"]))
    h = h * torch.bmm(xe, p["w_up"])
    h = shard(h, *axes, "expert_ff")
    return torch.bmm(h, p["w_down"])


def combine(weighted: torch.Tensor, e_f, pos, keep, K: int) -> torch.Tensor:
    """Each token's kept contributions summed in ascending expert order.

    ``weighted``: (..., E, C, D), each slot's ``ye * gate`` already in the
    activation dtype; ``e_f``/``pos``/``keep``: (..., T*K) token-major
    choices.  Returns (..., T, D): a zero in the activation dtype, then
    one add (rounded) per choice in ascending expert order, a dropped
    choice adding nothing.  This is the order in which the reference's
    scatter-add of the flattened (e, c) updates reaches each token."""
    *lead, E, C, D = weighted.shape
    # each token reads its own slots among all E x C: on DTensors the slots
    # are gathered first; the groups, where there are several (grouped: one
    # a batch row), may stay split on the batch axes
    split = bool(lead) and lead[0] > 1
    weighted = shard(weighted, *(("batch",) if split else ()),
                     *(None,) * (weighted.dim() - split))
    T = e_f.shape[-1] // K
    e_t, order = torch.sort(e_f.reshape(*lead, T, K), dim=-1)  # experts distinct per token
    pos_t = torch.gather(pos.reshape(*lead, T, K), -1, order)
    keep_t = torch.gather(keep.reshape(*lead, T, K), -1, order)
    flat = (e_t.long() * C + torch.clamp(pos_t, max=C - 1).long()).reshape(*lead, T * K)
    rows = weighted.reshape(*lead, E * C, D)
    picked = torch.gather(rows, -2, flat[..., None].expand(*flat.shape, D))
    picked = picked.reshape(*lead, T, K, D)
    picked = torch.where(keep_t[..., None], picked, torch.zeros((), dtype=picked.dtype,
                                                                 device=picked.device))
    y = torch.zeros((*lead, T, D), dtype=weighted.dtype, device=weighted.device)
    for k in range(K):
        y = y + picked[..., k, :]
    return y


def _always_on(p, x: torch.Tensor, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The shared experts behind their sigmoid gate, and the dense
    residual MLP."""
    if cfg.n_shared_experts:
        sg = torch.sigmoid(x @ p["shared_gate"]).to(x.dtype)
        y = y + sg * apply_mlp(p["shared"], x, cfg)
    if cfg.dense_residual:
        y = y + apply_mlp(p["dense"], x, cfg)
    return y


def _apply_moe(p, x: torch.Tensor, cfg: ModelConfig, grouped: bool):
    """The reference's ``_apply_moe_grouped`` (per batch row; the experts'
    weights shared across rows) and ``_apply_moe_global`` (one group of
    B*S tokens), op for op: dispatch, gather to (E, G*C, D), the expert
    FFN, the combine, the always-on branches."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    d = dispatch(x, p["router"], cfg, grouped=grouped)
    aux = router_aux_loss(d.probs.reshape(-1, E), d.expert_idx.reshape(-1, K), E)
    G, n, C = d.probs.shape[0], d.probs.shape[1], d.capacity
    xs = x.reshape(G, n, D)
    xpad = torch.cat([xs, torch.zeros((G, 1, D), dtype=x.dtype, device=x.device)], dim=1)
    rows = d.tok_map.reshape(G, E * C).long()
    xe = torch.gather(xpad, 1, rows[..., None].expand(G, E * C, D))    # sentinel: zeros
    xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    # the reference's layouts: per row (grouped) the rows' slots on the batch
    # axes and the experts replicated; one group (global) the experts sharded
    axes = (None, "batch") if grouped else ("experts", "capacity")
    ye = _expert_ffn(xe, p, cfg, axes).reshape(E, G, C, D).transpose(0, 1)  # (G, E, C, D)
    y = combine(ye * d.gate_map[..., None], d.expert_idx.reshape(G, n * K), d.pos, d.keep, K)
    y = shard(y.reshape(B, S, D), "batch", None, "embed")
    return _always_on(p, x, y, cfg), aux


def router_aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e, where f_e is the
    fraction of routed choices sent to e and P_e the mean router prob."""
    idx = _full(expert_idx).reshape(-1)
    # bincount by a scatter of ones: integer counts in any order, and a
    # shape that does not depend on the data (the dry-run's fake tensors)
    f = torch.zeros(n_experts, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx)).float()
    f = f / expert_idx.numel()
    P = probs.float().mean(dim=0)
    return n_experts * torch.sum(f * P)
