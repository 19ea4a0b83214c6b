"""The decoder-only models, prefill and decode.

The port's counterpart of ``repro/models/model.py`` for three families:

  dense  — pre-norm GQA transformer (yi-9b, qwen2-72b, stablelm-12b,
           starcoder2-15b and the paper zoo): RoPE, a gated or classic MLP,
           optional biases, a sliding window, tied embeddings and a logits
           soft-cap
  ssm    — Mamba-2 / SSD stack (mamba2-130m)
  hybrid — Mamba-2 backbone + one weight-*shared* attention block applied
           every ``attn_every`` layers (zamba2-1.2b)

API (plain functions on a nested dict of tensors):
  init(generator, device=)          -> params
  forward(params, batch)            -> (logits, aux)          teacher forcing
  init_cache(batch, max_len)        -> DecodeCache
  prefill(params, batch, cache)     -> (last_logits, cache)
  decode_step(params, tokens, cache)-> (logits, cache)        one new token

``params["layers"]`` is a list with one dict per layer; the reference
stacks every layer leaf on a leading axis instead
(:func:`repro_torch.models.carry.params_from_reference` converts).  The
hybrid family's ``params["shared_attn"]`` is one unstacked block.

Unlike the reference, :meth:`Model.prefill` and :meth:`Model.decode_step`
update the cache's tensors in place (the reference's ``.at[].set`` and
``dynamic_update_slice`` return copies); the returned :class:`DecodeCache`
shares them with the one passed in.  The reference's prefill leaves the
Pallas SSD kernel for its plain form to get the final state; the port's
SSD kernel writes the final state out, so prefill runs on it too.

The ``moe``, ``encdec`` and ``vlm`` families, the ``attn_impl="chunked"``
path and the int8 KV cache raise ``NotImplementedError`` naming their
ROADMAP item (:func:`check_ported`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..core.instance import resolve_device
from .layers import (
    ParamDecl,
    apply_attention,
    apply_mlp,
    apply_norm,
    attn_decl,
    init_tree,
    make_positions,
    mlp_decl,
    norm_decl,
)
from .ssm import apply_mamba, init_ssm_state, mamba_decl, mamba_decode_step

__all__ = ["Model", "DecodeCache", "check_ported"]

#: families and options not ported yet -> their ROADMAP.md §1 item
_UNPORTED_FAMILIES = {
    "moe": "item 12, still to port: the MoE family",
    "encdec": "item 13, still to port: the encoder-decoder family",
    "vlm": "item 14, still to port: the VLM family",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve yet."""
    if cfg.family in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet "
            f"(ROADMAP.md §1 {_UNPORTED_FAMILIES[cfg.family]})"
        )
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "kv_cache_dtype='int8' is not ported yet (ROADMAP.md §1 item 15, still to "
            "port: the int8 KV cache of models/quant.py)"
        )
    if cfg.attn_impl == "chunked":
        raise NotImplementedError(
            "attn_impl='chunked' is not ported yet (ROADMAP.md §1 item 16, still to "
            "port: the chunked attention path)"
        )


@dataclasses.dataclass
class DecodeCache:
    """Decode-time state.  ``index`` is the absolute #tokens consumed so far.

    attn:  {'k','v'} (L_attn, B, W, KV, hd) ring buffers (None if attn-free)
    conv:  (L_ssm, B, convw-1, ch)      (None unless ssm/hybrid)
    ssm:   (L_ssm, B, H, N, P)          (None unless ssm/hybrid)
    All in the activation dtype, as the reference's.  The reference's
    ``cross`` field comes with the encoder-decoder family (ROADMAP.md §1
    item 13).
    """

    index: int
    attn: Optional[Dict[str, torch.Tensor]] = None
    conv: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model:
    def __init__(self, cfg: ModelConfig):
        check_ported(cfg)
        self.cfg = cfg

    # ------------------------------------------------------------------ decl
    def _attn_block_decl(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_decl(cfg),
            "attn": attn_decl(cfg),
            "ln2": norm_decl(cfg),
            "mlp": mlp_decl(cfg),
        }

    def _block_decl(self) -> Dict[str, Any]:
        if self.cfg.family in ("ssm", "hybrid"):
            return {"ln": norm_decl(self.cfg), "mamba": mamba_decl(self.cfg)}
        return self._attn_block_decl()

    def decl(self) -> Dict[str, Any]:
        """The parameter declarations; ``layers`` is one block's (the
        parameters hold one such dict per layer)."""
        cfg = self.cfg
        d: Dict[str, Any] = {
            "embed": ParamDecl((cfg.vocab_size, cfg.d_model), "normal", 0.02),
            "ln_f": norm_decl(cfg),
        }
        if not cfg.tie_embeddings:
            d["lm_head"] = ParamDecl((cfg.d_model, cfg.vocab_size))
        d["layers"] = self._block_decl()
        if cfg.family == "hybrid":
            d["shared_attn"] = self._attn_block_decl()
        return d

    # ------------------------------------------------------------------ init
    def init(self, generator: Union[int, torch.Generator] = 0, *, device=None) -> Dict[str, Any]:
        """Random parameters drawn on ``device`` (default: the CUDA device;
        raises without one) from ``generator``, a ``torch.Generator`` on that
        device or an integer seed.  Each leaf is drawn in f32 and cast to
        ``param_dtype`` before the next is drawn."""
        cfg = self.cfg
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(int(generator))
        dt = _dtype(cfg.param_dtype)
        decl = self.decl()
        block = decl.pop("layers")
        out = init_tree(decl, dt, generator, dev)
        out["layers"] = [init_tree(block, dt, generator, dev) for _ in range(cfg.num_layers)]
        return out

    # -------------------------------------------------------------- embedding
    def _embed(self, params, tokens) -> torch.Tensor:
        return params["embed"][tokens.long()].to(_dtype(self.cfg.dtype))

    def _unembed(self, params, h) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(params["ln_f"], h, cfg)
        if cfg.tie_embeddings:
            logits = h @ params["embed"].T
        else:
            logits = h @ params["lm_head"]
        if cfg.logits_softcap:
            logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
        return logits.float()

    # ----------------------------------------------------------------- blocks
    def _dense_block(self, p, h, positions, *, window=None, cache=None, index=None):
        cfg = self.cfg
        a, kv = apply_attention(
            p["attn"], apply_norm(p["ln1"], h, cfg), cfg,
            positions=positions, cache=cache, cache_index=index, window=window,
        )
        h = h + a
        m = apply_mlp(p["mlp"], apply_norm(p["ln2"], h, cfg), cfg)
        return h + m, kv

    # ---------------------------------------------------------------- forward
    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Teacher-forcing forward over full sequences (train and eval).
        With ``cfg.remat`` and grad mode on, each layer is a
        ``torch.utils.checkpoint`` block (the reference's ``jax.checkpoint``;
        its ``"dots"`` policy recomputes everything here too, with the same
        numbers).  ``cfg.scan_layers`` is the reference's ``lax.scan`` over
        the stacked layers; the port's layer loop computes the same."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self._embed(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = make_positions(B, S, h.device)
        for i in range(len(params["layers"])):
            if self.cfg.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(
                    self._layer, params, i, h, positions, use_reentrant=False)
            else:
                h = self._layer(params, i, h, positions)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return self._unembed(params, h), {"router_aux": aux}

    def _layer(self, params, i: int, h, positions):
        """Layer i of the teacher-forcing forward (with the hybrid family's
        shared block before it where it fires)."""
        lp = params["layers"][i]
        if self.cfg.family == "dense":
            return self._dense_block(lp, h, positions)[0]
        if self._attn_site(i):
            h, _ = self._dense_block(params["shared_attn"], h, positions)
        return h + apply_mamba(lp["mamba"], apply_norm(lp["ln"], h, self.cfg), self.cfg)

    def _attn_site(self, i: int) -> bool:
        """Whether the hybrid family's shared block fires before layer i."""
        every = self.cfg.attn_every
        return self.cfg.family == "hybrid" and bool(every) and i % every == 0

    # ------------------------------------------------------------------ cache
    def n_attn_sites(self) -> int:
        cfg = self.cfg
        if cfg.family == "dense":
            return cfg.num_layers
        if cfg.family == "hybrid":
            return -(-cfg.num_layers // cfg.attn_every) if cfg.attn_every else 0
        return 0

    def cache_window(self, max_len: int) -> int:
        w = self.cfg.sliding_window
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int, *, device=None) -> DecodeCache:
        """Zeroed caches in the activation dtype on ``device`` (default: the
        CUDA device; raises without one): (sites, B, W, KV, hd) ring buffers
        for the attention sites, (L, B, W-1, ch) conv and (L, B, H, N, P)
        SSM states for the mamba layers."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = _dtype(cfg.dtype)
        attn = conv = ssm = None
        if self.n_attn_sites():
            shape = (self.n_attn_sites(), batch, self.cache_window(max_len),
                     cfg.num_kv_heads, cfg.head_dim)
            attn = {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.family in ("ssm", "hybrid"):
            c1, s1 = init_ssm_state(cfg, batch, dt, dev)
            conv = c1.expand(cfg.num_layers, *c1.shape).clone()
            ssm = s1.expand(cfg.num_layers, *s1.shape).clone()
        return DecodeCache(index=0, attn=attn, conv=conv, ssm=ssm)

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, batch, cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
        """Consume a prompt, fill the cache in place, return last-position
        logits (B, 1, V) in f32."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self._embed(params, tokens)
        positions = make_positions(B, S, h.device)
        if cache.attn is not None:
            W = cache.attn["k"].shape[2]
            # keep the last min(S, W) tokens; slot = pos % W matches decode
            keep = min(S, W)
            slots = torch.arange(S - keep, S, device=h.device) % W

        def fill_ring(site, kv):
            for name in ("k", "v"):
                ring = cache.attn[name][site]
                ring.index_copy_(1, slots, kv[name][:, S - keep:].to(ring.dtype))

        site = 0
        for i, lp in enumerate(params["layers"]):
            if cfg.family == "dense":
                h, kv = self._dense_block(lp, h, positions)
                fill_ring(i, kv)
                continue
            if self._attn_site(i):
                h, kv = self._dense_block(params["shared_attn"], h, positions)
                fill_ring(site, kv)
                site += 1
            y, (cv, st) = apply_mamba(
                lp["mamba"], apply_norm(lp["ln"], h, cfg), cfg, return_state=True
            )
            h = h + y
            cache.conv[i].copy_(cv)
            cache.ssm[i].copy_(st)
        logits = self._unembed(params, h[:, -1:, :])
        return logits, dataclasses.replace(cache, index=S)

    # ------------------------------------------------------------ decode step
    def decode_step(self, params, tokens, cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
        """One new token per sequence.  tokens: (B, 1) int."""
        cfg = self.cfg
        idx = cache.index
        h = self._embed(params, tokens)
        positions = torch.full((tokens.shape[0], 1), idx, device=h.device)
        site = 0
        for i, lp in enumerate(params["layers"]):
            if cfg.family == "dense" or self._attn_site(i):
                lc = {"k": cache.attn["k"][site], "v": cache.attn["v"][site]}
                block = lp if cfg.family == "dense" else params["shared_attn"]
                h, _ = self._dense_block(block, h, positions, cache=lc, index=idx)
                site += 1
            if cfg.family == "dense":
                continue
            y, ncv, nst = mamba_decode_step(
                lp["mamba"], apply_norm(lp["ln"], h, cfg), cfg, cache.conv[i], cache.ssm[i]
            )
            h = h + y
            cache.conv[i].copy_(ncv)
            cache.ssm[i].copy_(nst)
        return self._unembed(params, h), dataclasses.replace(cache, index=idx + 1)
