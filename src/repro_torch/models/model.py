"""The dense decoder-only transformer, prefill and decode.

The port's counterpart of ``repro/models/model.py`` for the ``dense``
family (yi-9b, qwen2-72b, stablelm-12b, starcoder2-15b and the paper zoo):
pre-norm GQA blocks, RoPE, a gated or classic MLP, optional biases, a
sliding window, tied embeddings and a logits soft-cap.

API (plain functions on a nested dict of tensors):
  init(generator, device=)          -> params
  forward(params, batch)            -> (logits, aux)          teacher forcing
  init_cache(batch, max_len)        -> DecodeCache
  prefill(params, batch, cache)     -> (last_logits, cache)
  decode_step(params, tokens, cache)-> (logits, cache)        one new token

``params["layers"]`` is a list with one dict per layer; the reference
stacks every layer leaf on a leading axis instead
(:func:`repro_torch.models.carry.params_from_reference` converts).

Unlike the reference, :meth:`Model.prefill` and :meth:`Model.decode_step`
update the cache's tensors in place (the reference's ``.at[].set`` and
``dynamic_update_slice`` return copies); the returned :class:`DecodeCache`
shares them with the one passed in.

The ``moe``, ``ssm``, ``hybrid``, ``encdec`` and ``vlm`` families, the
``attn_impl="chunked"`` path and the int8 KV cache raise
``NotImplementedError`` naming their ROADMAP item (:func:`check_ported`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

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

__all__ = ["Model", "DecodeCache", "check_ported"]

#: families and options not ported yet -> their ROADMAP.md §1 item
_UNPORTED_FAMILIES = {
    "ssm": "item 11, still to port: the SSM/hybrid forward path with the ssd_scan kernel",
    "hybrid": "item 11, still to port: the SSM/hybrid forward path with the ssd_scan kernel",
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
    if cfg.family != "dense":
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

    attn:  {'k','v'} (L, B, W, KV, hd) ring buffers.  The reference's
    ``conv``/``ssm``/``cross`` fields come with the families that use them
    (ROADMAP.md §1 items 11 and 13).
    """

    index: int
    attn: Dict[str, torch.Tensor]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model:
    def __init__(self, cfg: ModelConfig):
        check_ported(cfg)
        self.cfg = cfg

    # ------------------------------------------------------------------ decl
    def _block_decl(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_decl(cfg),
            "attn": attn_decl(cfg),
            "ln2": norm_decl(cfg),
            "mlp": mlp_decl(cfg),
        }

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
        """Teacher-forcing forward over full sequences (eval)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self._embed(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = make_positions(B, S, h.device)
        for lp in params["layers"]:
            h, _ = self._dense_block(lp, h, positions)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return self._unembed(params, h), {"router_aux": aux}

    # ------------------------------------------------------------------ cache
    def n_attn_sites(self) -> int:
        return self.cfg.num_layers

    def cache_window(self, max_len: int) -> int:
        w = self.cfg.sliding_window
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int, *, device=None) -> DecodeCache:
        """Zeroed (L, B, W, KV, hd) ring buffers in the activation dtype on
        ``device`` (default: the CUDA device; raises without one)."""
        cfg = self.cfg
        dev = resolve_device(device)
        shape = (self.n_attn_sites(), batch, self.cache_window(max_len),
                 cfg.num_kv_heads, cfg.head_dim)
        dt = _dtype(cfg.dtype)
        attn = {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}
        return DecodeCache(index=0, attn=attn)

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, batch, cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
        """Consume a prompt, fill the cache in place, return last-position
        logits (B, 1, V) in f32."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self._embed(params, tokens)
        positions = make_positions(B, S, h.device)
        W = cache.attn["k"].shape[2]
        # keep the last min(S, W) tokens; slot = pos % W matches decode
        keep = min(S, W)
        slots = torch.arange(S - keep, S, device=h.device) % W
        for i, lp in enumerate(params["layers"]):
            h, kv = self._dense_block(lp, h, positions)
            for name in ("k", "v"):
                ring = cache.attn[name][i]
                ring.index_copy_(1, slots, kv[name][:, S - keep:].to(ring.dtype))
        logits = self._unembed(params, h[:, -1:, :])
        return logits, DecodeCache(index=S, attn=cache.attn)

    # ------------------------------------------------------------ decode step
    def decode_step(self, params, tokens, cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
        """One new token per sequence.  tokens: (B, 1) int."""
        idx = cache.index
        h = self._embed(params, tokens)
        positions = torch.full((tokens.shape[0], 1), idx, device=h.device)
        for i, lp in enumerate(params["layers"]):
            lc = {"k": cache.attn["k"][i], "v": cache.attn["v"][i]}
            h, _ = self._dense_block(lp, h, positions, cache=lc, index=idx)
        return self._unembed(params, h), DecodeCache(index=idx + 1, attn=cache.attn)
