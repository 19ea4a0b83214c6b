"""The models of every family, prefill and decode.

The port's counterpart of ``repro/models/model.py`` for its six families:

  dense  — pre-norm GQA transformer (yi-9b, qwen2-72b, stablelm-12b,
           starcoder2-15b and the paper zoo): RoPE, a gated or classic MLP,
           optional biases, a sliding window, tied embeddings and a logits
           soft-cap
  moe    — the dense trunk with a MoE FFN (qwen2-moe: shared + routed
           experts; arctic: routed experts + a dense residual MLP)
  ssm    — Mamba-2 / SSD stack (mamba2-130m)
  hybrid — Mamba-2 backbone + one weight-*shared* attention block applied
           every ``attn_every`` layers (zamba2-1.2b)
  zamba2 — Zamba2's published form (zamba2-7b; ``configs/zamba2.py``): a
           Mamba-2 backbone with grouped gated norms; before each layer of
           ``shared_sites`` one of ``num_mem_blocks`` shared transformer
           blocks, in turn, reads concat([h, embedding]), its MLP with the
           site's adapter, and the site's linear adds its output to that
           layer's Mamba-2 input (not to the residual)
  encdec — bidirectional encoder over stubbed frame embeddings + causal
           decoder with cross attention (seamless-m4t-medium)
  vlm    — the dense trunk over token embeddings with stubbed vision patch
           embeddings scattered at their positions (pixtral-12b)

API (plain functions on a nested dict of tensors):
  init(generator, device=)          -> params
  forward(params, batch)            -> (logits, aux)          teacher forcing
  init_cache(batch, max_len)        -> DecodeCache
  prefill(params, batch, cache)     -> (last_logits, cache)
  decode_step(params, tokens, cache)-> (logits, cache)        one new token

``params["layers"]`` (the encoder-decoder family's ``params["enc_layers"]``
and ``params["dec_layers"]``) is a list with one dict per layer; the
reference stacks every layer leaf on a leading axis instead
(:func:`repro_torch.models.carry.params_from_reference` converts).  The
hybrid family's ``params["shared_attn"]`` is one unstacked block; the
zamba2 family's ``params["shared_blocks"]`` (one dict a shared block) and
``params["sites"]`` (one dict a site: ``lora_a`` (d, r), ``lora_b``
(r, 2 d_ff), ``linear`` (d, d)) are lists like the layers.

Unlike the reference, :meth:`Model.prefill` and :meth:`Model.decode_step`
update the cache's tensors in place (the reference's ``.at[].set`` and
``dynamic_update_slice`` return copies); the returned :class:`DecodeCache`
shares them with the one passed in.  The reference's prefill leaves the
Pallas SSD kernel for its plain form to get the final state; the port's
SSD kernel writes the final state out, so prefill runs on it too.

Causal self-attention runs on the flash and decode kernels; the encoder's
bidirectional attention and the decoder's cross attention stay plain, as
the reference never sends them to its flash kernel.  Every option of
``ModelConfig`` is served: ``attn_impl="chunked"`` takes the chunked plain
attention wherever the flash kernel is not launched (``layers.py``), and
``kv_cache_dtype="int8"`` keeps int8 rings with f32 scales
(``models/quant.py``).

:meth:`Model.decode_step` also takes ``cache.index`` as a (B,) integer
tensor on the device: then each row is its own batch-1 sequence at its own
position, which is what the reference's ``ContinuousBatcher`` computes by
``vmap`` over slots (``serving/continuous.py``).  The MoE layer then
routes each row's token alone (the grouped dispatch, one group a row).

Under a recording ``torch.profiler`` profile the passes are spans
(``obs.profiler.annotate``): ``model/embed``, ``model/layer`` (arg i, one
a layer of a ``layers`` or decoder stack), ``model/unembed`` (the final
norm, the product, the soft-cap) and ``cache/write`` (a layer's ring
write, its conv and SSM state copies, the cross cache); the layers' own
spans (``layers.py``, ``ssm.py``) nest under ``model/layer``, and what a
layer computes between them (the residual adds) is its own.  A zamba2
site's whole application (the concatenation, both norms, attention, the
MLP with its adapter, the site's linear) is ``shared/block`` (args site,
block), inside it ``shared/lora`` (``layers.py``) and
``shared/site_linear``; each application counts ``model.shared_sites``
(``obs.counters``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from ..core.instance import resolve_device
from ..obs import counters
from ..obs.profiler import annotate
from ..sharding import shard
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
    specs_from_decl,
)
from .moe import apply_moe, moe_decl
from .quant import quantize_kv
from .ssm import apply_mamba, init_ssm_state, mamba_decl, mamba_decode_step

__all__ = ["Model", "DecodeCache"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "zamba2")
#: the families whose layers are attention blocks run as one stack
_DENSE_TRUNK = ("dense", "moe", "vlm")
#: the families whose layers are Mamba-2 blocks
_MAMBA_TRUNK = ("ssm", "hybrid", "zamba2")


@dataclasses.dataclass
class DecodeCache:
    """Decode-time state.  ``index`` is the absolute #tokens consumed so
    far: an ``int``, or a (B,) integer tensor on the device when each row
    is at its own position (``ContinuousBatcher``).

    attn:  {'k','v'} (L_attn, B, W, KV, hd) ring buffers (None if attn-free);
           int8 with f32 {'k_scale','v_scale'} (L_attn, B, W, KV, 1) when
           ``kv_cache_dtype="int8"``
    conv:  (L_ssm, B, convw-1, ch)      (None unless ssm/hybrid/zamba2)
    ssm:   (L_ssm, B, H, N, P)          (None unless ssm/hybrid/zamba2)
    cross: {'k','v'} (L_dec, B, T_enc, KV, hd) projected encoder memory,
           written once by prefill (None unless encdec)
    All but the int8 rings and their scales in the activation dtype, as
    the reference's.
    """

    index: Union[int, torch.Tensor]
    attn: Optional[Dict[str, torch.Tensor]] = None
    conv: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    cross: Optional[Dict[str, torch.Tensor]] = None


def _scatter_rows(h: DTensor, pos, vals) -> DTensor:
    """``h[b, pos[b]] = vals[b]`` for every row b of a DTensor ``h`` (B, S,
    D), on each rank's shard: ``pos`` (B, P) and ``vals`` (B, P, D) are laid
    out as ``h`` is on the batch (and ``vals`` on D; the rules never shard
    S), so every row's write is local."""
    mesh = h.device_mesh

    def like(t, dims):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        pl = [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in h.placements]
        return t if list(t.placements) == pl else t.redistribute(mesh, pl)

    hl = h.to_local()
    rows = torch.arange(hl.shape[0], device=hl.device)[:, None]
    out = hl.index_put((rows, like(pos, (0,)).to_local()), like(vals, (0, 2)).to_local())
    return DTensor.from_local(out, mesh, h.placements, run_check=False)


def _take_rows(table, idx):
    """``table[idx]``: the rows of the embedding table (V, D) at the token
    ids ``idx`` (B, S).  On a DTensor table, each rank takes its own
    tokens' rows from the whole table, as local tensors, and the table's
    local gradient is declared a partial sum over the mesh axes that split
    the tokens: torch 2.11's DTensor has no strategy for the lookup's
    backward (an ``index_put`` with the tokens sharded on the batch).  The
    table is gathered first, as DTensor's own lookup does.  On one device
    this is the same lookup and backward as ``table[idx]``, bit for bit."""
    if not isinstance(table, DTensor):
        return table[idx]
    mesh = table.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in idx.placements]
    if list(idx.placements) != pl:
        idx = idx.redistribute(mesh, pl)
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(p, Shard) else Replicate() for p in pl])
    return DTensor.from_local(whole[idx.to_local()], mesh, pl, run_check=False)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        #: the zamba2 family's sites by layer: {layer: site}
        self._site = {i: j for j, i in enumerate(cfg.shared_sites)}

    # ------------------------------------------------------------------ decl
    def _attn_block_decl(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_decl(cfg),
            "attn": attn_decl(cfg),
            "ln2": norm_decl(cfg),
            "mlp": mlp_decl(cfg),
        }

    def _block_decl(self, cross: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.family in _MAMBA_TRUNK:
            return {"ln": norm_decl(cfg), "mamba": mamba_decl(cfg)}
        if cfg.family == "moe":
            return {"ln1": norm_decl(cfg), "attn": attn_decl(cfg), "ln2": norm_decl(cfg),
                    "moe": moe_decl(cfg)}
        d = self._attn_block_decl()
        if cross:
            d["ln_x"] = norm_decl(cfg)
            d["xattn"] = attn_decl(cfg, cross=True)
        return d

    def decl(self) -> Dict[str, Any]:
        """The parameter declarations; each layer stack (``layers``, or
        ``enc_layers`` and ``dec_layers``) is one block's (the parameters
        hold one such dict per layer)."""
        cfg = self.cfg
        d: Dict[str, Any] = {
            "embed": ParamDecl((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "normal", 0.02),
            "ln_f": norm_decl(cfg),
        }
        if not cfg.tie_embeddings:
            d["lm_head"] = ParamDecl((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
        if cfg.family == "encdec":
            d["enc_layers"] = self._block_decl(cross=False)
            d["dec_layers"] = self._block_decl(cross=True)
            d["ln_enc"] = norm_decl(cfg)
        else:
            d["layers"] = self._block_decl()
        if cfg.family == "hybrid":
            d["shared_attn"] = self._attn_block_decl()
        if cfg.family == "zamba2":
            dm, r, f = cfg.d_model, cfg.adapter_rank, cfg.d_ff
            d["shared_blocks"] = dict(self._attn_block_decl(), ln1=norm_decl(cfg, cfg.attn_in))
            d["sites"] = {
                "lora_a": ParamDecl((dm, r), ("embed", None)),
                "lora_b": ParamDecl((r, 2 * f), (None, None)),
                "linear": ParamDecl((dm, dm), ("embed", None)),
            }
        return d

    def stack_sizes(self) -> Dict[str, int]:
        """Each layer stack of :meth:`decl` and its depth (for the zamba2
        family also its shared blocks and its sites)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return {"enc_layers": cfg.num_enc_layers, "dec_layers": cfg.num_layers}
        if cfg.family == "zamba2":
            return {"layers": cfg.num_layers, "shared_blocks": cfg.num_mem_blocks,
                    "sites": len(cfg.shared_sites)}
        return {"layers": cfg.num_layers}

    def _per_layer(self, fn) -> Dict[str, Any]:
        """``fn`` of each subtree of :meth:`decl`, in the parameters'
        layout: a list of one a layer for each layer stack."""
        stacks = self.stack_sizes()
        return {name: [fn(sub) for _ in range(stacks[name])] if name in stacks else fn(sub)
                for name, sub in self.decl().items()}

    def abstract_params(self) -> Dict[str, Any]:
        """The parameters as ``meta`` tensors (shapes and ``param_dtype``,
        no storage), in the layout :meth:`init` returns."""
        dt = _dtype(self.cfg.param_dtype)

        def meta(sub):
            if isinstance(sub, ParamDecl):
                return torch.empty(sub.shape, dtype=dt, device="meta")
            return {k: meta(v) for k, v in sub.items()}

        return self._per_layer(meta)

    def param_logical_specs(self) -> Dict[str, Any]:
        """The logical axes of every parameter, in the layout :meth:`init`
        returns (``models/carry.py::specs_to_reference`` gives the
        reference's stacked tree)."""
        return self._per_layer(specs_from_decl)

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
        stacks = self.stack_sizes()
        out = {}
        for name, sub in self.decl().items():
            if name in stacks:
                out[name] = [init_tree(sub, dt, generator, dev) for _ in range(stacks[name])]
            else:
                out.update(init_tree({name: sub}, dt, generator, dev))
        return out

    # -------------------------------------------------------------- embedding
    def _embed(self, params, tokens, batch=None) -> torch.Tensor:
        """Token embeddings in the activation dtype; for the VLM family, with
        ``batch["vision_embeds"]`` (B, P, D) written at each row's
        ``batch["vision_positions"]`` (B, P)."""
        dt = _dtype(self.cfg.dtype)
        with annotate("model/embed"):
            # laid out before the patches are written (a no-op on one device)
            h = shard(_take_rows(params["embed"], tokens.long()).to(dt), "batch", None, "embed")
            if self.cfg.family == "vlm" and batch is not None and "vision_embeds" in batch:
                vp = batch["vision_positions"].long()
                rows = torch.arange(h.shape[0], device=h.device)[:, None]
                ve = batch["vision_embeds"].to(dt)
                if isinstance(h, DTensor):
                    return _scatter_rows(h, vp, ve)
                h[rows, vp] = ve
            return h

    def _unembed(self, params, h) -> torch.Tensor:
        cfg = self.cfg
        with annotate("model/unembed"):
            h = apply_norm(params["ln_f"], h, cfg)
            if cfg.tie_embeddings:
                logits = h @ params["embed"].T
            else:
                logits = h @ params["lm_head"]
            if cfg.logits_softcap:
                logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
            return shard(logits.float(), "batch", None, "vocab")

    # ----------------------------------------------------------------- blocks
    def _dense_block(self, p, h, positions, *, window=None, cache=None, index=None):
        """(h, kv, router aux): attention, then the MLP or, for the MoE
        family, the MoE FFN (aux is 0 for the others)."""
        cfg = self.cfg
        a, kv = apply_attention(
            p["attn"], apply_norm(p["ln1"], h, cfg), cfg,
            positions=positions, cache=cache, cache_index=index, window=window,
        )
        h = h + a
        x = apply_norm(p["ln2"], h, cfg)
        if "moe" in p:
            # one position a row: each row's token is routed alone, as the
            # reference's vmap over slots routes a batch of one
            m, aux = apply_moe(p["moe"], x, cfg,
                               grouped=True if isinstance(index, torch.Tensor) else None)
        else:
            m, aux = apply_mlp(p["mlp"], x, cfg), torch.zeros((), device=h.device)
        return h + m, kv, aux

    def _decoder_block(self, p, h, positions, mem=None, *, cache=None, cross=None, index=None):
        """(h, self-attention kv, cross kv) of one encoder-decoder decoder
        layer: causal self-attention, cross attention over the encoder
        memory ``mem`` (or its projection ``cross``), the MLP."""
        cfg = self.cfg
        a, kv = apply_attention(p["attn"], apply_norm(p["ln1"], h, cfg), cfg,
                                positions=positions, cache=cache, cache_index=index)
        h = h + a
        xa, xkv = apply_attention(p["xattn"], apply_norm(p["ln_x"], h, cfg), cfg,
                                  positions=positions, mode="cross", kv_input=mem, cache=cross)
        h = h + xa
        return h + apply_mlp(p["mlp"], apply_norm(p["ln2"], h, cfg), cfg), kv, xkv

    def _kept(self, emb):
        """The embedded tokens where the zamba2 family's sites read them, else
        ``None`` (so the other families free them after the first layer)."""
        return emb if self._site else None

    def _shared_block(self, params, site: int, h, emb, positions, *, cache=None, index=None):
        """(the site's output to add to its layer's Mamba-2 input, its kv):
        the zamba2 family's shared block of ``site`` over concat([h, emb]),
        no residual inside, then the site's linear."""
        cfg = self.cfg
        blk = cfg.block_of(site)
        with annotate("shared/block", site=site, block=blk):
            counters.add("model.shared_sites")
            p, s = params["shared_blocks"][blk], params["sites"][site]
            x = apply_norm(p["ln1"], torch.cat([h, emb], dim=-1), cfg)
            a, kv = apply_attention(p["attn"], x, cfg, positions=positions, cache=cache,
                                    cache_index=index)
            mlp = dict(p["mlp"], lora_a=s["lora_a"], lora_b=s["lora_b"])
            m = apply_mlp(mlp, apply_norm(p["ln2"], a, cfg), cfg)
            with annotate("shared/site_linear"):
                return m @ s["linear"], kv

    def _encode(self, params, batch) -> torch.Tensor:
        """The encoder over the stubbed frame embeddings (B, T_enc, D):
        bidirectional attention blocks, then ``ln_enc``."""
        cfg = self.cfg
        mem = shard(batch["enc_embeds"].to(_dtype(cfg.dtype)), "batch", None, "embed")
        pos = make_positions(mem.shape[0], mem.shape[1], device=mem.device)
        for lp in params["enc_layers"]:
            a, _ = apply_attention(lp["attn"], apply_norm(lp["ln1"], mem, cfg), cfg,
                                   positions=pos, mode="bidir")
            mem = mem + a
            mem = mem + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], mem, cfg), cfg)
        return apply_norm(params["ln_enc"], mem, cfg)

    # ---------------------------------------------------------------- forward
    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Teacher-forcing forward over full sequences (train and eval):
        ``(logits, {"router_aux": the MoE layers' load-balance losses
        summed, 0 for the other families})``.  With ``cfg.remat`` and grad
        mode on, each layer of a ``layers`` stack is a
        ``torch.utils.checkpoint`` block (the reference's ``jax.checkpoint``;
        its ``"dots"`` policy recomputes everything here too, with the same
        numbers).  ``cfg.scan_layers`` is the reference's ``lax.scan`` over
        the stacked layers; the port's layer loop computes the same."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self._embed(params, tokens, batch)
        emb = self._kept(h)
        positions = batch.get("positions")
        if positions is None:
            positions = make_positions(B, S, device=h.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if self.cfg.family == "encdec":
            mem = self._encode(params, batch)
            for i, lp in enumerate(params["dec_layers"]):
                with annotate("model/layer", i=i):
                    h = self._decoder_block(lp, h, positions, mem)[0]
            return self._unembed(params, h), {"router_aux": aux}
        for i in range(len(params["layers"])):
            with annotate("model/layer", i=i):
                if self.cfg.remat and torch.is_grad_enabled():
                    h, a = torch.utils.checkpoint.checkpoint(
                        self._layer, params, i, h, positions, emb, use_reentrant=False)
                else:
                    h, a = self._layer(params, i, h, positions, emb)
                aux = aux + a
        return self._unembed(params, h), {"router_aux": aux}

    def _layer(self, params, i: int, h, positions, emb=None):
        """(h, router aux) of layer i of the teacher-forcing forward (with
        the hybrid or zamba2 family's shared block before it where it
        fires; ``emb`` the embedded tokens, which zamba2's reads)."""
        lp = params["layers"][i]
        if self.cfg.family in _DENSE_TRUNK:
            h, _, aux = self._dense_block(lp, h, positions)
            return h, aux
        x = h
        if self._attn_site(i):
            h = x = self._dense_block(params["shared_attn"], h, positions)[0]
        elif i in self._site:
            x = h + self._shared_block(params, self._site[i], h, emb, positions)[0]
        h = h + apply_mamba(lp["mamba"], apply_norm(lp["ln"], x, self.cfg), self.cfg)
        return h, torch.zeros((), device=h.device)

    def _attn_site(self, i: int) -> bool:
        """Whether the hybrid family's shared block fires before layer i."""
        every = self.cfg.attn_every
        return self.cfg.family == "hybrid" and bool(every) and i % every == 0

    # ------------------------------------------------------------------ cache
    def n_attn_sites(self) -> int:
        cfg = self.cfg
        if cfg.family in _DENSE_TRUNK or cfg.family == "encdec":
            return cfg.num_layers
        if cfg.family == "hybrid":
            return -(-cfg.num_layers // cfg.attn_every) if cfg.attn_every else 0
        return len(self._site)

    def cache_window(self, max_len: int) -> int:
        w = self.cfg.sliding_window
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int, enc_len: Optional[int] = None, *,
                   device=None) -> DecodeCache:
        """Zeroed caches in the activation dtype on ``device`` (default: the
        CUDA device; raises without one): (sites, B, W, KV, hd) ring buffers
        for the attention sites (int8, with f32 scales of ones
        (sites, B, W, KV, 1), when ``kv_cache_dtype="int8"``), (L, B, W-1,
        ch) conv and (L, B, H, N, P) SSM states for the mamba layers, and
        for the encoder-decoder family the (L_dec, B, T_enc, KV, hd) cross
        cache in the activation dtype, ``T_enc`` being ``enc_len`` or
        ``cfg.enc_seq_len``."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = _dtype(cfg.dtype)
        attn = conv = ssm = cross = None
        if self.n_attn_sites():
            shape = (self.n_attn_sites(), batch, self.cache_window(max_len),
                     cfg.num_kv_heads, cfg.head_dim)
            if cfg.kv_cache_dtype == "int8":
                attn = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "k_scale": torch.ones(shape[:-1] + (1,), device=dev),
                        "v_scale": torch.ones(shape[:-1] + (1,), device=dev)}
            else:
                attn = {"k": torch.zeros(shape, dtype=dt, device=dev),
                        "v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.family in _MAMBA_TRUNK:
            c1, s1 = init_ssm_state(cfg, batch, dt, dev)
            conv = c1.expand(cfg.num_layers, *c1.shape).clone()
            ssm = s1.expand(cfg.num_layers, *s1.shape).clone()
        if cfg.family == "encdec":
            shape = (cfg.num_layers, batch, enc_len or cfg.enc_seq_len, cfg.num_kv_heads,
                     cfg.head_dim)
            cross = {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}
        return DecodeCache(index=0, attn=attn, conv=conv, ssm=ssm, cross=cross)

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, batch, cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
        """Consume a prompt, fill the cache in place, return last-position
        logits (B, 1, V) in f32.  The encoder-decoder family encodes
        ``batch["enc_embeds"]`` and writes each decoder layer's projected
        memory into the cross cache."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self._embed(params, tokens, batch)
        emb = self._kept(h)
        positions = make_positions(B, S, device=h.device)
        if cache.attn is not None:
            W = cache.attn["k"].shape[2]
            # keep the last min(S, W) tokens; slot = pos % W matches decode:
            # positions S - keep .. S - 1 land in at most two runs of slots
            keep = min(S, W)
            start = (S - keep) % W
            runs = [(start, 0, min(keep, W - start))]
            if runs[0][2] < keep:
                runs.append((0, runs[0][2], keep - runs[0][2]))

        def write(ring, src):
            """``src`` (B, keep, ...) into its slots of ``ring`` (B, W, ...),
            by slices (copies into views, which DTensor takes too)."""
            for slot, at, n in runs:
                ring[:, slot:slot + n] = src[:, at:at + n].to(ring.dtype)

        def fill_ring(site, kv):
            for name in ("k", "v"):
                src = kv[name][:, S - keep:]
                if "k_scale" in cache.attn:  # int8: values and scales at the same slots
                    src, scale = quantize_kv(src)
                    write(cache.attn[name + "_scale"][site], scale)
                write(cache.attn[name][site], src)

        if cfg.family == "encdec":
            mem = self._encode(params, batch)
            for i, lp in enumerate(params["dec_layers"]):
                with annotate("model/layer", i=i):
                    h, kv, xkv = self._decoder_block(lp, h, positions, mem)
                    with annotate("cache/write"):
                        fill_ring(i, kv)
                        for name in ("k", "v"):
                            cache.cross[name][i].copy_(xkv[name])
            return self._unembed(params, h[:, -1:, :]), dataclasses.replace(cache, index=S)

        site = 0
        for i, lp in enumerate(params["layers"]):
            with annotate("model/layer", i=i):
                if cfg.family in _DENSE_TRUNK:
                    h, kv, _ = self._dense_block(lp, h, positions)
                    with annotate("cache/write"):
                        fill_ring(i, kv)
                    continue
                x = h
                if self._attn_site(i):
                    h, kv, _ = self._dense_block(params["shared_attn"], h, positions)
                    with annotate("cache/write"):
                        fill_ring(site, kv)
                    site += 1
                    x = h
                elif i in self._site:
                    t, kv = self._shared_block(params, self._site[i], h, emb, positions)
                    with annotate("cache/write"):
                        fill_ring(self._site[i], kv)
                    x = h + t
                y, (cv, st) = apply_mamba(
                    lp["mamba"], apply_norm(lp["ln"], x, cfg), cfg, return_state=True
                )
                h = h + y
                with annotate("cache/write"):
                    cache.conv[i].copy_(cv)
                    cache.ssm[i].copy_(st)
        logits = self._unembed(params, h[:, -1:, :])
        return logits, dataclasses.replace(cache, index=S)

    # ------------------------------------------------------------ decode step
    def decode_step(self, params, tokens, cache: DecodeCache) -> Tuple[torch.Tensor, DecodeCache]:
        """One new token per sequence.  tokens: (B, 1) int.  With
        ``cache.index`` a (B,) tensor, row b is at position ``index[b]``
        (its own RoPE position, ring slot and validity) and the returned
        index is ``index + 1``."""
        cfg = self.cfg
        idx = cache.index
        h = self._embed(params, tokens)
        emb = self._kept(h)
        if isinstance(idx, torch.Tensor):
            positions = idx[:, None]
        else:
            positions = torch.full((tokens.shape[0], 1), idx, device=h.device)

        def ring(site):
            return {name: t[site] for name, t in cache.attn.items()}

        if cfg.family == "encdec":
            for i, lp in enumerate(params["dec_layers"]):
                cross = {"k": cache.cross["k"][i], "v": cache.cross["v"][i]}
                with annotate("model/layer", i=i):
                    h = self._decoder_block(lp, h, positions, cache=ring(i), cross=cross,
                                            index=idx)[0]
            return self._unembed(params, h), dataclasses.replace(cache, index=idx + 1)

        site = 0
        for i, lp in enumerate(params["layers"]):
            with annotate("model/layer", i=i):
                if cfg.family in _DENSE_TRUNK or self._attn_site(i):
                    block = lp if cfg.family in _DENSE_TRUNK else params["shared_attn"]
                    h = self._dense_block(block, h, positions, cache=ring(site), index=idx)[0]
                    site += 1
                if cfg.family in _DENSE_TRUNK:
                    continue
                x = h
                if i in self._site:
                    j = self._site[i]
                    x = h + self._shared_block(params, j, h, emb, positions, cache=ring(j),
                                               index=idx)[0]
                y, ncv, nst = mamba_decode_step(
                    lp["mamba"], apply_norm(lp["ln"], x, cfg), cfg, cache.conv[i], cache.ssm[i]
                )
                h = h + y
                with annotate("cache/write"):
                    cache.conv[i].copy_(ncv)
                    cache.ssm[i].copy_(nst)
        return self._unembed(params, h), dataclasses.replace(cache, index=idx + 1)
