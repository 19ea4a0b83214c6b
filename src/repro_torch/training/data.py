"""Deterministic synthetic token data.

The port's copy of ``SyntheticLM`` and ``make_batch`` from
``repro/training/data.py``: the same seeded numpy sampler (an order-1
Markov chain with copy motifs), so the same seed gives the same tokens in
both packages; :func:`make_batch` hands them over as tensors on a device,
and :func:`batch_iterator` streams them as the reference's does.

The modality stubs are the reference's too: :func:`vision_stub_batch` and
:func:`audio_stub_batch` hand precomputed patch / frame embeddings of the
right shape (no ViT or conv frontend), drawn from the same ``rng`` after
the tokens, so they equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.instance import resolve_device

__all__ = ["SyntheticLM", "make_batch", "batch_iterator", "vision_stub_batch",
           "audio_stub_batch"]


@dataclasses.dataclass
class SyntheticLM:
    """Order-1 Markov chain over a vocab with periodic copy motifs — enough
    structure that cross-entropy falls well below uniform for a trained model.

    ``alpha`` controls difficulty: smaller -> peakier transitions -> higher
    achievable next-token accuracy."""

    vocab_size: int
    seed: int = 0
    motif_period: int = 17
    motif_period2: Optional[int] = None   # second, longer-range copy motif
    alpha: float = 0.05

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = min(self.vocab_size, 512)  # transition table kept small
        self._V = V
        raw = rng.dirichlet(np.full(V, self.alpha), size=V).astype(np.float32)
        self._trans = raw / raw.sum(-1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        V = self._V
        out = np.empty((batch, seq), np.int32)
        state = rng.integers(0, V, size=batch)
        for t in range(seq):
            p2 = self.motif_period2
            if p2 and t % p2 == 0 and t >= p2:
                state = out[:, t - p2]                 # long-range copy motif
            elif t % self.motif_period == 0 and t > 0:
                state = out[:, t - self.motif_period]  # copy motif
            else:
                u = rng.random(batch)
                cdf = np.cumsum(self._trans[state], axis=-1)
                state = (u[:, None] < cdf).argmax(-1)
            out[:, t] = state
        return out % self.vocab_size


def make_batch(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    rng: np.random.Generator,
    source: Optional[SyntheticLM] = None,
    *,
    device=None,
) -> Dict[str, torch.Tensor]:
    """One batch of int32 ``tokens`` and next-token ``labels`` (B, seq) on
    ``device`` (default: the CUDA device; raises without one), with the
    VLM family's vision stub or the encoder-decoder family's audio stub."""
    dev = resolve_device(device)
    src = source or SyntheticLM(cfg.vocab_size)
    toks = torch.from_numpy(src.sample(rng, batch, seq + 1))
    out = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    if cfg.family == "vlm" and cfg.num_patches:
        out.update(vision_stub_batch(cfg, batch, seq, rng, device=dev))
    if cfg.family == "encdec":
        out.update(audio_stub_batch(cfg, batch, rng, device=dev))
    return out


def vision_stub_batch(cfg: ModelConfig, batch: int, seq: int, rng: np.random.Generator, *,
                      device=None) -> Dict[str, torch.Tensor]:
    """STUB vision frontend: f32 ``vision_embeds`` (B, P, d_model) of std
    0.02 and int32 ``vision_positions`` (B, P), the first ``P =
    min(num_patches, seq)`` slots of the token stream."""
    dev = resolve_device(device)
    P = min(cfg.num_patches, seq)
    emb = rng.standard_normal((batch, P, cfg.d_model)).astype(np.float32) * 0.02
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (batch, P)).copy()
    return {"vision_embeds": torch.from_numpy(emb).to(dev),
            "vision_positions": torch.from_numpy(pos).to(dev)}


def audio_stub_batch(cfg: ModelConfig, batch: int, rng: np.random.Generator, *,
                     device=None) -> Dict[str, torch.Tensor]:
    """STUB audio frontend: f32 frame embeddings ``enc_embeds`` (B,
    enc_seq_len, d_model) of std 0.02."""
    dev = resolve_device(device)
    emb = rng.standard_normal((batch, cfg.enc_seq_len, cfg.d_model)).astype(np.float32) * 0.02
    return {"enc_embeds": torch.from_numpy(emb).to(dev)}


def batch_iterator(
    cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *, device=None
) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless training batches: ``SyntheticLM(vocab, seed)`` sampled with
    ``default_rng(seed + 1)``, the reference's streams, on ``device``
    (default: the CUDA device; raises without one)."""
    dev = resolve_device(device)
    src = SyntheticLM(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        yield make_batch(cfg, batch, seq, rng, src, device=dev)
