"""Serving engine: batched prefill + greedy decode.

The port's counterpart of ``repro/serving/engine.py``.  ``ServingEngine``
drives a real model and measures its latencies (what a deployment feeds
back into the GUS scheduler's processing-time table); ``make_serve_step`` /
``make_prefill_step`` build the step functions.  PyTorch runs eagerly, so
there is nothing to jit; a timing reads the clock only after
``torch.cuda.synchronize()``, where the reference calls
``block_until_ready``.  Greedy argmax takes the first maximal index, as
``jnp.argmax`` does.  Generation and evaluation run under
``torch.no_grad()``: the hand kernels have no backward and refuse inputs
that require a gradient, which freshly trained parameters may.

Under a recording ``torch.profiler`` profile, ``generate`` marks its parts
as spans (``obs.profiler.annotate``): ``serve/generate`` around the call
(args: the engine's batch serial, B, S, new tokens) and inside it
``serve/cache_init``, ``serve/sync`` (each wait for the device),
``serve/prefill``, ``serve/greedy``, ``serve/decode`` (each step; arg
step) and ``serve/to_host``; the model's spans nest under prefill and
decode.  Each call counts ``serve.batches`` and ``serve.prompt_tokens``
(``obs.counters``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.instance import resolve_device
from ..models.model import DecodeCache, Model
from ..obs import counters
from ..obs.profiler import annotate
from ..sharding import shard

__all__ = ["ServingEngine", "make_serve_step", "make_prefill_step", "GenerationResult"]


#: cast the logits to bf16 before the serve step's argmax, halving the
#: bytes of a sharded-vocab logits exchange (the reference's perf variant,
#: ``launch/perf.py``'s ``local_argmax``; greedy tokens change only at
#: exact ties in bf16).  Read at each call.
LOCAL_ARGMAX = False


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 tokens, first maximal index.  Under
    ``use_sharding`` the logits are gathered on the vocab axis first (a
    no-op on one device)."""
    with annotate("serve/greedy"):
        logits = shard(logits, "batch", None)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def make_serve_step(model: Model):
    """serve_step(params, tokens (B,1), cache) -> (next_tokens (B,1), cache):
    ONE new token against a KV cache of the configured length."""

    def serve_step(params, tokens, cache: DecodeCache):
        logits, cache = model.decode_step(params, tokens, cache)
        lg = logits[:, -1, :]
        if LOCAL_ARGMAX:
            lg = lg.to(torch.bfloat16)
        return _greedy(lg), cache

    return serve_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch, cache: DecodeCache):
        logits, cache = model.prefill(params, batch, cache)
        return _greedy(logits[:, -1, :]), cache

    return prefill_step


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # (B, gen)
    prefill_ms: float
    decode_ms_per_token: float
    total_ms: float


class ServingEngine:
    """Batched generation for one model whose parameters lie on ``device``
    (default: the CUDA device; raises without one)."""

    def __init__(self, model: Model, params, *, device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"the parameters are on {params['embed'].device}, the engine on {self.device}"
            )
        self.model = model
        self.params = params
        self._decode = make_serve_step(model)
        self._batches = 0  # generate calls so far: each batch's serial in its span

    def _sync(self):
        with annotate("serve/sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(
        self,
        batch: Dict[str, torch.Tensor],
        max_new_tokens: int = 16,
        max_len: Optional[int] = None,
    ) -> GenerationResult:
        B, S = batch["tokens"].shape
        self._batches += 1
        counters.add("serve.batches")
        counters.add("serve.prompt_tokens", B * S)
        with annotate("serve/generate", batch=self._batches, B=B, S=S, new=max_new_tokens):
            max_len = max_len or (S + max_new_tokens)
            with annotate("serve/cache_init"):
                cache = self.model.init_cache(B, max_len, device=self.device)

            self._sync()
            t0 = time.perf_counter()
            with annotate("serve/prefill"):
                logits, cache = self.model.prefill(self.params, batch, cache)
            self._sync()
            t1 = time.perf_counter()

            tok = _greedy(logits[:, -1, :])
            out = [tok]
            for step in range(max_new_tokens - 1):
                with annotate("serve/decode", step=step):
                    tok, cache = self._decode(self.params, tok, cache)
                out.append(tok)
            self._sync()
            t2 = time.perf_counter()
            with annotate("serve/to_host"):
                tokens = torch.cat(out, dim=1).cpu().numpy()

        return GenerationResult(
            tokens=tokens,
            prefill_ms=1000 * (t1 - t0),
            decode_ms_per_token=1000 * (t2 - t1) / max(max_new_tokens - 1, 1),
            total_ms=1000 * (t2 - t0),
        )

    @torch.no_grad()
    def eval_next_token_accuracy(self, batch: Dict[str, torch.Tensor]) -> float:
        """Teacher-forcing next-token top-1 accuracy — the 'accuracy' that the
        scheduler trades against latency for the zoo variants."""
        logits, _ = self.model.forward(self.params, batch)
        pred = torch.argmax(logits, dim=-1)
        return float((pred == batch["labels"]).float().mean())
