"""Input specifications for the dry-run and the sharded steps: ``meta``
tensors standing in for every model input of every (architecture x input
shape), with the shapes and dtypes of the real ones and no storage.

The port's counterpart of ``repro/launch/specs.py``; its ``jax.ShapeDtypeStruct``
stand-ins become ``meta`` tensors, and ``jax.eval_shape`` is the port's own
constructors run on the ``meta`` device.

INPUT SHAPES (the reference's):
  train_4k     seq=4096    global_batch=256   (training -> train_step)
  prefill_32k  seq=32768   global_batch=32    (inference prefill)
  decode_32k   seq=32768   global_batch=128   (ONE token vs a 32k KV cache)
  long_500k    seq=524288  global_batch=1     (ONE token, sub-quadratic only:
               ssm natively; attention archs as sliding_window=8192)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..models.model import DecodeCache, Model

__all__ = ["SHAPES", "ShapeSpec", "shape_config", "input_specs", "abstract_state", "model_flops"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

LONG_CONTEXT_WINDOW = 8192


def shape_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Per-shape config adjustments (the sub-quadratic carve-out, remat for
    deep training)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        # attention-bearing archs run 500k ONLY as the sliding-window variant
        w = cfg.sliding_window or LONG_CONTEXT_WINDOW
        cfg = dataclasses.replace(cfg, sliding_window=min(w, LONG_CONTEXT_WINDOW))
    if shape.kind == "train" and cfg.num_layers >= 32:
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _enc_len(cfg: ModelConfig, seq: int) -> int:
    return min(cfg.enc_seq_len, seq)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The abstract batch of the train and prefill kinds (tokens, labels,
    the modality stubs) as ``meta`` tensors."""
    B = shape.global_batch
    S = shape.seq_len
    d = getattr(torch, cfg.dtype)
    batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm" and cfg.num_patches:
        P = min(cfg.num_patches, S)
        batch["vision_embeds"] = _meta((B, P, cfg.d_model), d)
        batch["vision_positions"] = _meta((B, P), torch.int32)
    if cfg.family == "encdec":
        batch["enc_embeds"] = _meta((B, _enc_len(cfg, S), cfg.d_model), d)
    return batch


def abstract_cache(model: Model, shape: ShapeSpec) -> DecodeCache:
    """The decode cache of ``shape`` as ``meta`` tensors."""
    return model.init_cache(shape.global_batch, shape.seq_len,
                            enc_len=_enc_len(model.cfg, shape.seq_len), device="meta")


def abstract_state(model: Model, with_opt: bool = True):
    """The parameters (and, with ``with_opt``, the AdamW state beside them:
    a ``TrainState``) as ``meta`` tensors."""
    from ..training.optimizer import adamw_init
    from ..training.train_loop import TrainState

    params = model.abstract_params()
    if not with_opt:
        return params
    return TrainState(params, adamw_init(params))


def decode_tokens_spec(shape: ShapeSpec) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS for the useful-compute ratio: 6 N_active tokens (train),
    2 N_active tokens (inference)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
