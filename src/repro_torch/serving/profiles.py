"""Analytic performance profiles: ModelConfig -> (FLOPs, bytes) -> latency.

The port's copy of ``repro.serving.profiles``: the bridge between the model
configurations and the scheduler.  The processing-delay table T^proc_{jkl}
that GUS consumes is derived from the models by a roofline estimate per
step (prefill, then one decode step per generated token) on a modeled
hardware class.  The classes and their constants are the reference's
modeled tiers, kept value for value so that the table equals the
reference's bit for bit; they describe the paper's heterogeneous
edge/cloud tiers for the simulator, not a card this port runs on.  Plain
Python floats throughout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from ..configs.base import ModelConfig

__all__ = ["HardwareClass", "HW_CLASSES", "step_costs", "request_latency_ms", "accuracy_proxy"]


@dataclasses.dataclass(frozen=True)
class HardwareClass:
    """A modeled hardware tier: ``chips`` units, each with the reference's
    modeled peak rate (FLOP/s), memory rate and link rate (bytes/s)."""

    name: str
    chips: int
    peak_flops: float = 197e12
    hbm_bw: float = 819e9
    link_bw: float = 50e9


#: the reference's modeled classes: the paper's three edge classes and a
#: cloud tier, in unit counts
HW_CLASSES: Dict[str, HardwareClass] = {
    "edge-1": HardwareClass("edge-1", 1),
    "edge-4": HardwareClass("edge-4", 4),
    "edge-8": HardwareClass("edge-8", 8),
    "cloud-256": HardwareClass("cloud-256", 256),
}


def step_costs(cfg: ModelConfig, batch: int, seq: int, mode: str) -> Dict[str, float]:
    """Approximate FLOPs and memory bytes of one step.

    ``mode``: ``"prefill"`` (``seq`` tokens) or ``"decode"`` (one token
    against a cache of ``seq``).  2 FLOPs per active parameter per token
    plus the attention terms; bytes are the bf16 parameters plus the
    activations (prefill) or the cache (decode)."""
    n_act = cfg.n_active_params()
    p_bytes = n_act * 2  # bf16
    hd, H, KV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    L = cfg.num_layers
    if mode == "prefill":
        toks = batch * seq
        flops = 2.0 * n_act * toks
        if not cfg.is_attention_free:
            flops += 2.0 * 2.0 * L * H * hd * batch * seq * seq / 2  # causal attention
        bytes_ = p_bytes + toks * cfg.d_model * 2 * L
    else:  # decode
        toks = batch
        flops = 2.0 * n_act * toks
        cache_tokens = min(seq, cfg.sliding_window or seq)
        if cfg.family in ("ssm", "hybrid"):
            state = cfg.num_layers * cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_headdim
            cache_bytes = batch * state * 2
            flops += 4.0 * batch * state
        else:
            cache_bytes = batch * cache_tokens * KV * hd * 2 * L * 2
            flops += 2.0 * 2.0 * L * H * hd * batch * cache_tokens
        bytes_ = p_bytes + cache_bytes
    return {"flops": flops, "bytes": bytes_}


def request_latency_ms(
    cfg: ModelConfig,
    hw: HardwareClass,
    prompt_tokens: int = 128,
    gen_tokens: int = 32,
    batch: int = 1,
    efficiency: float = 0.5,
) -> float:
    """Roofline latency of one request: prefill plus ``gen_tokens`` decode
    steps, each the larger of its FLOP time and its byte time on ``hw``,
    divided by ``efficiency``."""
    pf = step_costs(cfg, batch, prompt_tokens, "prefill")
    t_pf = max(
        pf["flops"] / (hw.chips * hw.peak_flops),
        pf["bytes"] / (hw.chips * hw.hbm_bw),
    )
    dc = step_costs(cfg, batch, prompt_tokens + gen_tokens, "decode")
    t_dec = gen_tokens * max(
        dc["flops"] / (hw.chips * hw.peak_flops),
        dc["bytes"] / (hw.chips * hw.hbm_bw),
    )
    return 1000.0 * (t_pf + t_dec) / efficiency


def accuracy_proxy(n_params: int, a_max: float = 95.0, a_min: float = 35.0) -> float:
    """Scaling-law accuracy proxy: ~1M parameters -> ~``a_min``, ~100B ->
    ~``a_max`` (monotone, diminishing returns), calibrated so the small and
    large zoo variants reproduce the SqueezeNet/GoogleNet gap of the
    paper's testbed."""
    decades = max(math.log10(max(n_params, 1) / 1e6), 0.0)
    return a_max - (a_max - a_min) * math.exp(-0.9 * decades)
