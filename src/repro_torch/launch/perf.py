"""Perf-iteration harness: run one (arch x shape) dry-run under a NAMED
variant (a sharding-rule override and/or a config tweak), print the three
roofline terms and save the report.

The port's counterpart of ``repro/launch/perf.py``, with its
:data:`VARIANTS`; each encodes one hypothesis about the sharded steps.  The
counts are those of ``launch/dryrun.py`` (one rank of a fake production
mesh, the plain attention and SSD paths, the H100's rates).  Runs in a
process of its own, as the dry-run does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch yi-9b --shape decode_32k \\
      --variant kvseq_model
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from ..configs import ARCH_IDS
from ..configs.base import ModelConfig
from ..sharding import DEFAULT_RULES
from .dryrun import lower_one
from .specs import SHAPES

# ---------------------------------------------------------------------------
# experiment variants: name -> dict(rules=..., cfg_patch=..., note=...)
# ---------------------------------------------------------------------------

VARIANTS = {
    "baseline": dict(rules=None, cfg_patch={}, note="paper-faithful baseline"),
    # decode: shard the KV cache's sequence axis over `model` when kv_heads
    # cannot be sharded (GQA kv < mesh)
    "kvseq_model": dict(
        rules={"kv_seq": "model"},
        cfg_patch={},
        note="decode KV cache sharded over model on the sequence axis",
    ),
    # long-context decode (batch=1): the data axis is idle; shard the cache
    # sequence over both axes
    "kvseq_2d": dict(
        rules={"kv_seq": ("data", "model")},
        cfg_patch={},
        note="cache seq sharded over data+model (256-way context parallel)",
    ),
    # ssm: 24 heads cannot shard a 16-way axis; shard the head channels
    "ssm_headdim_model": dict(
        rules={"ssm_headdim": "model", "ssm_heads": None},
        cfg_patch={},
        note="shard SSD head channels instead of (non-dividing) heads",
    ),
    "kvseq_int8": dict(
        rules={"kv_seq": "model"},
        cfg_patch={"kv_cache_dtype": "int8"},
        note="kv_seq sharding + int8 KV cache",
    ),
    "kvseq_localtopk": dict(
        rules={"kv_seq": "model"},
        cfg_patch={"local_argmax": True},
        note="kv_seq sharding + distributed argmax (no logits all-gather)",
    ),
    "attn_chunked": dict(
        rules=None, cfg_patch={"attn_impl": "chunked"},
        note="chunked flash-style attention, causal k-slicing",
    ),
    "attn_chunked_kvseq": dict(
        rules={"kv_seq": "model"}, cfg_patch={"attn_impl": "chunked"},
        note="chunked attention + kv_seq sharding",
    ),
    "remat_on": dict(rules=None, cfg_patch={"remat": True}, note="remat scanned block"),
    "remat_off": dict(rules=None, cfg_patch={"remat": False}, note="no remat"),
    "moe_capacity_sharded": dict(
        rules={"capacity": "model", "experts": None},
        cfg_patch={"attn_impl": "chunked"},
        note="expert activations sharded on capacity (experts replicated)",
    ),
    "moe_small_dispatch": dict(
        rules=None,
        cfg_patch={"moe_dispatch_dtype": "int16"},
        note="MoE dispatch one-hot/cumsum in int16 instead of int32",
    ),
    "moe_cf1": dict(rules=None, cfg_patch={"capacity_factor": 1.0}, note="capacity factor 1.0"),
    "moe_best": dict(
        rules=None,
        cfg_patch={"attn_impl": "chunked", "capacity_factor": 1.0},
        note="chunked attention + capacity 1.0",
    ),
    "attn_chunked_noremat": dict(
        rules=None, cfg_patch={"attn_impl": "chunked", "remat": False},
        note="chunked attention, remat off (bytes vs residency trade)",
    ),
    "attn_chunked_remat_dots": dict(
        rules=None, cfg_patch={"attn_impl": "chunked", "remat_policy": "dots"},
        note="chunked attention + dots-saveable remat policy",
    ),
    "serve_with_train_rules": dict(
        rules={"embed": "data"}, cfg_patch={}, note="FSDP rules in decode (ablation)"
    ),
}


def run_variant(arch: str, shape: str, variant: str, out_dir: str = "reports/perf",
                reduce: bool = False):
    """One dry-run under ``variant``: the :class:`~repro_torch.roofline.
    RooflineReport`, saved under ``out_dir``.  ``cfg_patch`` entries that
    are ``ModelConfig`` fields patch the config; the others are the
    module-level switches ``serving.engine.LOCAL_ARGMAX`` and
    ``models.moe.DISPATCH_DTYPE``, set for the run and put back after."""
    import repro_torch.models.moe as moe_mod
    import repro_torch.serving.engine as eng_mod

    spec = VARIANTS[variant]
    rules = dict(DEFAULT_RULES, **spec["rules"]) if spec["rules"] else None
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg_fields = {k: v for k, v in spec["cfg_patch"].items() if k in fields}
    flags = {k: v for k, v in spec["cfg_patch"].items() if k not in fields}

    old = (moe_mod.DISPATCH_DTYPE, eng_mod.LOCAL_ARGMAX)
    moe_mod.DISPATCH_DTYPE = flags.get("moe_dispatch_dtype", old[0])
    eng_mod.LOCAL_ARGMAX = bool(flags.get("local_argmax", old[1]))
    try:
        t0 = time.time()
        _, report = lower_one(arch, shape, rules=rules, cfg_patch=cfg_fields or None,
                              reduce=reduce)
        dt = time.time() - t0
    finally:
        moe_mod.DISPATCH_DTYPE, eng_mod.LOCAL_ARGMAX = old

    os.makedirs(out_dir, exist_ok=True)
    report.save(os.path.join(out_dir, f"{arch}__{shape}__{variant}.json"))
    print(f"[{variant:24s} {dt:6.1f}s] {report.row()}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--variant", choices=list(VARIANTS), action="append", required=True)
    ap.add_argument("--out", default="reports/perf")
    ap.add_argument("--reduce", action="store_true",
                    help="run reduce_for_smoke of the config (a quick check)")
    args = ap.parse_args(argv)
    for v in args.variant:
        run_variant(args.arch, args.shape, v, args.out, reduce=args.reduce)
    return 0


if __name__ == "__main__":
    sys.exit(main())
