"""Shared pieces of the benchmark's own tests.

    PYTHONPATH=src python -m pytest -q bench/tests

runs them on the CPU (the tests marked ``gpu`` skip there); on a card,
``-m gpu`` runs the control check at a cell's own size.  The small
configurations below keep every kind of layer of the benchmark's
configurations at widths the CPU runs in seconds.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the settings both small configurations share with the benchmark's
_COMMON = dict(norm="rmsnorm", norm_eps=1e-5, gated_mlp=True, rope_theta=10000.0,
               rotary_pct=1.0, qkv_bias=False, attn_out_bias=False, mlp_bias=False,
               tie_embeddings=False, sliding_window=None, logits_softcap=0.0,
               kv_cache_dtype="auto")

SMALL = {
    "dense": dict(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=96, vocab_size=256, activation="silu", **_COMMON),
    "ssm": dict(_COMMON, family="ssm", num_layers=3, d_model=64, vocab_size=256,
                tie_embeddings=True, ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_ngroups=1,
                ssm_conv=4, ssd_chunk=32),
}
#: the benchmark cell whose output limit a small model of each family takes
CELL = {"dense": "yi-9b.prefill-mix", "ssm": "mamba2-130m.prefill-mix-b32"}


def stated_widths(c: dict) -> dict:
    """The widths configuration ``c`` states, by its family's ``WIDTHS``
    (``bench/families/<family>.py``); raises where it leaves one out."""
    from bench.harness.manifest import family

    return {k: c[k] for k in family(c).model.WIDTHS}


def small_config(family: str, dtype: str = "float32") -> dict:
    """A configuration file's dict of a small model of ``family``."""
    return dict(SMALL[family], name=f"small-{family}", arch=None, context_length=512,
                dtype=dtype, param_dtype=dtype)


def program_config(c: dict):
    """The program's configuration of a small configuration's dict."""
    from repro_torch.configs import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in c.items() if k in fields}, scan_layers=False)


def small_spec(family: str, dtype: str = "float32", *, batch=2, lengths=(40, 70),
               per_cycle=(1, 1), new_tokens=1, requests=3, rest="any", limit=None) -> dict:
    """A cell of the small configuration of ``family`` in the form of
    ``manifest.find_cell``, checked at the limit of the family's benchmark
    cell (:data:`CELL`) unless ``limit`` is given."""
    import json

    bench_cell = json.loads((ROOT / "bench" / "cells" / f"{CELL[family]}.json").read_text())
    check = {"requests": requests, "rest": rest,
             "max_logit_gap": bench_cell["check"]["max_logit_gap"] if limit is None else limit}
    return {
        "name": f"small-{family}", "chips": 1,
        "cell": {"config": f"small-{family}", "traffic": "small", "chips": 1, "why": "a test",
                 "check": check},
        "config": small_config(family, dtype),
        "traffic": {"batch": batch, "lengths": list(lengths), "per_cycle": list(per_cycle),
                    "new_tokens": new_tokens, "trace_seconds": 1},
    }


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at a cell's own size on the card")
    return torch.device("cuda")
