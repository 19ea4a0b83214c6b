"""The ``zamba2`` family's benchmark files on the CPU: its layout equals the
program's parameters, its counted sizes equal what the built model holds
and launches, the configuration file is the program's configuration key
for key, and a whole run of a small zamba2 cell through ``run_cell`` is
correct, and incorrect with a served token altered."""
from __future__ import annotations

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

from bench.harness import manifest  # noqa: E402
from bench.harness.cell import program_config, run_cell  # noqa: E402
from bench.harness.manifest import BENCH, cell_metrics, find_cell, load_manifest  # noqa: E402
from bench.harness.weights import layout, leaves  # noqa: E402

CELL = "zamba2-7b.prefill-mix"
SEED = 2**33 + 23


def _small():
    from repro_torch.configs import Zamba2Config

    cfg = Zamba2Config(
        arch_id="zamba2-small", num_layers=5, d_model=32, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=48, vocab_size=64, tie_embeddings=True, ssm_state=8, ssm_headdim=8,
        ssm_expand=2, ssm_ngroups=2, ssm_conv=4, ssd_chunk=8, shared_sites=(1, 3, 4),
        num_mem_blocks=2, adapter_rank=4, scan_layers=False)
    return cfg, dict(dataclasses.asdict(cfg), name="zamba2-small", context_length=512)


def test_layout_is_the_programs_parameters():
    from repro_torch.models import Model

    cfg, c = _small()
    want = {p: tuple(t.shape) for p, t in leaves(Model(cfg).abstract_params())}
    assert {p: leaf.shape for p, leaf in leaves(layout(c))} == want
    full = json.loads((BENCH / "configs" / "zamba2-7b.json").read_text())
    want = {p: tuple(t.shape) for p, t in leaves(Model(program_config(full)).abstract_params())}
    assert {p: leaf.shape for p, leaf in leaves(layout(full))} == want


def test_counted_sizes_are_the_built_models():
    from repro_torch.models import Model
    from repro_torch.obs import counters

    cfg, c = _small()
    fam = manifest.family(c).model
    params = Model(cfg).abstract_params()
    per_layer = sum(math.prod(lp["mamba"][k].shape) for lp in params["layers"]
                    for k in ("in_proj", "out_proj"))
    per_site = 0
    for j in range(len(cfg.shared_sites)):
        blk = params["shared_blocks"][cfg.block_of(j)]
        per_site += sum(math.prod(t.shape) for k in ("attn", "mlp") for t in blk[k].values())
        per_site += sum(math.prod(t.shape) for t in params["sites"][j].values())
    assert fam.matmul_weights(c) == per_layer + per_site
    w = Model(cfg).init(0, device="cpu")
    before = counters.snapshot()
    with torch.no_grad():
        Model(cfg).prefill(w, {"tokens": torch.zeros(2, 9, dtype=torch.long)},
                           Model(cfg).init_cache(2, 10, device="cpu"))
    got = counters.delta(before)
    sites, H, KV, hd = fam.attention(c)
    assert (sites, H, KV, hd) == (got["kernel.launches.flash_attention.plain"], 4, 4, 16)
    assert fam.ssd_blocks(c) == got["kernel.launches.ssd.plain"] == 5
    full = find_cell(load_manifest(), CELL)["config"]
    assert fam.attention(full) == (13, 32, 32, 224) and fam.ssd_blocks(full) == 81


def test_the_cell_is_found_and_reports_its_metrics():
    spec = find_cell(load_manifest(), CELL)
    assert spec["config"]["family"] == "zamba2" and spec["chips"] == 1
    names = {m["name"] for m in cell_metrics(load_manifest(), CELL)["per_layer"]}
    assert {"shared_block_ns_per_tok.prefill", "flash_roofline.prefill", "ssd_roofline.prefill",
            "mfu.prefill", "gated_norm_ns_per_tok.prefill"} <= names


def _spec():
    """The cell at the small size, in float32: its sample rule, and a limit
    for the small model in float32 (the full model's is set for bf16),
    far above its rounding (a gap of 0 at this seed) and far below an
    altered token's gap (0.38)."""
    cfg, c = _small()
    spec = {"name": "zamba2-small", "chips": 1,
            "cell": {"config": "zamba2-small", "traffic": "small", "chips": 1, "why": "a test",
                     "check": dict(find_cell(load_manifest(), CELL)["cell"]["check"],
                                   requests=4, max_logit_gap=1e-3)},
            "config": c,
            "traffic": {"batch": 2, "lengths": [12, 30], "per_cycle": [1, 1], "new_tokens": 1,
                        "trace_seconds": 1}}
    return cfg, spec


def test_a_small_cell_runs_correct_and_an_altered_token_fails():
    import repro_torch.serving.engine as eng

    cfg, spec = _spec()
    metrics = cell_metrics(load_manifest(), CELL)
    kw = dict(program_cfg=cfg, log=lambda *a, **k: None, batches=2)
    sound = run_cell(spec, metrics, SEED, 0.0, False, "cpu", **kw)
    assert sound["correct"] and sound["check"]["gap"] < 1e-5
    greedy = eng._greedy
    eng._greedy = lambda logits: (greedy(logits) + 1) % logits.shape[-1]
    try:
        assert not run_cell(spec, metrics, SEED, 0.0, False, "cpu", **kw)["correct"]
    finally:
        eng._greedy = greedy
