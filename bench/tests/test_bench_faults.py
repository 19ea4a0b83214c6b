"""A whole run of a cell, with the look for a chip skipped, on a small model
on the CPU: sound, ``correct`` is true; with the timed path broken
underneath, ``correct`` comes out false, once for each fault that a
prefill cell (one greedy token a prompt) can have.

  - a served token altered where it is produced (the engine's greedy pick);
  - half of each batch left out (the prefill serves the first half's rows,
    the rest get nothing computed);
  - a step that returns its state unchanged: the first block of the model
    hands its input on as its output.

No exchange between chips exists in a one-chip cell, and no decode step
runs when each prompt is served one token.  The limit is that of the
benchmark cell of the model's family (``conftest.CELL``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from conftest import CELL, program_config, small_spec  # noqa: E402

from bench.harness.cell import run_cell  # noqa: E402
from bench.harness.manifest import cell_metrics, load_manifest  # noqa: E402

SEED = 2**33 + 17
FAMILIES = ["dense", "ssm"]


def _run(family):
    spec = small_spec(family, lengths=(40, 70), per_cycle=(1, 1), requests=8)
    metrics = cell_metrics(load_manifest(), CELL[family])
    return run_cell(spec, metrics, SEED, 0.3, False, "cpu",
                    program_cfg=program_config(spec["config"]), log=lambda *a, **k: None)


@contextlib.contextmanager
def _altered_tokens():
    import repro_torch.serving.engine as eng

    greedy = eng._greedy

    def altered(logits):
        return (greedy(logits) + 1) % logits.shape[-1]

    eng._greedy = altered
    try:
        yield
    finally:
        eng._greedy = greedy


@contextlib.contextmanager
def _half_batch():
    from repro_torch.models import Model

    prefill = Model.prefill

    def half(self, params, batch, cache):
        B = batch["tokens"].shape[0]
        sub = dataclasses.replace(cache, attn=None if cache.attn is None else
                                  {k: v[:, :B // 2] for k, v in cache.attn.items()},
                                  conv=None if cache.conv is None else cache.conv[:, :B // 2],
                                  ssm=None if cache.ssm is None else cache.ssm[:, :B // 2])
        logits, _ = prefill(self, params, {"tokens": batch["tokens"][:B // 2]}, sub)
        out = torch.zeros((B,) + logits.shape[1:], dtype=logits.dtype)
        out[:B // 2] = logits
        return out, dataclasses.replace(cache, index=batch["tokens"].shape[1])

    Model.prefill = half
    try:
        yield
    finally:
        Model.prefill = prefill


@contextlib.contextmanager
def _first_block_skipped():
    import repro_torch.models.model as model_mod
    from repro_torch.models import Model

    dense, mamba = Model._dense_block, model_mod.apply_mamba
    first = []

    def is_first(p):
        if not first:
            first.append(p)
        return p is first[0]

    def dense_skipped(self, p, h, positions, **kw):
        out = dense(self, p, h, positions, **kw)
        return (h,) + tuple(out[1:]) if is_first(p) else out

    def mamba_skipped(p, x, cfg, *a, **kw):
        out = mamba(p, x, cfg, *a, **kw)
        if not is_first(p):
            return out
        return (torch.zeros_like(out[0]), out[1]) if isinstance(out, tuple) else 0 * out

    Model._dense_block, model_mod.apply_mamba = dense_skipped, mamba_skipped
    try:
        yield
    finally:
        Model._dense_block, model_mod.apply_mamba = dense, mamba


@pytest.mark.parametrize("family", FAMILIES)
def test_a_sound_run_is_correct(family):
    r = _run(family)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"


FAULTS = [("altered", _altered_tokens), ("half_batch", _half_batch),
          ("first_block_skipped", _first_block_skipped)]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name,fault", FAULTS, ids=[f[0] for f in FAULTS])
def test_a_fault_makes_the_run_incorrect(family, name, fault):
    with fault():
        r = _run(family)
    gap = r["compared"]["widest_logit_gap"]
    assert not r["correct"], (name, gap)
    assert gap["value"] > gap["limit"]
