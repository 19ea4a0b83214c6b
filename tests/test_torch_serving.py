"""The port's serving path against the reference's, on the CPU.

* ``make_batch`` gives the reference's tokens for the same seed.
* ``ServingEngine.generate`` gives the reference's greedy tokens on carried
  weights (``reduce_for_smoke(yi-9b)`` with GQA rep 2, ``squeeze-lm``, and
  the reduced ``mamba2-130m`` and ``zamba2-1.2b``), and its next-token
  accuracy equals the reference's.
* Greedy generation equals argmax decoding by full re-forward, and the
  sliding-window ring cache wraps (the analogs of ``tests/test_serving.py``).
* ``serve(..., device="cpu")`` runs end to end.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.training import make_batch as j_make_batch  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.serving import GenerationResult, ServingEngine  # noqa: E402
from repro_torch.training import make_batch  # noqa: E402

DENSE = TC.ModelConfig(family="dense", num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=128, vocab_size=256, scan_layers=False)


@pytest.mark.parametrize("arch,batch,seq,seed", [("yi-9b", 3, 40, 0), ("squeeze-lm", 2, 17, 5)])
def test_make_batch_equals_reference(arch, batch, seq, seed):
    ref, port = JC.get_config(arch), TC.get_config(arch)
    want = j_make_batch(ref, batch, seq, np.random.default_rng(seed))
    got = make_batch(port, batch, seq, np.random.default_rng(seed), device="cpu")
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def _configs(arch):
    ref, port = JC.get_config(arch), TC.get_config(arch)
    if arch == "yi-9b":
        ref = dataclasses.replace(JC.reduce_for_smoke(ref), num_kv_heads=2)
        port = dataclasses.replace(TC.reduce_for_smoke(port), num_kv_heads=2)
    elif ref.family in ("ssm", "hybrid"):
        # 4 layers: the hybrid's shared block fires at layers 0 and 2
        ref = dataclasses.replace(JC.reduce_for_smoke(ref), num_layers=4)
        port = dataclasses.replace(TC.reduce_for_smoke(port), num_layers=4)
    return ref, port


@pytest.mark.parametrize("arch", ["yi-9b", "squeeze-lm", "mamba2-130m", "zamba2-1.2b"])
def test_generate_equals_reference_on_carried_weights(arch):
    ref, port = _configs(arch)
    jm = JModel(ref)
    jparams = jm.init(jax.random.PRNGKey(7))
    params = params_from_reference(port, jax.tree.map(np.asarray, jparams), device="cpu")
    jb = j_make_batch(ref, 2, 14, np.random.default_rng(3))
    b = make_batch(port, 2, 14, np.random.default_rng(3), device="cpu")
    want = JEngine(jm, jparams).generate(jb, max_new_tokens=6)
    eng = ServingEngine(Model(port), params, device="cpu")
    got = eng.generate(b, max_new_tokens=6)
    assert isinstance(got, GenerationResult) and got.tokens.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prefill_ms > 0 and got.total_ms >= got.prefill_ms
    assert eng.eval_next_token_accuracy(b) == JEngine(jm, jparams).eval_next_token_accuracy(jb)


def test_generate_matches_stepwise_forward():
    """Greedy generation must equal argmax decoding via full re-forward."""
    model = Model(DENSE)
    params = model.init(1, device="cpu")
    eng = ServingEngine(model, params, device="cpu")
    b = make_batch(DENSE, 1, 12, np.random.default_rng(1), device="cpu")
    out = eng.generate(b, max_new_tokens=4)
    cur = b["tokens"]
    for t in range(4):
        logits, _ = model.forward(params, {"tokens": cur})
        nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        assert (nxt[:, 0].numpy() == out.tokens[:, t]).all(), f"step {t}"
        cur = torch.cat([cur, nxt], dim=1)


def test_generate_is_deterministic():
    model = Model(DENSE)
    eng = ServingEngine(model, model.init(0, device="cpu"), device="cpu")
    b = make_batch(DENSE, 2, 16, np.random.default_rng(0), device="cpu")
    np.testing.assert_array_equal(eng.generate(b, max_new_tokens=6).tokens,
                                  eng.generate(b, max_new_tokens=6).tokens)


def test_sliding_window_ring_cache_wraps():
    cfg = dataclasses.replace(DENSE, sliding_window=8)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    b = make_batch(cfg, 1, 24, np.random.default_rng(2), device="cpu")
    # decode 20 tokens past a 24-token prefill: the cache wraps 5+ times
    cache = model.init_cache(1, 64, device="cpu")
    assert cache.attn["k"].shape[2] == 8  # ring limited to the window
    logits, cache = model.prefill(params, b, cache)
    for _ in range(20):
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        logits, cache = model.decode_step(params, tok, cache)
    assert cache.index == 44
    assert torch.isfinite(logits).all()


def test_serve_runs_on_the_cpu(capsys):
    res = serve("mid-lm", batch=2, prompt=9, gen=3, seed=1, device="cpu")
    assert res.tokens.shape == (2, 3) and (res.tokens >= 0).all() and (res.tokens < 512).all()
    assert "mid-lm: batch=2 prompt=9 gen=3" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_serve_runs_the_ssm_families_on_the_cpu(arch, capsys):
    res = serve(arch, batch=2, prompt=37, gen=3, seed=2, device="cpu")
    assert res.tokens.shape == (2, 3) and (res.tokens >= 0).all() and (res.tokens < 512).all()
    assert f"{arch}: batch=2 prompt=37 gen=3" in capsys.readouterr().out
