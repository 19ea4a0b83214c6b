"""The port's continuous batching against the reference's, on the CPU: the
cases of ``tests/test_continuous.py``, port against reference on carried
weights, and the per-row decode step that carries it.

* ``ContinuousBatcher.run`` gives the reference's ``ContinuousBatcher.run``
  tokens exactly (and the reference test's claim, the tokens of each
  request generated alone, on the port): ``SQUEEZE_LM`` at 1 and 3 slots,
  the reference test's ssm config, a reduced hybrid (zamba2-1.2b), a
  reduced MoE (qwen2-moe-a2.7b) at 12 slots, more than the 8 choices an
  expert's global decode capacity holds, and an int8 dense config; each
  with ragged prompt lengths.
* Slot reuse and admission under a full pool, step by step against the
  reference; ``reset``; the encoder-decoder family's refusal (its prefill
  needs ``enc_embeds``, which a request does not carry: ``KeyError``, as
  the reference's ``admit`` raises).
* ``Model.decode_step`` with a (B,) ``cache.index`` equals B separate
  batch-1 steps, logits at ``rtol=atol=1e-3`` (``test_torch_model.TOL``)
  and greedy tokens exactly.  The plain attention sums in float32 in
  another order at B > 1 (with float64 weights the two agree to 1e-12 at
  B = 1 and differ by ~1e-6 at B = 3), and the reference's init gives
  attention sharp enough to amplify that: measured up to 1.6e-5 (dense)
  and 6.4e-4 (the reduced MoE) on logits of magnitude ~2: dense with a
  ring that wraps, int8, hybrid, and the MoE (each row routed alone; the
  global dispatch over the B rows would drop choices and differ).
* One ``decode_step`` a ``step()``, whatever the number of slots.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.continuous import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serving.continuous import Request as JRequest  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.models.model as model_module  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request, ServingEngine  # noqa: E402

#: per-row decode step against batch-1 steps, f32 logits
ROW_TOL = dict(rtol=1e-3, atol=1e-3)
#: the reduced MoE's rows in the per-row tests: 12, whose global decode
#: dispatch has capacity(12) = 8 slots an expert for 24 choices
MOE_ROWS = [5, 11, 3, 8, 6, 9, 4, 10, 7, 12, 5, 13]


def _configs(name):
    """(reference config, port config) of one tested configuration."""
    if name == "squeeze-lm":
        return JC.get_config(name), TC.get_config(name)
    if name == "ssm":  # tests/test_continuous.py::test_ssm_family_continuous
        kw = dict(family="ssm", num_layers=2, d_model=64, vocab_size=128, num_heads=1,
                  num_kv_heads=1, d_ff=0, ssm_state=16, ssm_headdim=32, ssd_chunk=8,
                  scan_layers=True)
        return JC.base.ModelConfig(**kw), TC.base.ModelConfig(**kw)
    if name == "int8":
        return (dataclasses.replace(JC.get_config("squeeze-lm"), kv_cache_dtype="int8"),
                dataclasses.replace(TC.get_config("squeeze-lm"), kv_cache_dtype="int8"))
    if name == "window":  # a ring of 8 that wraps
        return (dataclasses.replace(JC.get_config("squeeze-lm"), sliding_window=8),
                dataclasses.replace(TC.get_config("squeeze-lm"), sliding_window=8))
    arch = {"hybrid": "zamba2-1.2b", "moe": "qwen2-moe-a2.7b"}[name]
    return JC.reduce_for_smoke(JC.get_config(arch)), TC.reduce_for_smoke(TC.get_config(arch))


def _carried(name, seed):
    jcfg, tcfg = _configs(name)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(tcfg), params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                                      device="cpu")


def _prompts(vocab, n, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=lengths[i % len(lengths)]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("name,n_slots,n_req,gen,max_len", [
    ("squeeze-lm", 1, 5, 8, 64),
    ("squeeze-lm", 3, 5, 8, 64),
    ("ssm", 2, 3, 6, 32),
    ("hybrid", 2, 3, 6, 32),
    ("moe", 12, 14, 5, 32),
    ("int8", 3, 5, 8, 64),
])
def test_run_equals_reference(name, n_slots, n_req, gen, max_len):
    jm, jp, tm, tp = _carried(name, 0)
    prompts = _prompts(tm.cfg.vocab_size, n_req, (12, 7, 9), 0)
    want = JBatcher(jm, jp, n_slots=n_slots, max_len=max_len).run(
        [JRequest(i, p, gen) for i, p in enumerate(prompts)])
    got = ContinuousBatcher(tm, tp, n_slots=n_slots, max_len=max_len, device="cpu").run(
        [Request(i, p, gen) for i, p in enumerate(prompts)])
    assert got == {rid: [int(t) for t in toks] for rid, toks in want.items()}
    # the reference test's claim: each request as if generated alone
    eng = ServingEngine(tm, tp, device="cpu")
    for i, p in enumerate(prompts):
        alone = eng.generate({"tokens": torch.from_numpy(p)[None]}, max_new_tokens=gen,
                             max_len=max_len).tokens[0]
        assert got[i] == list(alone), f"request {i}"


def test_slot_reuse_and_admission():
    jm, jp, tm, tp = _carried("squeeze-lm", 1)
    jcb = JBatcher(jm, jp, n_slots=2, max_len=64)
    cb = ContinuousBatcher(tm, tp, n_slots=2, max_len=64, device="cpu")
    prompts = _prompts(512, 5, (8,), 1)
    jreqs = [JRequest(i, p, 4) for i, p in enumerate(prompts)]
    reqs = [Request(i, p, 4) for i, p in enumerate(prompts)]
    for both in ((jcb, jreqs), (cb, reqs)):
        b, rs = both
        assert b.admit(rs[0]) and b.admit(rs[1])
        assert not b.admit(rs[2])  # pool full
        for _ in range(4):
            b.step()
        assert len(b.free_slots()) == 2  # both finished and vacated
        assert b.admit(rs[2])  # reused slot
    out, jout = cb.run(reqs[3:]), jcb.run(jreqs[3:])
    assert set(out) >= {3, 4}
    assert out == {rid: [int(t) for t in toks] for rid, toks in jout.items()}
    assert [r.generated for r in reqs[:3]] == [[int(t) for t in r.generated] for r in jreqs[:3]]


def test_reset_clears_every_slot():
    _, _, tm, tp = _carried("int8", 2)
    cb = ContinuousBatcher(tm, tp, n_slots=3, max_len=32, device="cpu")
    prompts = _prompts(512, 4, (9, 5), 2)
    first = cb.run([Request(i, p, 6) for i, p in enumerate(prompts)])
    assert cb.admit(Request(9, prompts[0], 6))
    cb.reset()
    assert cb.free_slots() == [0, 1, 2] and cb.active() == []
    assert cb._cache.index.tolist() == [0, 0, 0]
    assert all(int(t.abs().sum()) == 0 for t in cb._cache.attn.values())
    assert cb.run([Request(i, p, 6) for i, p in enumerate(prompts)]) == first


def test_encdec_admit_raises_as_the_reference():
    jm, jp, tm, tp = _carried("squeeze-lm", 3)
    jcfg = JC.reduce_for_smoke(JC.get_config("seamless-m4t-medium"))
    tcfg = TC.reduce_for_smoke(TC.get_config("seamless-m4t-medium"))
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_reference(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    prompt = _prompts(tcfg.vocab_size, 1, (6,), 3)[0]
    with pytest.raises(KeyError, match="enc_embeds"):
        JBatcher(jm, jp, n_slots=2, max_len=16).admit(JRequest(0, prompt, 4))
    cb = ContinuousBatcher(tm, tp, n_slots=2, max_len=16, device="cpu")
    with pytest.raises(KeyError, match="enc_embeds"):
        cb.admit(Request(0, prompt, 4))
    assert cb.free_slots() == [0, 1]


def test_batcher_refuses_parameters_on_another_device():
    _, _, tm, tp = _carried("squeeze-lm", 4)
    with pytest.raises(ValueError, match="the batcher on"):
        ContinuousBatcher(tm, tp, device=torch.device("meta"))


def test_one_decode_step_per_step(monkeypatch):
    _, _, tm, tp = _carried("squeeze-lm", 5)
    calls = []
    real = tm.decode_step
    monkeypatch.setattr(tm, "decode_step", lambda *a: calls.append(a[1].shape) or real(*a))
    cb = ContinuousBatcher(tm, tp, n_slots=4, max_len=32, device="cpu")
    for i, p in enumerate(_prompts(512, 3, (5, 6, 7), 5)):
        cb.admit(Request(i, p, 10))
    cb.step()
    cb.step()
    assert calls == [(4, 1), (4, 1)]


def _per_row_against_batch_one(tm, tp, lengths, steps, seed):
    """Prefill each row alone, stack the caches, decode ``steps`` tokens
    with a (B,) index, and hold each step against every row's own batch-1
    step."""
    B, max_len = len(lengths), max(lengths) + steps + 1
    prompts = _prompts(tm.cfg.vocab_size, B, lengths, seed)
    ones, toks = [], []
    for p in prompts:
        c = tm.init_cache(1, max_len, device="cpu")
        logits, c = tm.prefill(tp, {"tokens": torch.from_numpy(p)[None]}, c)
        ones.append(c)
        toks.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
    rows = tm.init_cache(B, max_len, device="cpu")
    for b, c in enumerate(ones):
        for name in rows.attn or {}:
            rows.attn[name][:, b] = c.attn[name][:, 0]
        for name in ("conv", "ssm"):
            if getattr(rows, name) is not None:
                getattr(rows, name)[:, b] = getattr(c, name)[:, 0]
    rows.index = torch.tensor(lengths)
    tok = torch.cat(toks)
    for step in range(steps):
        got, rows = tm.decode_step(tp, tok, rows)
        want = []
        for b in range(B):
            lb, ones[b] = tm.decode_step(tp, tok[b:b + 1], ones[b])
            want.append(lb)
        want = torch.cat(want)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **ROW_TOL, err_msg=f"step {step}")
        assert torch.equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1))
        assert rows.index.tolist() == [n + step + 1 for n in lengths]
        tok = got[:, -1].argmax(-1).to(torch.int32)[:, None]
    return got


@pytest.mark.parametrize("name", ["window", "int8", "hybrid", "moe"])
def test_per_row_index_equals_batch_one_steps(name):
    _, _, tm, tp = _carried(name, 6)
    lengths = MOE_ROWS if name == "moe" else [5, 11, 3]
    _per_row_against_batch_one(tm, tp, lengths, 12 if name == "window" else 4, 6)


def test_per_row_moe_routes_each_row_alone(monkeypatch):
    """With every router zeroed, each token's top-2 is experts 0 and 1 (a
    tie, to the lower experts): each row alone keeps both choices
    (capacity(1) = 8), and the per-row step must equal the batch-1 steps.
    The global dispatch over the 12 rows (capacity(12) = 8) would drop 4
    choices of each of experts 0 and 1, and the step would differ: the
    per-row tests have teeth."""
    _, _, tm, tp = _carried("moe", 7)
    for lp in tp["layers"]:
        lp["moe"]["router"].zero_()
    _per_row_against_batch_one(tm, tp, MOE_ROWS, 3, 7)
    real = model_module.apply_moe
    monkeypatch.setattr(model_module, "apply_moe",
                        lambda p, x, cfg, grouped=None: real(p, x, cfg))
    with pytest.raises(AssertionError):
        _per_row_against_batch_one(tm, tp, MOE_ROWS, 3, 7)
