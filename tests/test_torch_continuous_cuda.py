"""The int8 KV cache, chunked attention and continuous batching on the card
against the CPU.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_continuous_cuda.py

* The decode kernel over a dequantized int8 ring (a fresh tensor, read as
  a transposed view) with rows of different validity, f32 and bf16,
  against its plain version at the attention tolerances (f32
  ``rtol=2e-4, atol=2e-5``, bf16 ``rtol=atol=2e-2``); flash at B = 1 and
  ragged S on both routes likewise, its route counted.
* Small f32 models (q/k/v at a fan-in of d_model, so that attention is not
  sharp enough to amplify rounding): the batcher on the card gives the
  CPU's tokens (dense, int8 dense, hybrid, MoE at 12 slots), with one
  ``decode_step`` a step (decode launched once a layer a step) and flash
  once a layer an admit; the per-row decode step equals batch-1 steps on
  the card (logits ``rtol=atol=1e-3``); int8 prefill and decode logits at
  ``rtol=atol=1e-3`` of the CPU's.
* Chunked attention on the card: a causal prefill still launches flash; the
  encoder-decoder's chunked bidirectional encoder equals the unchunked one
  (``rtol=atol=1e-3``) and launches no kernel for it; a chunked train step
  takes the plain route (no launch) and its loss (``rtol=1e-5``) and
  gradients (``tests/test_attn_impl.py``'s ``rtol=5e-3, atol=1e-4``)
  equal the CPU's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    flash_route,
)
from repro_torch.models import Model, params_to  # noqa: E402
from repro_torch.models.quant import dequantize_kv, quantize_kv  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.training import make_batch, make_loss_fn  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_unflatten  # noqa: E402

pytestmark = pytest.mark.gpu

ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_over_a_dequantized_ring_with_per_row_validity(cuda, dtype):
    B, W, KV, rep, hd = 8, 300, 4, 8, 128
    ring_k, ks = quantize_kv(_randn((B, W, KV, hd), "float32", 1, cuda))
    ring_v, vs = quantize_kv(_randn((B, W, KV, hd), "float32", 2, cuda))
    k = dequantize_kv(ring_k, ks, getattr(torch, dtype)).transpose(1, 2)
    v = dequantize_kv(ring_v, vs, getattr(torch, dtype)).transpose(1, 2)
    q = _randn((B, KV, rep, hd), dtype, 3, cuda)
    lengths = torch.tensor([1, 7, 64, 65, 130, 200, 299, 300], device=cuda)
    valid = torch.arange(W, device=cuda)[None] < lengths[:, None]
    before = counters.snapshot()
    got = decode_attention(q, k, v, valid, backend="cuda")
    assert counters.launches("decode_attention", before) == 1
    torch.testing.assert_close(got.float(), decode_attention_ref(q, k, v, valid).float(),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("S", [77, 200, 1000])
@pytest.mark.parametrize("dtype,hd", [("bfloat16", 128), ("bfloat16", 64), ("float32", 128)])
def test_flash_at_batch_one_ragged(cuda, S, dtype, hd):
    H, KV = 32, 4
    q = _randn((1, S, H, hd), dtype, 4, cuda).transpose(1, 2)
    k = _randn((1, S, KV, hd), dtype, 5, cuda).transpose(1, 2)
    v = _randn((1, S, KV, hd), dtype, 6, cuda).transpose(1, 2)
    route = flash_route(q.dtype, hd)
    before = counters.snapshot()
    got = flash_attention(q, k, v, backend="cuda")
    assert counters.launches("flash_attention", before, route) == 1
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v).float(),
                               **ATTN_TOL[dtype])


def _small(name):
    if name == "dense":
        return dataclasses.replace(TC.reduce_for_smoke(TC.get_config("yi-9b")), num_kv_heads=2)
    if name == "int8":
        return dataclasses.replace(_small("dense"), kv_cache_dtype="int8")
    arch = {"hybrid": "zamba2-1.2b", "moe": "qwen2-moe-a2.7b"}[name]
    return TC.reduce_for_smoke(TC.get_config(arch))


def _params(model, seed=0):
    """CPU parameters with q/k/v at a fan-in of d_model."""
    cfg = model.cfg
    params = model.init(seed, device="cpu")
    blocks = [lp["attn"] for lp in params["layers"] if "attn" in lp]
    if "shared_attn" in params:
        blocks.append(params["shared_attn"]["attn"])
    for attn in blocks:
        for w, fan_in in (("w_q", cfg.num_heads), ("w_k", cfg.num_kv_heads),
                          ("w_v", cfg.num_kv_heads)):
            attn[w].mul_(math.sqrt(fan_in / cfg.d_model))
    return params


@pytest.mark.parametrize("name,n_slots", [("dense", 3), ("int8", 3), ("hybrid", 2), ("moe", 12)])
def test_batcher_on_the_card_equals_the_cpu(cuda, name, n_slots):
    model = Model(_small(name))
    cpu = _params(model)
    card = params_to(cpu, cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).astype(np.int32)
               for n in (13, 70, 9, 33, 21) * 3][:n_slots + 2]
    want = ContinuousBatcher(model, cpu, n_slots=n_slots, max_len=96, device="cpu").run(
        [Request(i, p, 6) for i, p in enumerate(prompts)])
    cb = ContinuousBatcher(model, card, n_slots=n_slots, max_len=96, device=cuda)
    n0 = counters.snapshot()
    for i, p in enumerate(prompts[:n_slots]):
        assert cb.admit(Request(i, p, 6))
    sites = model.n_attn_sites()
    assert counters.launches("flash_attention", n0) == n_slots * sites
    cb.step()
    assert counters.launches("decode_attention", n0) == sites  # one decode_step for every slot
    cb.reset()
    got = cb.run([Request(i, p, 6) for i, p in enumerate(prompts)])
    assert got == want


@pytest.mark.parametrize("name", ["dense", "int8", "moe"])
def test_per_row_step_on_the_card_equals_batch_one_steps(cuda, name):
    model = Model(_small(name))
    card = params_to(_params(model, 2), cuda)
    lengths = [5, 40, 17, 9]
    rng = np.random.default_rng(2)
    ones, toks = [], []
    rows = model.init_cache(len(lengths), 64, device=cuda)
    with torch.no_grad():
        for b, n in enumerate(lengths):
            p = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, n).astype(np.int32))
            c = model.init_cache(1, 64, device=cuda)
            logits, c = model.prefill(card, {"tokens": p[None].to(cuda)}, c)
            for key in rows.attn:
                rows.attn[key][:, b] = c.attn[key][:, 0]
            ones.append(c)
            toks.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
        rows.index = torch.tensor(lengths, device=cuda)
        tok = torch.cat(toks)
        for step in range(4):
            got, rows = model.decode_step(card, tok, rows)
            want = []
            for b in range(len(lengths)):
                lb, ones[b] = model.decode_step(card, tok[b:b + 1], ones[b])
                want.append(lb)
            want = torch.cat(want)
            torch.testing.assert_close(got, want, **MODEL_TOL, msg=f"step {step}")
            tok = got[:, -1].argmax(-1).to(torch.int32)[:, None]


def test_int8_prefill_and_decode_on_the_card_equal_the_cpu(cuda):
    model = Model(_small("int8"))
    cpu = _params(model, 3)
    card = params_to(cpu, cuda)
    batch = make_batch(model.cfg, 2, 40, np.random.default_rng(3), device="cpu")
    cc = model.init_cache(2, 48, device="cpu")
    cg = model.init_cache(2, 48, device=cuda)
    with torch.no_grad():
        lc, cc = model.prefill(cpu, batch, cc)
        lg, cg = model.prefill(card, {k: t.to(cuda) for k, t in batch.items()}, cg)
        torch.testing.assert_close(lg.cpu(), lc, **MODEL_TOL)
        for _ in range(6):
            tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
            lc, cc = model.decode_step(cpu, tok, cc)
            lg, cg = model.decode_step(card, tok.to(cuda), cg)
            torch.testing.assert_close(lg.cpu(), lc, **MODEL_TOL)
    off = cg.attn["k"].cpu().int() - cc.attn["k"].int()
    assert int(off.abs().max()) <= 1 and int(off.count_nonzero()) <= 1e-3 * off.numel()


def test_chunked_on_the_card(cuda):
    """A causal prefill still launches flash; the chunked bidirectional
    encoder equals the unchunked one and launches nothing."""
    dense = dataclasses.replace(_small("dense"), attn_impl="chunked", attn_block=16)
    model = Model(dense)
    card = params_to(_params(model, 4), cuda)
    batch = make_batch(dense, 2, 40, np.random.default_rng(4), device=cuda)
    with torch.no_grad():
        n0 = counters.snapshot()
        model.prefill(card, batch, model.init_cache(2, 48, device=cuda))
        assert counters.launches("flash_attention", n0) == dense.num_layers
    encdec = TC.reduce_for_smoke(TC.get_config("seamless-m4t-medium"))
    chunked = Model(dataclasses.replace(encdec, attn_impl="chunked", attn_block=16))
    cpu = Model(encdec).init(5, device="cpu")
    for stack in ("enc_layers", "dec_layers"):
        for lp in cpu[stack]:
            for block in [b for b in ("attn", "xattn") if b in lp]:
                for w, fan_in in (("w_q", encdec.num_heads), ("w_k", encdec.num_kv_heads),
                                  ("w_v", encdec.num_kv_heads)):
                    lp[block][w].mul_(math.sqrt(fan_in / encdec.d_model))
    card = params_to(cpu, cuda)
    eb = make_batch(encdec, 2, 24, np.random.default_rng(5), device=cuda)
    with torch.no_grad():
        want = Model(encdec)._encode(card, eb)
        n0 = counters.snapshot()
        got = chunked._encode(card, eb)
        assert counters.launches("flash_attention", n0) == 0
    torch.testing.assert_close(got, want, **MODEL_TOL)


def test_chunked_train_step_on_the_card_equals_the_cpu(cuda):
    cfg = dataclasses.replace(_small("dense"), attn_impl="chunked", attn_block=16)
    model = Model(cfg)
    cpu = _params(model, 6)
    batch = make_batch(cfg, 2, 40, np.random.default_rng(6), device="cpu")
    out = []
    for dev, params in (("cpu", cpu), (cuda, params_to(cpu, cuda))):
        leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
        n0 = counters.snapshot()
        loss, _ = make_loss_fn(model)(tree_unflatten(params, leaves),
                                      {k: t.to(dev) for k, t in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        assert counters.launches("flash_attention", n0) == 0
        out.append((loss.detach().cpu(), [g.cpu() for g in grads]))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=0.0)
    for g, c in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(g, c, rtol=5e-3, atol=1e-4)
