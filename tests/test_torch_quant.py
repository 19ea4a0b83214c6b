"""The port's int8 KV cache (``kv_cache_dtype="int8"``) against the
reference's, on the CPU: the cases of ``tests/test_quant.py``, port
against reference.

* ``quantize_kv`` is bitwise the reference's (values and scales) on random
  f32 inputs, on rows whose ``x / scale`` lands exactly on ``.5`` (both
  round half to even), on all-zero rows (scale 1, values 0), and in the
  hypothesis sweep; ``dequantize_kv`` too.  The symmetric int8 bound of
  the round trip holds.
* For each family of ``test_quant.py::FAMS`` (dense, dense with
  ``scan_layers``, hybrid, encoder-decoder) on carried weights: int8
  prefill and 6 teacher-forced decode steps, logits against the
  reference's int8 path (f32 ``rtol=atol=1e-3``; the encoder-decoder
  ``atol=1e-2``, ``test_torch_model.ENCDEC_TOL``), and the int8 rings
  equal.  Where the two packages' k or v differ in the last bit at a
  rounding boundary of ``x / scale``, an int8 value may differ by one
  step: at most ``RING_OFF_SHARE`` (0.1%) of a ring's elements may, by
  one step and no more (measured: 0 of 4 096 / 8 192 for dense and
  hybrid, 1 and 3 of 8 192 for the encoder-decoder's k and v); the
  scales at ``rtol=1e-4``.  The reference test's own claims (int8 logits
  near the unquantized ones, greedy tokens agreeing) are held on the port.
* The int8 cache takes under 0.35 of the f32 cache's bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.models.quant as JQ  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import make_batch as j_make_batch  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models.quant import dequantize_kv, quantize_kv  # noqa: E402
from repro_torch.training import make_batch  # noqa: E402

TOL = dict(rtol=1e-3, atol=1e-3)
ENCDEC_TOL = dict(rtol=1e-3, atol=1e-2)
RING_OFF_SHARE = 1e-3
SCALE_RTOL = 1e-4


def _assert_quant_equal(x: np.ndarray):
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = JQ.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_kv(q, s, torch.float32).numpy(),
                                  np.asarray(JQ.dequantize_kv(jq, js, jnp.float32)))
    return q, s


def test_quantize_roundtrip_error():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 8, 2, 64)) * 3).astype(np.float32)
    q, s = _assert_quant_equal(x)
    assert tuple(s.shape) == (4, 8, 2, 1)
    back = dequantize_kv(q, s, torch.float32).numpy()
    rel = np.abs(back - x) / (np.abs(x).max(-1, keepdims=True) + 1e-9)
    assert rel.max() < 1.0 / 127 + 1e-6  # symmetric int8 bound


def test_quantize_zeros_safe():
    q, s = _assert_quant_equal(np.zeros((2, 3, 1, 8), np.float32))
    assert int(q.sum()) == 0
    assert torch.isfinite(s).all() and (s == 1).all()
    assert (dequantize_kv(q, s, torch.float32) == 0).all()


@pytest.mark.parametrize("amax", [127.0, 254.0, 63.5])
def test_quantize_ties_round_half_to_even(amax):
    """Rows whose ``x / scale`` lands exactly on k + 0.5 (scale = amax / 127
    is exact here): both packages round half to even, never away."""
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    scale = np.float32(amax) / np.float32(127)
    row = np.concatenate([[amax], halves * scale]).astype(np.float32)
    assert (row[1:] / scale == halves).all()  # the ties are exact
    x = np.stack([row, -row, np.zeros_like(row)])[:, None]
    q, _ = _assert_quant_equal(x)
    np.testing.assert_array_equal(q[0, 0, 1:].numpy(), [0, 2, 2, 0, -2, -2, 126, -126])


@settings(max_examples=20, deadline=None)
@given(scale=st.floats(1e-3, 1e3), hd=st.sampled_from([8, 64, 128]))
def test_property_quant_bounded(scale, hd):
    rng = np.random.default_rng(42)
    x = (rng.standard_normal((2, 5, 1, hd)) * scale).astype(np.float32)
    q, s = _assert_quant_equal(x)
    back = dequantize_kv(q, s, torch.float32).numpy()
    amax = np.abs(x).max(-1, keepdims=True)
    assert (np.abs(back - x) <= amax / 127 + 1e-6).all()


def test_quantize_bfloat16_input_equals_reference():
    """bf16 activations (the serving dtype) are quantized from their f32
    values, as the reference does."""
    x = torch.randn((3, 4, 2, 64), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    q, s = quantize_kv(x)
    jq, js = JQ.quantize_kv(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = dequantize_kv(q, s, torch.bfloat16)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back.float().numpy(),
        np.asarray(JQ.dequantize_kv(jq, js, jnp.bfloat16).astype(jnp.float32)))


FAMS = [
    ("dense", False, dict(num_heads=4, num_kv_heads=2, d_ff=128)),
    ("dense", True, dict(num_heads=4, num_kv_heads=2, d_ff=128)),
    ("hybrid", False, dict(num_heads=4, num_kv_heads=4, d_ff=128, ssm_state=16,
                           ssm_headdim=32, ssd_chunk=8, attn_every=2)),
    ("encdec", False, dict(num_heads=4, num_kv_heads=4, d_ff=128,
                           num_enc_layers=2, enc_seq_len=24)),
]


def _assert_rings_equal(ct, cj, where):
    for name in ("k", "v"):
        got, want = ct.attn[name].numpy(), np.asarray(cj.attn[name])
        assert got.dtype == want.dtype == np.int8
        off = got.astype(np.int32) - want.astype(np.int32)
        assert np.abs(off).max() <= 1, f"{where} {name}: an int8 value off by more than one step"
        assert np.count_nonzero(off) <= RING_OFF_SHARE * off.size, (where, name,
                                                                    np.count_nonzero(off))
        np.testing.assert_allclose(ct.attn[name + "_scale"].numpy(),
                                   np.asarray(cj.attn[name + "_scale"]), rtol=SCALE_RTOL,
                                   err_msg=f"{where} {name}_scale")


@pytest.mark.parametrize("fam,scan,kw", FAMS)
def test_int8_decode_close_and_tokens_agree(fam, scan, kw):
    base = dict(family=fam, num_layers=4 if fam == "hybrid" else 2, d_model=64,
                vocab_size=256, scan_layers=scan, **kw)
    jcfg, tcfg = JConfig(**base), ModelConfig(**base)
    jm8 = JModel(dataclasses.replace(jcfg, kv_cache_dtype="int8"))
    t8 = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    tm, tm8 = Model(tcfg), Model(t8)
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_reference(tcfg, tree, device="cpu")
    S = 32
    jb = j_make_batch(jcfg, 2, S, np.random.default_rng(0))
    tb = make_batch(tcfg, 2, S, np.random.default_rng(0), device="cpu")
    P = S - 6
    jpre, tpre = dict(jb), dict(tb)
    jpre["tokens"], tpre["tokens"] = jb["tokens"][:, :P], tb["tokens"][:, :P]
    tol = ENCDEC_TOL if fam == "encdec" else TOL

    cj = jm8.init_cache(2, S)
    cq = tm8.init_cache(2, S, device="cpu")
    cf = tm.init_cache(2, S, device="cpu")
    assert cq.attn["k"].dtype == torch.int8 and cq.attn["k_scale"].dtype == torch.float32
    assert tuple(cq.attn["k_scale"].shape) == cj.attn["k_scale"].shape
    assert (cq.attn["k_scale"] == 1).all()
    if fam == "encdec":
        assert cq.cross["k"].dtype == torch.float32  # the cross cache is not quantized
    lj, cj = jm8.prefill(jp, jpre, cj)
    lq, cq = tm8.prefill(tp, tpre, cq)
    lf, cf = tm.prefill(tp, tpre, cf)
    np.testing.assert_allclose(lq.numpy(), np.asarray(lj), **tol)
    _assert_rings_equal(cq, cj, "prefill")
    agree, close = [], []
    for t in range(P, S):
        tok = tb["tokens"][:, t:t + 1]
        lj, cj = jm8.decode_step(jp, jnp.asarray(tok.numpy()), cj)
        lq, cq = tm8.decode_step(tp, tok, cq)
        lf, cf = tm.decode_step(tp, tok, cf)
        np.testing.assert_allclose(lq.numpy(), np.asarray(lj), **tol, err_msg=f"position {t}")
        close.append(float((lf - lq).abs().max()))
        agree.append(bool((lf.argmax(-1) == lq.argmax(-1)).all()))
    _assert_rings_equal(cq, cj, "decoded")
    # the reference test's claims, on the port: int8 logits near the
    # unquantized ones, greedy tokens agreeing on ~every step
    assert max(close) < (1.0 if fam == "hybrid" else 0.5), close
    assert np.mean(agree) >= 0.8, agree


def test_int8_cache_memory_is_quarter():
    cfg = ModelConfig(family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=256)
    cq = Model(dataclasses.replace(cfg, kv_cache_dtype="int8", dtype="float32")).init_cache(
        2, 128, device="cpu")
    cf = Model(cfg).init_cache(2, 128, device="cpu")
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c.attn.values())  # noqa: E731
    # int8 payload + f32 scales (4 / head_dim overhead; head_dim 16 here) vs f32
    assert nbytes(cq) < 0.35 * nbytes(cf)
