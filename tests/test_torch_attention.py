"""The port's attention against the reference's, on the CPU.

The plain versions beside the Hopper kernels (``flash_attention_ref``,
``decode_attention_ref``) are what the kernels compute; here they are held
against the reference's Pallas kernels run in interpret mode (as
``tests/test_kernels.py`` runs them) and against the reference's
``ref.py`` oracles, on the same seeded numpy inputs.

Tolerances are those of ``tests/test_kernels.py``: f32 ``rtol=2e-4,
atol=2e-5``; bf16 ``2e-2``.  Two differences from ``ref.py`` are pinned:
that oracle casts the softmax weights to q's dtype before ``P.V`` (covered
by the bf16 tolerance), and it averages a fully masked decode row
uniformly where the kernels (the reference's and the port's) give zeros.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as j_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.obs import counters  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=2e-5)


def _pair(x, name):
    """One numpy array as a JAX array and a torch tensor of the same dtype
    (bf16 rounded once, by JAX, and handed to torch bit for bit)."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(x, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,S,hd,win,blk",
    [
        (1, 2, 2, 40, 32, None, 16),   # rep 1, ragged S (40 = 2.5 blocks)
        (2, 4, 2, 48, 64, None, 16),   # rep 2
        (1, 4, 1, 37, 32, 8, 16),      # rep 4, window, ragged
        (1, 8, 2, 64, 64, 16, 32),     # rep 4, window spanning blocks
        (1, 8, 2, 45, 160, 12, 16),    # hd 160 (pixtral's 32 / 8 heads): rep 4, window, ragged
        (2, 2, 2, 29, 160, None, 16),  # hd 160, rep 1, ragged S
    ],
)
def test_flash_plain_matches_pallas_and_ref(B, H, KV, S, hd, win, blk, dtype):
    rng = np.random.default_rng(S * 7 + hd)
    qj, qt = _pair(rng.standard_normal((B, H, S, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    got = flash_attention_ref(qt, kt, vt, causal=True, window=win)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, H, S, hd)
    pallas = j_flash(qj, kj, vj, causal=True, window=win, block_q=blk, block_k=blk,
                     interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_tol(dtype))
    oracle = jref.flash_attention_ref(qj, kj, vj, causal=True, window=win)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,KV,rep,T,hd,blk",
    [
        (2, 2, 1, 40, 32, 16),    # rep 1, ragged T
        (2, 2, 2, 33, 64, 16),    # rep 2, ragged T
        (1, 2, 4, 70, 32, 32),    # rep 4
    ],
)
def test_decode_plain_matches_pallas_and_ref(B, KV, rep, T, hd, blk, dtype):
    rng = np.random.default_rng(T * 3 + rep)
    qj, qt = _pair(rng.standard_normal((B, KV, rep, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, KV, T, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, KV, T, hd)), dtype)
    valid = rng.random((B, T)) < 0.7
    valid[:, 0] = True
    got = decode_attention_ref(qt, kt, vt, torch.from_numpy(valid))
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, KV, rep, hd)
    pallas = j_decode(qj, kj, vj, jnp.asarray(valid), block_k=blk, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_tol(dtype))
    oracle = jref.decode_attention_ref(qj.reshape(B, KV * rep, hd), kj, vj, jnp.asarray(valid))
    np.testing.assert_allclose(_f32(got).reshape(B, KV * rep, hd), _f32(oracle), **_tol(dtype))


def test_decode_all_invalid_row_is_zero_as_the_kernel_gives():
    """A sequence with no valid cache position: the Pallas kernel (and the
    port) write zeros; ``ref.py`` averages V uniformly instead."""
    B, KV, rep, T, hd = 2, 2, 2, 24, 32
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng.standard_normal((B, KV, rep, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((B, KV, T, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((B, KV, T, hd)), "float32")
    valid = rng.random((B, T)) < 0.5
    valid[0] = False
    valid[1, 0] = True
    got = decode_attention_ref(qt, kt, vt, torch.from_numpy(valid)).numpy()
    pallas = np.asarray(j_decode(qj, kj, vj, jnp.asarray(valid), block_k=8, interpret=True))
    assert np.all(got[0] == 0.0) and np.all(pallas[0] == 0.0)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-5)
    oracle = np.asarray(jref.decode_attention_ref(qj.reshape(B, KV * rep, hd), kj, vj,
                                                  jnp.asarray(valid)))
    np.testing.assert_allclose(oracle[0], np.broadcast_to(_f32(vt)[0].mean(1)[:, None],
                                                          (KV, rep, hd)).reshape(KV * rep, hd),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].reshape(KV * rep, hd), oracle[1], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("window", [None, 6])
def test_flash_adapter_model_layout(window):
    """``ops.flash_attention`` (model layout, strided views) equals the
    reference's adapter, which runs the Pallas kernel in interpret mode."""
    B, S, H, KV, hd = 2, 20, 4, 2, 32
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng.standard_normal((B, S, H, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), "float32")
    got = tops.flash_attention(qt, kt, vt, causal=True, window=window)
    want = jops.flash_attention(qj, kj, vj, causal=True, window=window, block_q=8, block_k=8)
    assert tuple(got.shape) == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_decode_adapter_reads_the_cache_in_place():
    """``ops.decode_attention`` on one layer's slice of an (L, B, W, KV, hd)
    cache and a validity row broadcast over B equals the reference's
    adapter; head ``g * rep + r`` serves KV group g."""
    L, B, W, KV, rep, hd = 3, 2, 20, 2, 4, 32
    rng = np.random.default_rng(12)
    qj, qt = _pair(rng.standard_normal((B, KV * rep, hd)), "float32")
    cache = rng.standard_normal((L, B, W, KV, hd))
    kj, kt = _pair(cache, "float32")
    vj, vt = _pair(cache[::-1].copy(), "float32")
    valid = rng.random(W) < 0.6
    valid[3] = True
    vt_row = torch.from_numpy(valid)[None].expand(B, W)
    got = tops.decode_attention(qt, kt[1], vt[1], vt_row)
    want = jops.decode_attention(qj, kj[1], vj[1], jnp.broadcast_to(jnp.asarray(valid), (B, W)),
                                 block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_cpu_wrappers_take_the_plain_version_without_counting():
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((1, 4, 9, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
    valid = torch.ones((1, 9), dtype=torch.bool)
    counts = counters.snapshot()
    out = torch.empty_like(q)
    got = flash_attention(q, k, k, backend="cuda", out=out)
    assert got is out and torch.equal(out, flash_attention_ref(q, k, k))
    qd = q[:, :, 0].unflatten(1, (2, 2))
    assert torch.equal(decode_attention(qd, k, k, valid, backend="cuda"),
                       decode_attention_ref(qd, k, k, valid))
    # a plain call each, and no kernel launch
    assert counters.delta(counts) == {"kernel.launches.flash_attention.plain": 1,
                                      "kernel.launches.decode_attention.plain": 1}
