"""The encoder-decoder and VLM families' inputs and embedding, against the
reference, on the CPU.

* ``audio_stub_batch``, ``vision_stub_batch`` and the stubs ``make_batch``
  adds (drawn from the same ``rng`` after the tokens) equal the
  reference's bit for bit, for the reduced and the full configs, with a
  prompt shorter than the patch count too.
* The VLM embedding writes each row's patch embeddings at its own
  positions (rows with different positions), as the reference's
  ``vmap``-ed ``.at[pos].set``; forward and prefill take the stub, decode
  does not.
* The encoder-decoder cache: the cross cache has the reference's shape
  for a given ``enc_len``, is written once by prefill, and decode reads it
  without writing it.

Stated tolerance: bitwise for the stubs and the embedding; f32 logits
``rtol=atol=1e-3`` (``tests/test_torch_model.py``'s).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.training as J  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.training as T  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402

CPU = "cpu"
TOL = dict(rtol=1e-3, atol=1e-3)


def _configs(arch, reduced=True, **changes):
    j, t = JC.get_config(arch), TC.get_config(arch)
    if reduced:
        j, t = JC.reduce_for_smoke(j), TC.reduce_for_smoke(t)
    return dataclasses.replace(j, **changes), dataclasses.replace(t, **changes)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.from_numpy(np.array(w)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_audio_stub_equals_the_reference(reduced):
    jc, tc = _configs("seamless-m4t-medium", reduced)
    _assert_batches_equal(T.audio_stub_batch(tc, 2, np.random.default_rng(3), device=CPU),
                          J.audio_stub_batch(jc, 2, np.random.default_rng(3)))


@pytest.mark.parametrize("reduced,seq", [(True, 24), (True, 9), (False, 1100), (False, 512)])
def test_vision_stub_equals_the_reference(reduced, seq):
    jc, tc = _configs("pixtral-12b", reduced)
    got = T.vision_stub_batch(tc, 3, seq, np.random.default_rng(4), device=CPU)
    _assert_batches_equal(got, J.vision_stub_batch(jc, 3, seq, np.random.default_rng(4)))
    assert got["vision_positions"].shape == (3, min(tc.num_patches, seq))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b", "qwen2-moe-a2.7b"])
def test_make_batch_stubs_equal_the_reference(arch):
    """Tokens, labels and the stub, from one rng, over two batches in a row
    (the second starts where the first's draws ended)."""
    jc, tc = _configs(arch)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        _assert_batches_equal(T.make_batch(tc, 2, 20, tr, device=CPU),
                              J.make_batch(jc, 2, 20, jr))


def _carried(arch, **changes):
    jc, tc = _configs(arch, **changes)
    jm, tm = JModel(jc), Model(tc)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    return jc, tc, jm, tm, tree, params_from_reference(tc, tree, device=CPU)


def test_vision_embeds_land_at_each_rows_positions():
    jc, tc, jm, tm, tree, tp = _carried("pixtral-12b")
    batch = T.make_batch(tc, 2, 20, np.random.default_rng(6), device=CPU)
    # row 1's patches at other, unordered positions
    batch["vision_positions"][1] = torch.randperm(20, generator=torch.Generator().manual_seed(0))[
        :batch["vision_positions"].shape[1]].to(torch.int32)
    h = tm._embed(tp, batch["tokens"], batch)
    want = jm._embed(jax.tree.map(jnp.asarray, tree),
                     {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_array_equal(h.numpy(), np.asarray(want))
    for b in range(2):
        np.testing.assert_array_equal(h[b, batch["vision_positions"][b].long()].numpy(),
                                      batch["vision_embeds"][b].numpy())
    plain = tm._embed(tp, batch["tokens"])  # decode's embedding: tokens only
    assert not torch.equal(plain, h)
    lt = tm.forward(tp, batch)[0]
    lj = jm.forward(jax.tree.map(jnp.asarray, tree),
                    {k: jnp.asarray(v.numpy()) for k, v in batch.items()})[0]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_the_cross_cache_is_written_once_by_prefill():
    jc, tc, jm, tm, tree, tp = _carried("seamless-m4t-medium", enc_seq_len=24)
    batch = T.make_batch(tc, 2, 10, np.random.default_rng(7), device=CPU)
    assert batch["enc_embeds"].shape == (2, 24, tc.d_model)
    for enc_len in (None, 24, 40):
        assert tuple(tm.init_cache(2, 16, enc_len, device=CPU).cross["k"].shape) == \
            jm.init_cache(2, 16, enc_len).cross["k"].shape
    cache = tm.init_cache(2, 16, device=CPU)
    assert not cache.cross["k"].any()
    logits, cache = tm.prefill(tp, batch, cache)
    cross = {k: v.clone() for k, v in cache.cross.items()}
    assert cross["k"].any() and cross["v"].any()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    _, jcache = jm.prefill(jax.tree.map(jnp.asarray, tree), jb, jm.init_cache(2, 16))
    for k in ("k", "v"):
        np.testing.assert_allclose(cross[k].numpy(), np.asarray(jcache.cross[k]),
                                   rtol=1e-3, atol=1e-4 * float(np.abs(jcache.cross[k]).max()))
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for _ in range(3):
        lg, cache = tm.decode_step(tp, tok, cache)
        tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    assert cache.index == 13
    for k in ("k", "v"):
        assert torch.equal(cache.cross[k], cross[k])
