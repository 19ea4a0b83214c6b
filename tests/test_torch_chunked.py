"""The port's chunked attention (``attn_impl="chunked"``) against the
reference's, on the CPU: the cases of ``tests/test_attn_impl.py``, port
against reference on carried weights.

* The block x window grid: the port's chunked forward against the
  reference's chunked forward (``rtol=atol=1e-4``, the reference's own
  bound between its two paths) and against the port's own unchunked one.
* The encoder-decoder family: the encoder's bidirectional attention in
  chunks of 8 (``rtol=atol=5e-4``, as the reference holds its two paths).
* Gradients of the loss against ``jax.grad`` of the reference's chunked
  loss, leaf by leaf (``rtol=5e-3, atol=1e-4``, the reference test's).
* The hypothesis sweep over odd lengths, blocks, windows and GQA shapes
  (``rtol=atol=2e-4``, the reference test's).
* ``remat_policy="dots"`` gives the full policy's loss and gradients.
* The routing: a causal call on the plain route takes the chunked path, a
  bidirectional call takes it too, the cross attention stays plain, and
  the default ``attn_impl`` never calls it.
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

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import make_batch as j_make_batch, make_loss_fn as j_loss_fn  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model, layers, params_from_reference  # noqa: E402
from repro_torch.models import params_to_reference  # noqa: E402
from repro_torch.training import make_batch, make_loss_fn  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_unflatten  # noqa: E402


def _cfgs(**kw):
    """(reference config, port config) of the reference test's ``_cfg``."""
    base = dict(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                d_ff=128, vocab_size=256, scan_layers=False)
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _carried(jcfg, tcfg, seed):
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, tree), params_from_reference(tcfg, tree, device="cpu")


def _batches(jcfg, tcfg, B, S, seed):
    return (j_make_batch(jcfg, B, S, np.random.default_rng(seed)),
            make_batch(tcfg, B, S, np.random.default_rng(seed), device="cpu"))


def _chunked(jcfg, tcfg, **kw):
    return (dataclasses.replace(jcfg, attn_impl="chunked", **kw),
            dataclasses.replace(tcfg, attn_impl="chunked", **kw))


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("block", [8, 32, 1024])
def test_chunked_matches_reference(window, block):
    jcfg, tcfg = _cfgs(sliding_window=window, attn_block=block)
    jchk, tchk = _chunked(jcfg, tcfg)
    jp, tp = _carried(jcfg, tcfg, 0)
    jb, tb = _batches(jcfg, tcfg, 2, 40, 0)
    want, _ = JModel(jchk).forward(jp, jb)
    got, _ = Model(tchk).forward(tp, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    unchunked, _ = Model(tcfg).forward(tp, tb)
    np.testing.assert_allclose(got.numpy(), unchunked.numpy(), rtol=1e-4, atol=1e-4)


def test_chunked_encdec_bidir():
    jcfg, tcfg = _cfgs(family="encdec", num_enc_layers=2, num_kv_heads=4, enc_seq_len=24)
    jchk, tchk = _chunked(jcfg, tcfg, attn_block=8)
    jp, tp = _carried(jcfg, tcfg, 1)
    jb, tb = _batches(jcfg, tcfg, 2, 24, 1)
    want, _ = JModel(jchk).forward(jp, jb)
    got, _ = Model(tchk).forward(tp, tb)
    # 4 layers of f32 accumulation-order noise: the reference test's bound
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)
    unchunked, _ = Model(tcfg).forward(tp, tb)
    np.testing.assert_allclose(got.numpy(), unchunked.numpy(), rtol=5e-4, atol=5e-4)


def _port_grads(tcfg, tp, tb):
    """The loss's gradient of every leaf, in the reference's layout."""
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(tp)]
    loss, _ = make_loss_fn(Model(tcfg))(tree_unflatten(tp, leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), params_to_reference(tcfg, tree_unflatten(tp, list(grads)))


def test_chunked_grads_match():
    """Backward parity (the chunked path is the one training takes)."""
    jcfg, tcfg = _cfgs()
    jchk, tchk = _chunked(jcfg, tcfg, attn_block=16)
    jp, tp = _carried(jcfg, tcfg, 2)
    jb, tb = _batches(jcfg, tcfg, 2, 32, 2)
    want = jax.grad(lambda p: j_loss_fn(JModel(jchk))(p, jb)[0])(jp)
    loss, got = _port_grads(tchk, tp, tb)
    assert loss == pytest.approx(float(j_loss_fn(JModel(jchk))(jp, jb)[0]), rel=1e-5)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@settings(max_examples=10, deadline=None)
@given(
    s=st.integers(3, 70),
    block=st.sampled_from([4, 16, 64]),
    window=st.sampled_from([None, 5, 16]),
    kv=st.sampled_from([1, 2, 4]),
)
def test_property_chunked_any_shape(s, block, window, kv):
    jcfg, tcfg = _cfgs(num_kv_heads=kv, sliding_window=window, attn_block=block)
    jchk, tchk = _chunked(jcfg, tcfg)
    jp, tp = _carried(jcfg, tcfg, 3)
    jb, tb = _batches(jcfg, tcfg, 1, s, 3)
    want, _ = JModel(jchk).forward(jp, jb)
    got, _ = Model(tchk).forward(tp, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_remat_policy_dots_same_loss():
    _, tcfg = _cfgs(scan_layers=True, remat=True)
    tdots = dataclasses.replace(tcfg, remat_policy="dots")
    tp = Model(tcfg).init(4, device="cpu")
    tb = make_batch(tcfg, 2, 32, np.random.default_rng(4), device="cpu")
    l1, g1 = _port_grads(tcfg, tp, tb)
    l2, g2 = _port_grads(tdots, tp, tb)
    assert l1 == pytest.approx(l2, rel=1e-6)
    for a, c in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", ["dense", "encdec"])
@pytest.mark.parametrize("impl", ["reference", "chunked"])
def test_chunked_routing(monkeypatch, family, impl):
    """Which attention path each call of a forward takes on the CPU (the
    plain route): with ``attn_impl="chunked"`` every causal and
    bidirectional call is chunked and the cross attention stays plain;
    without it, no call is chunked."""
    calls = []
    real = layers._sdpa_chunked

    def spy(q, k, v, cfg, *, causal, window):
        calls.append(causal)
        return real(q, k, v, cfg, causal=causal, window=window)

    monkeypatch.setattr(layers, "_sdpa_chunked", spy)
    kw = dict(family="encdec", num_enc_layers=2, num_kv_heads=4, enc_seq_len=24) \
        if family == "encdec" else {}
    _, tcfg = _cfgs(attn_impl=impl, attn_block=8, **kw)
    model = Model(tcfg)
    tb = make_batch(tcfg, 1, 24, np.random.default_rng(5), device="cpu")
    model.forward(model.init(5, device="cpu"), tb)
    if impl == "reference":
        assert calls == []
    elif family == "encdec":  # 2 bidirectional encoder layers, 2 causal decoder layers
        assert calls == [False, False, True, True]
    else:
        assert calls == [True, True]
