"""The port's models against the reference's, on the CPU.

* Every registry ``ModelConfig`` equals the reference's field for field.
* The weight carry turns the reference's stacked parameter tree into the
  port's per-layer dicts, value for value.
* On carried weights, ``forward``, ``prefill`` (logits and the filled ring
  cache) and several ``decode_step``s equal the reference with
  ``use_pallas=True`` (its Pallas kernels in interpret mode) for four dense
  flavours: yi-like (GQA rep 4), starcoder2-like (LayerNorm, biases, classic
  GELU MLP, a sliding window whose ring wraps), stablelm-like (25% partial
  rotary) and qwen2-like (qkv bias), and for the MoE, encoder-decoder and
  VLM families (qwen2-moe-a2.7b, arctic-480b, seamless-m4t-medium,
  pixtral-12b at smoke size, with their stub inputs; the cross cache too).
  Biases and norm scales are perturbed from their zero/one init so that
  they matter.
* The serving options ``kv_cache_dtype="int8"`` and ``attn_impl="chunked"``
  build, prefill and decode on a registry config of each family against
  the reference with the same option.

Stated tolerance: f32 logits ``rtol=atol=1e-3``.  The reference's own two
attention paths (``use_pallas`` False vs True) already differ by up to
2.6e-4 on logits of magnitude ~4 at this size; the port differs from the
Pallas path by at most ~2e-4 (matrix products and reductions summed in
another order).  The cache holds k/v of magnitude up to ~40 here (the
reference's fan-in of ``shape[-2]`` gives ``w_k`` a std of 1/sqrt(KV)), so
its contents are held to ``rtol=1e-3`` with an absolute part of 1e-4 of
the largest entry (measured: up to 1.7e-3 absolute on entries of ~38,
4e-5 of the scale).  Greedy tokens are held exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.training as JT  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.training as TT  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models.layers import ParamDecl  # noqa: E402

TOL = dict(rtol=1e-3, atol=1e-3)
#: the reduced seamless-m4t-medium chains three sharp attentions a decoder
#: layer (the encoder's, the self and the cross attention; the fan-in rule
#: gives scores of std ~60): on its logits of magnitude ~4 the reference's
#: own float32 forward lies 7.7e-3 from the same forward in float64 (the
#: port's 4.1e-3), and the reference's two attention paths 1.2e-3 apart
ENCDEC_TOL = dict(rtol=1e-3, atol=1e-2)
#: an int8 cache: where the two packages' k or v differ in the last bit at
#: a rounding boundary of ``x / scale``, one int8 value differs by a step
#: (a scale, ~1% of the vector's largest entry); the sharp attention of the
#: reference's init carries that to the logits: measured 2.8e-3 on the
#: reduced qwen2-moe's logits of magnitude ~1 at one such step
INT8_TOL = dict(rtol=1e-3, atol=1e-2)
#: the encoder-decoder family's self-attention cache with the chunked
#: encoder, whose f32 sums run in another order and pass the three sharp
#: attentions of ENCDEC_TOL: an absolute part of 1e-3 of the largest entry
#: (measured 2.5e-4 of it)
ENCDEC_CACHE_SHARE = 1e-3


def _assert_cache_close(got, want, msg="", share=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=share * float(np.abs(want).max()), err_msg=msg)


@pytest.mark.parametrize("arch", sorted(JC.REGISTRY))
def test_registry_config_equals_reference(arch):
    ref, port = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(TC.reduce_for_smoke(port)) == dataclasses.asdict(
        JC.reduce_for_smoke(ref))
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()
    assert (port.d_inner, port.ssm_nheads, port.effective_moe_d_ff, port.is_attention_free) == (
        ref.d_inner, ref.ssm_nheads, ref.effective_moe_d_ff, ref.is_attention_free)


def test_registry_ids():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert sorted(TC.REGISTRY) == sorted(JC.REGISTRY)
    assert sorted(TC.PAPER_ZOO) == sorted(JC.PAPER_ZOO)
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-7")


def _flavour(name):
    """(reference config, port config) of one dense flavour at smoke size."""
    arch, changes = {
        "yi": ("yi-9b", dict(num_kv_heads=1)),
        "starcoder2": ("starcoder2-15b", dict(num_kv_heads=2, sliding_window=8)),
        "stablelm": ("stablelm-12b", dict(num_kv_heads=2)),
        "qwen2": ("qwen2-72b", dict(num_kv_heads=2)),
    }[name]
    ref = dataclasses.replace(JC.reduce_for_smoke(JC.get_config(arch)), use_pallas=True, **changes)
    port = dataclasses.replace(TC.reduce_for_smoke(TC.get_config(arch)), use_pallas=True, **changes)
    return ref, port


def _perturbed_tree(jm, seed):
    """The reference's init with every bias and norm leaf perturbed."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if "'b_" in name or "'bias'" in name:
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if "'scale'" in name:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, tree)


def test_weight_carry_splits_the_layer_stack():
    ref, port = _flavour("starcoder2")
    tree = _perturbed_tree(JModel(ref), 0)
    params = params_from_reference(port, tree, device="cpu")
    assert len(params["layers"]) == port.num_layers
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(layer["attn"]["w_q"].numpy(), tree["layers"]["attn"]["w_q"][i])
        np.testing.assert_array_equal(layer["mlp"]["b_up"].numpy(), tree["layers"]["mlp"]["b_up"][i])
    np.testing.assert_array_equal(params["lm_head"].numpy(), tree["lm_head"])
    np.testing.assert_array_equal(params["ln_f"]["bias"].numpy(), tree["ln_f"]["bias"])
    bad = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        params_from_reference(port, bad, device="cpu")


def test_weight_carry_keeps_bfloat16():
    ref = dataclasses.replace(JC.get_config("squeeze-lm"), param_dtype="bfloat16")
    port = dataclasses.replace(TC.get_config("squeeze-lm"), param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JModel(ref).init(jax.random.PRNGKey(1)))
    params = params_from_reference(port, tree, device="cpu")
    w = params["layers"][1]["attn"]["w_o"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  tree["layers"]["attn"]["w_o"][1].astype(np.float32))


def test_port_init_draws_the_reference_distributions():
    """Same shapes, dtypes and scales as the reference's init, including its
    fan-in of ``shape[-2]`` for 3-D leaves (H for ``w_q``, hd for ``w_o``)."""
    ref, port = _flavour("qwen2")
    tree = jax.tree.map(np.asarray, JModel(ref).init(jax.random.PRNGKey(0)))
    params = Model(port).init(0, device="cpu")
    again = Model(port).init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(params["layers"][1]["attn"]["w_k"], again["layers"][1]["attn"]["w_k"])
    for name, want_std in (("w_q", 1 / np.sqrt(port.num_heads)),
                           ("w_o", 1 / np.sqrt(port.head_dim))):
        got = torch.stack([lp["attn"][name] for lp in params["layers"]]).numpy()
        assert got.shape == tree["layers"]["attn"][name].shape and got.dtype == np.float32
        assert abs(got.std() / want_std - 1) < 0.05
        assert abs(tree["layers"]["attn"][name].std() / want_std - 1) < 0.05
    assert abs(params["embed"].std().item() / 0.02 - 1) < 0.05
    assert torch.equal(params["layers"][0]["attn"]["b_q"], torch.zeros_like(params["layers"][0]["attn"]["b_q"]))
    assert abs(params["lm_head"].std().item() * np.sqrt(port.d_model) - 1) < 0.05


@pytest.mark.parametrize("flavour", ["yi", "starcoder2", "stablelm", "qwen2"])
def test_dense_flavour_matches_reference_pallas_path(flavour):
    """forward, prefill (+ ring cache) and 4 decode steps on carried weights,
    against the reference with ``use_pallas=True``."""
    ref, port = _flavour(flavour)
    jm, tm = JModel(ref), Model(port)
    tree = _perturbed_tree(jm, 3)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_reference(port, tree, device="cpu")
    B, S, steps = 2, 12, 4
    toks = np.random.default_rng(4).integers(0, port.vocab_size, (B, S)).astype(np.int32)

    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    lt, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (B, S, port.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert float(aux["router_aux"]) == 0.0

    max_len = S + steps + 2
    cj = jm.init_cache(B, max_len)
    ct = tm.init_cache(B, max_len, device="cpu")
    assert tuple(ct.attn["k"].shape) == cj.attn["k"].shape
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cj)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert ct.index == int(cj.index) == S
    for name in ("k", "v"):
        _assert_cache_close(ct.attn[name], cj.attn[name], f"prefill {name}")

    for step in range(steps):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(lt[:, -1], -1).numpy(), tok[:, 0],
                                      err_msg=f"greedy token, step {step}")
        lj, cj = jm.decode_step(jp, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(tp, torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL, err_msg=f"step {step}")
        assert ct.index == int(cj.index)
    for name in ("k", "v"):
        _assert_cache_close(ct.attn[name], cj.attn[name], f"decoded {name}")
    if port.sliding_window:
        assert ct.attn["k"].shape[2] == port.sliding_window < S + steps  # the ring wrapped


NEW_FAMILIES = sorted(a for a, c in JC.REGISTRY.items() if c.family in ("moe", "encdec", "vlm"))


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_family_matches_reference_pallas_path(arch):
    """The MoE (qwen2-moe-a2.7b: shared experts, qkv bias; arctic-480b: a
    dense residual, remat), encoder-decoder (seamless-m4t-medium) and VLM
    (pixtral-12b) families at smoke size on carried, perturbed weights:
    ``forward`` (logits and ``router_aux``), ``prefill`` (logits, the ring
    and, for the encoder-decoder family, the cross cache) and 4 decode
    steps with their greedy tokens, against the reference with
    ``use_pallas=True``.  The batch carries the family's stub
    (``make_batch``: patch embeddings at the first 16 positions, or 64
    frame embeddings).  The MoE configs route with their own capacity
    factor: prefill's grouped dispatch and decode's global one each match
    the reference's, drops included."""
    ref = dataclasses.replace(JC.reduce_for_smoke(JC.get_config(arch)), use_pallas=True)
    port = dataclasses.replace(TC.reduce_for_smoke(TC.get_config(arch)), use_pallas=True)
    jm, tm = JModel(ref), Model(port)
    tree = _perturbed_tree(jm, 5)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_reference(port, tree, device="cpu")
    B, S, steps = 2, 20, 4
    jb = JT.make_batch(ref, B, S, np.random.default_rng(6))
    tb = TT.make_batch(port, B, S, np.random.default_rng(6), device="cpu")
    assert sorted(tb) == sorted(jb)
    tol = ENCDEC_TOL if port.family == "encdec" else TOL

    lj, aj = jm.forward(jp, jb)
    lt, at = tm.forward(tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    np.testing.assert_allclose(float(at["router_aux"]), float(aj["router_aux"]), rtol=1e-5)
    assert (float(at["router_aux"]) > 0) == (port.family == "moe")

    max_len = S + steps + 2
    cj = jm.init_cache(B, max_len)
    ct = tm.init_cache(B, max_len, device="cpu")
    lj, cj = jm.prefill(jp, jb, cj)
    lt, ct = tm.prefill(tp, tb, ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    for name in ("k", "v"):
        _assert_cache_close(ct.attn[name], cj.attn[name], f"prefill {name}")
        if port.family == "encdec":
            assert tuple(ct.cross[name].shape) == cj.cross[name].shape
            _assert_cache_close(ct.cross[name], cj.cross[name], f"cross {name}")
    assert (ct.cross is None) == (cj.cross is None)

    for step in range(steps):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(lt[:, -1], -1).numpy(), tok[:, 0],
                                      err_msg=f"greedy token, step {step}")
        lj, cj = jm.decode_step(jp, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(tp, torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol, err_msg=f"step {step}")
        assert ct.index == int(cj.index)
    for name in ("k", "v"):
        _assert_cache_close(ct.attn[name], cj.attn[name], f"decoded {name}")


SERVING_OPTIONS = {"int8": dict(kv_cache_dtype="int8"), "chunked": dict(attn_impl="chunked",
                                                                         attn_block=8)}
OPTION_ARCHS = ["yi-9b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-1.2b",
                "seamless-m4t-medium", "pixtral-12b"]


@pytest.mark.parametrize("option", sorted(SERVING_OPTIONS))
@pytest.mark.parametrize("arch", OPTION_ARCHS)
def test_serving_option_matches_reference(arch, option):
    """``kv_cache_dtype="int8"`` and ``attn_impl="chunked"`` (q chunks of 8)
    build, prefill and decode for a registry config of every family at
    smoke size, on carried, perturbed weights, against the reference with
    the same option and ``use_pallas=False`` (whose causal attention then
    takes the chunked path, as the port's does on the CPU): prefill and 3
    decode steps' logits at the family's tolerance (``INT8_TOL`` for an
    int8 cache), greedy tokens exact,
    the int8 rings equal but for one step at a rounding boundary
    (``test_torch_quant.py``), a float cache at the cache tolerance."""
    change = SERVING_OPTIONS[option]
    ref = dataclasses.replace(JC.reduce_for_smoke(JC.get_config(arch)), **change)
    port = dataclasses.replace(TC.reduce_for_smoke(TC.get_config(arch)), **change)
    jm, tm = JModel(ref), Model(port)
    tree = _perturbed_tree(jm, 8)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_reference(port, tree, device="cpu")
    B, S, steps = 2, 20, 3
    jb = JT.make_batch(ref, B, S, np.random.default_rng(9))
    tb = TT.make_batch(port, B, S, np.random.default_rng(9), device="cpu")
    tol = ENCDEC_TOL if port.family == "encdec" else INT8_TOL if option == "int8" else TOL

    cj = jm.init_cache(B, S + steps)
    ct = tm.init_cache(B, S + steps, device="cpu")
    lj, cj = jm.prefill(jp, jb, cj)
    lt, ct = tm.prefill(tp, tb, ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(lt[:, -1], -1).numpy(), tok[:, 0],
                                      err_msg=f"greedy token, step {step}")
        lj, cj = jm.decode_step(jp, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(tp, torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol, err_msg=f"step {step}")
    assert (ct.attn is None) == (cj.attn is None)
    for name in sorted(ct.attn or {}):
        got, want = ct.attn[name].numpy(), np.asarray(cj.attn[name])
        assert got.dtype == want.dtype, name
        if got.dtype == np.int8:
            off = got.astype(np.int32) - want.astype(np.int32)
            assert np.abs(off).max() <= 1 and np.count_nonzero(off) <= 1e-3 * off.size, name
        else:
            _assert_cache_close(ct.attn[name], cj.attn[name], f"decoded {name}",
                                share=ENCDEC_CACHE_SHARE if port.family == "encdec" else 1e-4)


def test_decl_matches_reference_shapes():
    """Every leaf the port declares has the reference's shape (one layer)."""
    for arch in sorted(JC.REGISTRY):
        ref = JC.get_config(arch)
        shapes = jax.eval_shape(lambda: JModel(ref).init(jax.random.PRNGKey(0)))

        def walk(decl, tree):
            if isinstance(decl, ParamDecl):
                return [(decl.shape, tree.shape)]
            assert set(decl) == set(tree)
            return [x for k in decl for x in walk(decl[k], tree[k])]

        model = Model(TC.get_config(arch))
        decl, stacks = model.decl(), model.stack_sizes()
        assert set(decl) == set(shapes), arch
        pairs = [x for k in decl if k not in stacks for x in walk(decl[k], shapes[k])]
        for k, n in stacks.items():
            pairs += [(d, t[1:]) for d, t in walk(decl[k], shapes[k])]
            assert all(t[0] == n for _, t in walk(decl[k], shapes[k])), (arch, k)
        assert all(tuple(d) == tuple(t) for d, t in pairs), arch
