"""The port's MoE layer against the live reference (``repro.models.moe``),
on the CPU.

Every case of ``tests/test_moe.py`` runs on the port and on the reference
with the same (carried) weights and inputs: shape and finiteness, the
naive per-token expert loop, capacity dropping, the capacity formula, the
shared-expert branch under a zeroed router (every choice a tie), the dense
residual, the load-balance loss, and the hypothesis property test of the
dropless regime.  Then:

* the routing integers on both dispatches (grouped for S > 1, global for
  decode), with and without drops and under a zero router: ``expert_idx``
  from the reference's own ``router_aux_loss`` call, and the slot table
  ``tok_map`` read back from the reference's gathered ``xe`` (every token
  row is distinct), so the kept and the dropped choices too, all exactly;
* the bf16 combine bitwise against the reference's scatter-add (the
  expression of ``_apply_moe_global`` / ``_apply_moe_grouped``) on the
  same slot contents and routing;
* the bf16 layer at a stated tolerance;
* the f32 layer's gradient, leaf by leaf, against the reference's
  ``jax.grad``: of the output and of the aux loss each on its own;
* train steps of the reduced qwen2-moe-a2.7b and arctic-480b (remat) with
  ``router_aux`` in the loss, against the reference's step, at
  ``tests/test_torch_training.py``'s limits: like the reduced yi-9b's,
  their float32 gradient is ill-conditioned (the fan-in rule's sharp
  attention: the port's own float32 step lies 3.8e-5 and 1.4e-5 from the
  same step computed in float64 in its gradient norm, and 0.18% / 0.11% of
  its parameters outside ``STATE_TOL``), so ``grad_norm`` is held at the
  wide limit ``rtol=1e-3``, ``m`` and ``v`` outside ``STATE_TOL`` on at
  most 0.5% of the elements of each leaf, and the parameters on at most
  0.5% of theirs, each within ``2 lr``; the loss, ``ce``, ``router_aux``
  and the learning rate at their stated tolerances;
* planted faults in the router's and the shared gate's gradient (gates,
  aux loss or shared gate detached) fail the layer's gradient check, and
  the train step's where they exceed its tolerance.

Stated tolerances: f32 ``y`` ``rtol=atol=1e-5`` (products and reductions
summed in another order; measured below 1e-6), the aux loss ``rtol=1e-6``,
the f32 gradients ``rtol=1e-4, atol=1e-6`` (``STATE_TOL``; measured at
0.18-0.85 of it);
bf16 ``y`` ``rtol=atol=2e-2`` (one bf16 rounding of the expert products
apart; ``tests/test_kernels.py``'s bf16 bound).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # the property test, as tests/test_moe.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.models.moe as RM  # noqa: E402
import repro.training as J  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.layers import init_from_decl  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.training as T  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models.moe import (  # noqa: E402
    apply_moe,
    capacity,
    combine,
    dispatch,
    router_aux_loss,
)
from repro_torch.training.optimizer import tree_leaves, tree_unflatten  # noqa: E402
from test_torch_training import (  # noqa: E402
    LOSS_TOL,
    LR_TOL,
    STATE_TOL,
    WIDE_GNORM_RTOL,
    WIDE_OFF_SHARE,
    _assert_step_close,
    _wide_readings,
)

CPU = "cpu"
Y_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FIELDS = dict(
    family="moe", num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
    d_ff=64, vocab_size=64, n_experts=4, top_k=2, moe_d_ff=48,
    capacity_factor=8.0,  # dropless unless a test lowers it
)
BASE = ModelConfig(**FIELDS)


def _ref(cfg):
    """The reference's config with the port config's fields."""
    return JConfig(**dataclasses.asdict(cfg))


def init_moe(cfg, seed=0):
    """(the reference's MoE params, the same as port tensors)."""
    jp = init_from_decl(jax.random.PRNGKey(seed), RM.moe_decl(_ref(cfg)))
    return jp, _to_port(jp)


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _x(seed, shape, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _both(jp, tp, x, cfg):
    yj, aj = RM.apply_moe(jp, x[0], _ref(cfg))
    yt, at = apply_moe(tp, x[1], cfg)
    return np.asarray(yj, np.float32), float(aj), yt.float().numpy(), float(at)


# ---------------------------------------------------- tests/test_moe.py's cases


def test_output_shape_and_finite():
    jp, tp = init_moe(BASE)
    yj, aj, yt, at = _both(jp, tp, _x(0, (2, 8, 32)), BASE)
    assert yt.shape == (2, 8, 32) and np.isfinite(yt).all() and at > 0
    np.testing.assert_allclose(yt, yj, **Y_TOL)
    np.testing.assert_allclose(at, aj, **AUX_TOL)


def test_matches_dense_expert_loop():
    """Capacity-dispatch output == naive per-token top-k expert loop, and
    == the reference."""
    cfg = BASE
    jp, tp = init_moe(cfg, seed=1)
    x = _x(1, (1, 6, 32))
    yj, _, yt, _ = _both(jp, tp, x, cfg)

    xf = x[1].numpy().reshape(-1, 32)
    logits = xf @ tp["router"].numpy().astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        top = np.argsort(-probs[t])[: cfg.top_k]
        g = probs[t, top] / probs[t, top].sum()
        for e, gv in zip(top, g):
            act = xf[t] @ tp["w_gate"][e].numpy()
            act = act / (1 + np.exp(-act))  # silu
            hid = act * (xf[t] @ tp["w_up"][e].numpy())
            want[t] += gv * (hid @ tp["w_down"][e].numpy())
    np.testing.assert_allclose(yt.reshape(-1, 32), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(yt, yj, **Y_TOL)


def test_capacity_drops_tokens():
    """With capacity_factor ~0, (almost) everything is dropped: the same
    token rows are exactly zero as in the reference."""
    cfg = dataclasses.replace(BASE, capacity_factor=0.01)
    jp, tp = init_moe(cfg)
    x = _x(0, (2, 64, 32))
    yj, _, yt, _ = _both(jp, tp, x, cfg)
    _, _, yt_full, _ = _both(jp, tp, x, BASE)
    zero_t = np.abs(yt).max(-1) < 1e-7
    assert zero_t.sum() > 0
    np.testing.assert_array_equal(zero_t, np.abs(yj).max(-1) < 1e-7)
    assert np.abs(yt).sum() < np.abs(yt_full).sum()
    np.testing.assert_allclose(yt, yj, **Y_TOL)


@pytest.mark.parametrize("factor", [0.01, 0.25, 1.25, 8.0, 64.0])
def test_capacity_formula(factor):
    cfg = dataclasses.replace(BASE, capacity_factor=factor)
    assert capacity(128, BASE) == max(8, -(-int(8.0 * 128 * 2 / 4) // 8) * 8)
    assert capacity(1, BASE) >= 8
    for n in (1, 7, 8, 64, 100, 127, 128, 129, 1000, 1024, 8192):
        assert capacity(n, cfg) == RM.capacity(n, _ref(cfg)), n
    q = TC.get_config("qwen2-moe-a2.7b")
    assert (capacity(1024, q), capacity(8, q)) == (88, 8)  # prefill's C(S), decode's C(B)


def test_shared_expert_branch():
    """The shared branch contributes even when the router is zeroed (every
    choice a tie: both packages pick the lowest experts)."""
    cfg = dataclasses.replace(BASE, n_shared_experts=1, shared_expert_d_ff=16)
    jp, tp = init_moe(cfg)
    x = _x(0, (1, 4, 32))
    yj, _, yt, _ = _both(jp, tp, x, cfg)
    np.testing.assert_allclose(yt, yj, **Y_TOL)
    jp0, tp0 = dict(jp, router=jnp.zeros_like(jp["router"])), dict(tp)
    tp0["router"] = torch.zeros_like(tp["router"])
    yj0, _, yt0, _ = _both(jp0, tp0, x, cfg)
    assert np.abs(yt0).sum() > 0
    np.testing.assert_allclose(yt0, yj0, **Y_TOL)
    d = dispatch(x[1], tp0["router"], cfg, grouped=True)
    assert (d.expert_idx == torch.arange(cfg.top_k)).all()


def test_dense_residual_branch():
    cfg = dataclasses.replace(BASE, dense_residual=True)
    jp, tp = init_moe(cfg)
    x = _x(0, (1, 4, 32))
    yj, _, y_with, _ = _both(jp, tp, x, cfg)
    np.testing.assert_allclose(y_with, yj, **Y_TOL)
    y_moe_only = apply_moe({k: v for k, v in tp.items() if k != "dense"}, x[1],
                           dataclasses.replace(cfg, dense_residual=False))[0]
    assert not np.allclose(y_with, y_moe_only.numpy())


def test_aux_loss_balanced_vs_skewed():
    """Uniform routing minimizes the Switch load-balance loss (=1); both
    losses equal the reference's."""
    T_, E = 1024, 8
    rng = np.random.default_rng(0)
    uniform = np.full((T_, E), 1.0 / E, np.float32)
    idx_uniform = rng.integers(0, E, size=(T_, 2))
    skew = np.zeros((T_, E), np.float32)
    skew[:, 0] = 1.0
    idx_skew = np.zeros((T_, 2), np.int64)
    l_u = float(router_aux_loss(torch.from_numpy(uniform), torch.from_numpy(idx_uniform), E))
    l_s = float(router_aux_loss(torch.from_numpy(skew), torch.from_numpy(idx_skew), E))
    assert l_u == pytest.approx(1.0, rel=0.1)
    assert l_s > 4 * l_u
    for got, p, i in ((l_u, uniform, idx_uniform), (l_s, skew, idx_skew)):
        want = float(RM.router_aux_loss(jnp.asarray(p), jnp.asarray(i.astype(np.int32)), E))
        np.testing.assert_allclose(got, want, **AUX_TOL)


@settings(max_examples=12, deadline=None)
@given(
    t=st.integers(1, 40),
    e=st.sampled_from([2, 4, 8]),
    k=st.integers(1, 2),
)
def test_property_dropless_preserves_token_mass(t, e, k):
    """With huge capacity, every token is processed by exactly k experts:
    no token row is zero, nothing is dropped, and y is the reference's."""
    cfg = dataclasses.replace(BASE, n_experts=e, top_k=min(k, e), capacity_factor=64.0)
    jp, tp = init_moe(cfg, seed=t)
    x = _x(t, (1, t, 32))
    yj, _, yt, _ = _both(jp, tp, x, cfg)
    assert np.isfinite(yt).all()
    assert (np.abs(yt).max(-1) > 0).all()
    assert bool(dispatch(x[1], tp["router"], cfg, grouped=t > 1).keep.all())
    np.testing.assert_allclose(yt, yj, **Y_TOL)


# --------------------------------------------------------- against the reference


def _reference_trace(monkeypatch):
    """Record the reference's ``expert_idx`` (its ``router_aux_loss``
    argument) and its gathered ``xe`` (its ``shard`` argument)."""
    seen = {}
    aux, shard = RM.router_aux_loss, RM.shard

    def spy_aux(probs, idx, n):
        seen["expert_idx"] = np.asarray(idx)
        return aux(probs, idx, n)

    def spy_shard(x, *axes):
        if "capacity" in axes and "embed" in axes:
            seen["xe"] = np.asarray(x)
        return shard(x, *axes)

    monkeypatch.setattr(RM, "router_aux_loss", spy_aux)
    monkeypatch.setattr(RM, "shard", spy_shard)
    return seen


def _slots_from_rows(xe, xpad):
    """The token of each slot, read back from gathered rows: the index of
    the row of ``xpad`` (G, n+1, D) that each (G, E, C, D) slot holds."""
    G, E, C, _ = xe.shape
    out = np.empty((G, E, C), np.int64)
    for g in range(G):
        index = {xpad[g, t].tobytes(): t for t in range(xpad.shape[1])}
        assert len(index) == xpad.shape[1], "token rows must be distinct"
        for e in range(E):
            for c in range(C):
                out[g, e, c] = index[xe[g, e, c].tobytes()]
    return out


ROUTING_CASES = {
    "dropless": dict(),
    "drops": dict(capacity_factor=0.25),
    "zero-router": dict(capacity_factor=0.25),
    "qwen2-moe-like": dict(n_experts=60, top_k=4, n_shared_experts=1, shared_expert_d_ff=16,
                           capacity_factor=1.25),
}


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_routing_integers_equal_the_reference(case, grouped, monkeypatch):
    """``expert_idx``, the slot table and so the kept and dropped choices,
    exactly; then ``y``.  The global dispatch is the reference's for
    S == 1 (decode); here it runs on B = 24 one-token rows."""
    cfg = dataclasses.replace(BASE, **ROUTING_CASES[case])
    jp, tp = init_moe(cfg, seed=3)
    if case == "zero-router":
        jp["router"], tp["router"] = jnp.zeros_like(jp["router"]), torch.zeros_like(tp["router"])
    x = _x(4, (3, 40, 32) if grouped else (24, 1, 32))
    seen = _reference_trace(monkeypatch)
    yj, aj, yt, at = _both(jp, tp, x, cfg)
    d = dispatch(x[1], tp["router"], cfg, grouped=grouped)

    K = cfg.top_k
    np.testing.assert_array_equal(d.expert_idx.reshape(-1, K).numpy(), seen["expert_idx"])
    xs = x[1].reshape(d.tok_map.shape[0], -1, 32).numpy()
    xpad = np.concatenate([xs, np.zeros((xs.shape[0], 1, 32), np.float32)], axis=1)
    xe = seen["xe"] if grouped else seen["xe"][None]
    np.testing.assert_array_equal(_slots_from_rows(xe, xpad), d.tok_map.numpy())
    n_drop = int((~d.keep).sum())
    if case == "dropless":
        assert n_drop == 0
    elif case in ("drops", "zero-router"):
        assert n_drop > 0  # the cases meant to drop do drop
    kept = {(g, int(t) // K, int(e)) for g, (ef, kp) in enumerate(zip(
        d.expert_idx.reshape(d.keep.shape).numpy(), d.keep.numpy()))
        for t, (e, k) in enumerate(zip(ef, kp)) if k}
    slots = {(g, int(t), e) for g in range(xe.shape[0]) for e in range(cfg.n_experts)
             for t in _slots_from_rows(xe, xpad)[g, e] if t < xs.shape[1]}
    assert kept == slots  # the kept choices are the reference's slot contents
    np.testing.assert_allclose(yt, yj, **Y_TOL)
    np.testing.assert_allclose(at, aj, **AUX_TOL)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_bf16_combine_is_bitwise_the_reference(grouped):
    """The combine on bf16 slot contents (``ye * gate_map``, rounded to
    bf16 as the reference rounds it) equals the reference's scatter-add of
    the flattened (e, c) updates bit for bit: each token's contributions
    added in ascending expert order to a bf16 zero.  The contributions are
    spread over seven binades so that the order shows."""
    cfg = dataclasses.replace(BASE, n_experts=8, top_k=4, capacity_factor=0.5)
    _, tp = init_moe(cfg, seed=5)
    x = _x(6, (2, 48, 32) if grouped else (40, 1, 32), jnp.bfloat16)
    d = dispatch(x[1], tp["router"].to(torch.bfloat16), cfg, grouped=grouped)
    G, E, C = d.tok_map.shape
    n, D, K = d.probs.shape[1], 32, cfg.top_k
    rng = np.random.default_rng(7)
    ye = rng.standard_normal((G, E, C, D)) * 2.0 ** rng.integers(-3, 4, (G, E, C, 1))
    ye_t = torch.from_numpy(ye.astype(np.float32)).to(torch.bfloat16)
    weighted = ye_t * d.gate_map[..., None]
    got = combine(weighted, d.expert_idx.reshape(G, n * K), d.pos, d.keep, K)

    # the reference's combine (repro/models/moe.py, _apply_moe_global and
    # _apply_moe_grouped) on the same slot contents and slot table
    w = jnp.asarray(weighted.float().numpy()).astype(jnp.bfloat16)
    tok_map = jnp.asarray(d.tok_map.numpy())
    if grouped:
        brange = jnp.arange(G)[:, None]
        want = jnp.zeros((G, n + 1, D), jnp.bfloat16).at[brange, tok_map.reshape(G, -1)].add(
            w.reshape(G, -1, D))[:, :n]
    else:
        want = jnp.zeros((n + 1, D), jnp.bfloat16).at[tok_map[0].reshape(-1)].add(
            w[0].reshape(-1, D))[:n][None]
    assert int((~d.keep).sum()) > 0
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # the same contributions in another order round differently somewhere
    naive = torch.zeros_like(got)
    for k in reversed(range(K)):
        e, pos, keep = (t.reshape(G, n, K)[..., k] for t in (
            d.expert_idx.reshape(G, n * K), d.pos, d.keep))
        row = weighted[torch.arange(G)[:, None], e, pos.clamp(max=C - 1).long()]
        naive = naive + torch.where(keep[..., None], row, torch.zeros((), dtype=row.dtype))
    assert not torch.equal(naive, got)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_bf16_layer_against_the_reference(grouped):
    cfg = dataclasses.replace(BASE, n_shared_experts=1, shared_expert_d_ff=16,
                              dense_residual=True, capacity_factor=1.0)
    jp, tp = init_moe(cfg, seed=8)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = _to_port(jp)
    x = _x(9, (2, 24, 32) if grouped else (16, 1, 32), jnp.bfloat16)
    yj, aj, yt, at = _both(jp, tp, x, cfg)
    np.testing.assert_allclose(yt, yj, **BF16_TOL)
    np.testing.assert_allclose(at, aj, rtol=1e-5)


#: the MoE layer's gradient (f32) against the reference's ``jax.grad``:
#: the products and sums of the backward run in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_FLAVOURS = {
    "shared": dict(n_shared_experts=1, shared_expert_d_ff=16),
    "dense-residual": dict(dense_residual=True),
}


def _layer_grads(cfg, grouped):
    """The gradients of ``sum(y * r)`` and of the aux loss with respect to
    every leaf of the MoE layer's params and to ``x``, in both packages:
    ``{(loss, leaf path): (port, reference)}``.  Capacity factor 1.0, so
    the grouped case drops choices."""
    jp, tp = init_moe(cfg, seed=5)
    x = _x(6, (2, 24, 32) if grouped else (16, 1, 32))
    r = np.random.default_rng(7).standard_normal(x[1].shape).astype(np.float32)
    out = {}
    for name, pick in (("y", lambda y, a, r: (y * r).sum()), ("aux", lambda y, a, r: a)):
        jg = jax.grad(lambda p, xx: pick(*RM.apply_moe(p, xx, _ref(cfg)), jnp.asarray(r)),
                      argnums=(0, 1))(jp, x[0])
        wrt = [t.clone().requires_grad_(True) for t in tree_leaves(tp)] + [x[1].clone()]
        wrt[-1].requires_grad_(True)
        loss = pick(*apply_moe(tree_unflatten(tp, wrt[:-1]), wrt[-1], cfg), torch.from_numpy(r))
        tg = (torch.autograd.grad(loss, wrt, materialize_grads=True) if loss.requires_grad
              else [torch.zeros_like(t) for t in wrt])  # a loss cut off from every leaf
        # both trees' leaves in sorted-key order
        want = [(jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_leaves_with_path(jg[0])] + [("x", jg[1])]
        for g, (k, w) in zip(tg, want, strict=True):
            out[name, k] = (g.numpy(), np.asarray(w))
    return out


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("flavour", list(GRAD_FLAVOURS))
def test_layer_gradients_equal_the_reference(flavour, grouped):
    """The backward of the MoE layer, the router's and the shared gate's
    share included, leaf by leaf and for the output's and the aux loss's
    part each on its own (the aux loss's gradient is too small to show in
    a train step at ``router_aux_weight`` 0.001)."""
    cfg = dataclasses.replace(BASE, capacity_factor=1.0, **GRAD_FLAVOURS[flavour])
    grads = _layer_grads(cfg, grouped)
    assert np.abs(grads["aux", "['router']"][1]).max() > 0
    for key, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, err_msg=str(key), **GRAD_TOL)


MOE_ARCHS = ["qwen2-moe-a2.7b", "arctic-480b"]


def _train_steps(arch, n):
    """``n`` steps of the reduced config in both packages, each port step
    from the reference's carried state: yields ``(tcfg, tstate, tm,
    jstate, jm, opt)`` after each."""
    jcfg = JC.reduce_for_smoke(JC.get_config(arch))
    tcfg = TC.reduce_for_smoke(TC.get_config(arch))
    jmodel, tmodel = JModel(jcfg), Model(tcfg)
    opt = dict(lr=3e-3, total_steps=30, warmup_steps=3)
    jstate = J.init_state(jmodel, jax.random.PRNGKey(3))
    jstep = jax.jit(J.make_train_step(jmodel, J.AdamWConfig(**opt)))
    tstep = T.make_train_step(tmodel, T.AdamWConfig(**opt))
    jit_ = J.batch_iterator(jcfg, 2, 32, seed=1)
    tit = T.batch_iterator(tcfg, 2, 32, seed=1, device=CPU)
    for _ in range(n):
        carried = T.TrainState(
            params_from_reference(tcfg, jax.tree.map(np.asarray, jstate.params), device=CPU),
            T.AdamWState(
                torch.tensor(int(jstate.opt.step), dtype=torch.int32),
                *(params_from_reference(tcfg, jax.tree.map(np.asarray, t), device=CPU)
                  for t in (jstate.opt.m, jstate.opt.v)),
            ),
        )
        jstate, jm = jstep(jstate, next(jit_))
        tstate, tm = tstep(carried, next(tit))
        yield tcfg, tstate, tm, jstate, jm, T.AdamWConfig(**opt)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_equals_the_reference(arch):
    """Two steps of the reduced config (arctic's with ``remat``), each from
    the reference's carried state, with ``router_aux_weight * router_aux``
    in the loss."""
    for tcfg, tstate, tm, jstate, jm, opt in _train_steps(arch, 2):
        assert tcfg.remat == (arch == "arctic-480b")
        assert float(tm["router_aux"]) > 0
        for k in ("loss", "ce", "router_aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=WIDE_GNORM_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **LR_TOL)
        _assert_step_close(tcfg, tstate, jstate, opt, wide=True)


def _gates_detached(route):
    def planted(*args):
        probs, gates, idx = route(*args)
        return probs, gates.detach(), idx
    return planted


def _aux_detached(aux_loss):
    return lambda probs, *args: aux_loss(probs.detach(), *args)


def _shared_gate_detached(always_on):
    return lambda p, *args: always_on(dict(p, shared_gate=p["shared_gate"].detach()), *args)


#: planted faults in the gradient of one small leaf (``router``,
#: ``shared_gate``; the forward unchanged): the function of
#: ``repro_torch.models.moe`` replaced, its faulty wrapper, the gradient
#: of the layer that must show it, and whether the reduced qwen2-moe's
#: train step must show it too (the aux loss's share of the router's
#: gradient, at ``router_aux_weight`` 0.001, lies inside the step's
#: tolerance)
FAULTS = {
    "routed gates detached": ("route", _gates_detached, ("y", "['router']"), True),
    "aux loss detached": ("router_aux_loss", _aux_detached, ("aux", "['router']"), False),
    "shared gate detached": ("_always_on", _shared_gate_detached, ("y", "['shared_gate']"),
                             True),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_gradient_checks_catch_a_planted_fault(fault, monkeypatch):
    """The gradient checks above fail on a wrong gradient of a small leaf:
    the layer's on that leaf, and the train step's on a moment (held on
    every leaf, however small), though the loss is unchanged."""
    import repro_torch.models.moe as M

    name, plant, bad_leaf, in_step = FAULTS[fault]
    monkeypatch.setattr(M, name, plant(getattr(M, name)))
    cfg = dataclasses.replace(BASE, capacity_factor=1.0, **GRAD_FLAVOURS["shared"])
    grads = _layer_grads(cfg, grouped=True)
    assert not np.allclose(*grads[bad_leaf], **GRAD_TOL)
    if in_step:
        tcfg, tstate, tm, jstate, jm, opt = next(_train_steps("qwen2-moe-a2.7b", 1))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
        with pytest.raises(AssertionError, match=r"[mv]\['"):
            _assert_step_close(tcfg, tstate, jstate, opt, wide=True)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_float32_step_against_a_wide_step(arch):
    """Why the train step is held at the wide limits: the reduced MoE
    configs' float32 step lies further than ``rtol=1e-5`` from the same
    step computed in float64 in its gradient norm, and within the limits
    the reduced yi-9b's step is held to."""
    opt = T.AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3)
    gm, wm, readings = _wide_readings(TC.reduce_for_smoke(TC.get_config(arch)), opt)
    gap = abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) / float(wm["grad_norm"])
    print(f"{arch}: grad_norm {float(gm['grad_norm'])} against {float(wm['grad_norm'])} wide "
          f"({gap:.3g} relative); off {STATE_TOL} share, largest difference: {readings}")
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), **LOSS_TOL)
    assert LOSS_TOL["rtol"] < gap <= WIDE_GNORM_RTOL, gap
    assert readings["params"][0] > 1e-3  # the 0.1% share of the well-conditioned configs
    for name, (share, _) in readings.items():
        assert share <= WIDE_OFF_SHARE, (name, share)
    assert readings["params"][1] <= 2 * opt.lr
