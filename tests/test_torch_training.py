"""The port's training substrate against the JAX reference, on the CPU.

Mirrors ``tests/test_training.py`` case for case (AdamW against its
formula, clipping, the schedule's shape, uniform CE, the loss falling over
30 steps, data determinism, the checkpoint round trip, the missing key),
then holds the port against the live reference:

* AdamW on the same tree, the schedule at every step, the masked CE;
* ``batch_iterator``'s tokens equal to the reference's;
* three train steps from carried weights on the same batches, for a
  dense config (with and without ``remat``), an ssm and a hybrid one,
  against the reference's jitted ``jax.value_and_grad`` + ``adamw_update``;
* the eval step;
* the plain route taken because the loss asks for it, and the kernels'
  no-backward guard.

Stated tolerances (f32): loss and ``ce`` ``rtol=1e-5``; ``grad_norm``
``rtol=1e-5`` (the reference sums squares over its stacked leaves in
sorted-key order, the port over per-layer leaves, so the order differs);
the learning rate ``rtol=1e-6`` (``torch.cos`` and XLA's cosine may differ
in the last bit); ``m`` and ``v`` after each of three steps ``rtol=1e-4,
atol=1e-6``, and the parameters to the same on all but 0.1% of their
elements (see :func:`_assert_step_close`: the forward and backward sum
their products in another order than XLA's, and AdamW's normalized step
amplifies the rounding difference of a small gradient).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

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
from repro_torch.kernels.common import (  # noqa: E402
    check_no_grad,
    model_backend,
    resolve_model_backend,
)
from repro_torch.models import Model, params_from_reference, params_to_reference  # noqa: E402
from repro_torch.training.optimizer import global_norm, tree_leaves, tree_unflatten  # noqa: E402

CPU = "cpu"
LOSS_TOL = dict(rtol=1e-5)
LR_TOL = dict(rtol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
DENSE = dict(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=256, scan_layers=False)
CFG = TC.base.ModelConfig(**DENSE)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------ tests/test_training.py's cases


def test_adamw_matches_reference():
    """One AdamW step vs a hand-rolled numpy reference."""
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))}
    cfg = T.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1,
                        grad_clip=1e9)
    st = T.adamw_init(p)
    new_p, st2, m = T.adamw_update(g, st, p, cfg)

    lr = float(T.cosine_schedule(cfg)(torch.tensor(1, dtype=torch.int32)))
    gw = g["w"].numpy()
    mw = 0.1 * gw
    vw = 0.05 * gw ** 2
    mhat = mw / (1 - 0.9)
    vhat = vw / (1 - 0.95)
    want = p["w"].numpy() - lr * (mhat / (np.sqrt(vhat) + 1e-8) + 0.1 * p["w"].numpy())
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5, atol=1e-6)
    assert int(st2.step) == 1 and st2.m["w"].dtype == torch.float32


def test_grad_clip_scales():
    p = {"w": torch.ones((2, 2))}
    g = {"w": torch.full((2, 2), 100.0)}
    cfg = T.AdamWConfig(grad_clip=1.0, warmup_steps=0, weight_decay=0.0)
    _, _, metrics = T.adamw_update(g, T.adamw_init(p), p, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-5)


def test_cosine_schedule_shape():
    cfg = T.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    s = T.cosine_schedule(cfg)
    i32 = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
    assert float(s(i32(0))) == 0.0
    assert float(s(i32(10))) == pytest.approx(1.0)
    assert float(s(i32(100))) == pytest.approx(0.1, rel=1e-3)
    assert float(s(i32(55))) < 1.0


def test_cross_entropy_uniform():
    V = 16
    logits = torch.zeros((2, 3, V))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    assert float(T.cross_entropy(logits, labels)) == pytest.approx(np.log(V), rel=1e-5)


def test_loss_decreases_over_steps():
    model = Model(CFG)
    step = T.make_train_step(model, T.AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3))
    state = T.init_state(model, 0, device=CPU)
    it = T.batch_iterator(CFG, 8, 32, seed=0, device=CPU)
    losses = []
    for _ in range(30):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_data_deterministic():
    a = T.SyntheticLM(256, seed=7).sample(np.random.default_rng(1), 2, 16)
    b = T.SyntheticLM(256, seed=7).sample(np.random.default_rng(1), 2, 16)
    np.testing.assert_array_equal(a, b)
    batch = T.make_batch(CFG, 2, 16, np.random.default_rng(0), device=CPU)
    np.testing.assert_array_equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])


def test_checkpoint_roundtrip_trainstate():
    model = Model(CFG)
    state = T.init_state(model, 0, device=CPU)
    tree = {"params": state.params, "m": state.opt.m}
    with tempfile.TemporaryDirectory() as d:
        path = T.save_checkpoint(os.path.join(d, "ck.npz"), tree, step=5)
        restored, step = T.restore_checkpoint(path, tree)
    assert step == 5
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_missing_key_raises():
    with tempfile.TemporaryDirectory() as d:
        path = T.save_checkpoint(os.path.join(d, "ck.npz"), {"a": torch.ones(3)})
        with pytest.raises(ValueError):
            T.restore_checkpoint(path, {"a": torch.ones(3), "b": torch.ones(2)})


# ------------------------------------------------------- against the reference


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_adamw_update_equals_the_reference(clip):
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    p, g = _tree(rng, shapes), _tree(rng, shapes)
    cfg = dict(lr=3e-3, warmup_steps=2, total_steps=9, grad_clip=clip)
    jp, jst = jax.tree.map(jnp.asarray, p), J.adamw_init(jax.tree.map(jnp.asarray, p))
    tp, tst = {k: _t(v) for k, v in p.items()}, T.adamw_init({k: _t(v) for k, v in p.items()})
    for _ in range(4):
        jp, jst, jm = J.adamw_update(jax.tree.map(jnp.asarray, g), jst, jp, J.AdamWConfig(**cfg))
        tp, tst, tm = T.adamw_update({k: _t(v) for k, v in g.items()}, tst, tp,
                                     T.AdamWConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **LR_TOL)
    assert int(tst.step) == int(jst.step) == 4
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **STATE_TOL)
        np.testing.assert_allclose(tst.m[k].numpy(), np.asarray(jst.m[k]), **STATE_TOL)
        np.testing.assert_allclose(tst.v[k].numpy(), np.asarray(jst.v[k]), **STATE_TOL)


def test_schedule_equals_the_reference_at_every_step():
    for kw in (dict(lr=3e-3, warmup_steps=5, total_steps=50),
               dict(lr=1e-2, warmup_steps=1, total_steps=8, min_lr_ratio=0.0)):
        js, ts = J.cosine_schedule(J.AdamWConfig(**kw)), T.cosine_schedule(T.AdamWConfig(**kw))
        for n in range(0, kw["total_steps"] + 3):
            np.testing.assert_allclose(float(ts(torch.tensor(n, dtype=torch.int32))),
                                       float(js(jnp.int32(n))), **LR_TOL)


def test_masked_cross_entropy_equals_the_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = J.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        got = T.cross_entropy(_t(logits), _t(labels), None if m is None else _t(m))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_batch_iterator_equals_the_reference():
    jit_, tit = J.batch_iterator(JC.base.ModelConfig(**DENSE), 3, 20, seed=5), \
        T.batch_iterator(CFG, 3, 20, seed=5, device=CPU)
    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def _configs(kind):
    if kind == "ssm":
        j = JC.reduce_for_smoke(JC.get_config("mamba2-130m"))
        t = TC.reduce_for_smoke(TC.get_config("mamba2-130m"))
    elif kind == "hybrid":
        j = JC.reduce_for_smoke(JC.get_config("zamba2-1.2b"))
        t = TC.reduce_for_smoke(TC.get_config("zamba2-1.2b"))
    else:
        remat = kind == "dense-remat"
        j = JC.base.ModelConfig(**DENSE, remat=remat)
        t = TC.base.ModelConfig(**DENSE, remat=remat)
    return j, t


def _flat(tcfg, tree):
    """The port's tree in the reference's layout, by the reference's paths."""
    ref = params_to_reference(tcfg, tree)
    out = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(ref):
        x = ref
        for key in path:
            x = x[key.key]
        out[jax.tree_util.keystr(path)] = x
    return out


def _assert_step_close(tcfg, tstate, jstate, opt, wide=False):
    """``m`` and ``v`` at the stated tolerance everywhere; the parameters
    at the stated tolerance on all but 0.1% of their elements, and every
    element within AdamW's step bound ``2 lr``.  AdamW's normalized step
    ``mhat / (sqrt(vhat) + eps)`` is ill-conditioned for a small gradient:
    it turns the rounding difference of such a gradient (summed in another
    order: up to ~1e-6 absolute in an embedding row whose largest entry is
    ~5; each package's float32 gradient is ~2e-5 relative from a float64
    computation) into a step difference of up to ``2 lr``, though the
    moments agree.  ``wide``: a config whose float32 gradient is itself
    ill-conditioned is held at the wide limits instead: ``m`` and ``v`` at
    the stated tolerance on all but ``WIDE_OFF_SHARE`` of the elements of
    each leaf (so a wrong gradient of any one leaf, however small, fails),
    the parameters on all but ``WIDE_OFF_SHARE`` of their elements, each
    within ``2 lr``."""
    gp, gm, gv = (_flat(tcfg, t) for t in (tstate.params, tstate.opt.m, tstate.opt.v))
    wp, wm, wv = ({jax.tree_util.keystr(p): np.asarray(x)
                   for p, x in jax.tree_util.tree_leaves_with_path(t)}
                  for t in (jstate.params, jstate.opt.m, jstate.opt.v))
    def n_off(got, want):
        return int((np.abs(got - want) > STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(want)).sum())

    p_off = n_all = 0
    for k in wp:
        if wide:
            for name, got, want in (("m", gm[k], wm[k]), ("v", gv[k], wv[k])):
                assert n_off(got, want) <= want.size * WIDE_OFF_SHARE, (f"{name}{k}", want.size)
        else:
            np.testing.assert_allclose(gm[k], wm[k], err_msg=f"m{k}", **STATE_TOL)
            np.testing.assert_allclose(gv[k], wv[k], err_msg=f"v{k}", **STATE_TOL)
        assert np.abs(gp[k] - wp[k]).max(initial=0.0) <= 2 * opt.lr, k
        p_off += n_off(gp[k], wp[k])
        n_all += wp[k].size
    assert p_off <= n_all * (WIDE_OFF_SHARE if wide else 1e-3), (p_off, n_all)
    assert int(tstate.opt.step) == int(jstate.opt.step)


@pytest.mark.parametrize("kind", ["dense", "dense-remat", "ssm", "hybrid"])
def test_train_steps_equal_the_reference(kind):
    """Three steps.  Each port step starts from the reference's state
    (carried), so each step is held on its own: a difference in AdamW's
    ill-conditioned band moves a few parameters by up to 2 lr, which the
    next steps' gradients would carry.  The free-running losses are held
    too."""
    jcfg, tcfg = _configs(kind)
    jmodel, tmodel = JModel(jcfg), Model(tcfg)
    opt = dict(lr=3e-3, total_steps=30, warmup_steps=3)  # test_training.py's schedule
    jstate = J.init_state(jmodel, jax.random.PRNGKey(3))
    jstep = jax.jit(J.make_train_step(jmodel, J.AdamWConfig(**opt)))
    tstep = T.make_train_step(tmodel, T.AdamWConfig(**opt))
    jit_ = J.batch_iterator(jcfg, 2, 32, seed=1)
    tit = T.batch_iterator(tcfg, 2, 32, seed=1, device=CPU)
    free = None
    for _ in range(3):
        carried = T.TrainState(
            params_from_reference(tcfg, jax.tree.map(np.asarray, jstate.params), device=CPU),
            T.AdamWState(
                torch.tensor(int(jstate.opt.step), dtype=torch.int32),
                *(params_from_reference(tcfg, jax.tree.map(np.asarray, t), device=CPU)
                  for t in (jstate.opt.m, jstate.opt.v)),
            ),
        )
        free = carried if free is None else free
        batch = next(tit)
        jstate, jm = jstep(jstate, next(jit_))
        tstate, tm = tstep(carried, batch)
        free, fm = tstep(free, batch)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **LOSS_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **LR_TOL)
        np.testing.assert_allclose(float(fm["loss"]), float(jm["loss"]), **LOSS_TOL)
        _assert_step_close(tcfg, tstate, jstate, T.AdamWConfig(**opt))
    assert int(free.opt.step) == 3
    assert all(not p.requires_grad for p in tree_leaves(tstate.params))


#: a float32 train step held against the same step computed wide (float64
#: parameters and activations; the logits still reach the loss in float32):
#: the gradient norm at ``WIDE_GNORM_RTOL``, and ``m``, ``v`` and the
#: parameters at ``STATE_TOL`` on all but ``WIDE_OFF_SHARE`` of their
#: elements, each parameter within ``2 lr``.  These are the limits that the
#: card's float32 step is held to against the same wide step for the
#: reduced yi-9b (tests/test_torch_training_cuda.py, chip_smoke.py phase 14)
WIDE_GNORM_RTOL, WIDE_OFF_SHARE = 1e-3, 5e-3


def _wide_readings(tcfg, opt):
    """One step of ``tcfg`` in float32 and wide from the same init (seed 1)
    and batch (2 x 64, seed 3): the float32 step's metrics, the wide step's,
    and for ``m``, ``v`` and the parameters the share of elements outside
    ``STATE_TOL`` and the largest difference."""
    state = T.init_state(Model(tcfg), 1, device=CPU)
    batch = next(T.batch_iterator(tcfg, 2, 64, seed=3, device=CPU))
    wcfg = dataclasses.replace(tcfg, dtype="float64", param_dtype="float64")
    wide = tree_unflatten(state.params, [p.double() for p in tree_leaves(state.params)])
    wide = T.TrainState(wide, T.adamw_init(wide))
    got, gm = T.make_train_step(Model(tcfg), opt)(state, batch)
    want, wm = T.make_train_step(Model(wcfg), opt)(wide, batch)
    readings = {}
    for name, a, b in (("m", got.opt.m, want.opt.m), ("v", got.opt.v, want.opt.v),
                       ("params", got.params, want.params)):
        off = n = 0
        worst = 0.0
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            d = (x.double() - y).abs()
            off += int((d > STATE_TOL["atol"] + STATE_TOL["rtol"] * y.abs()).sum())
            n += d.numel()
            worst = max(worst, float(d.max()))
        readings[name] = (off / n, worst)
    return gm, wm, readings


@pytest.mark.parametrize("arch", ["dense", "yi-9b", "mamba2-130m"])
def test_float32_step_against_a_wide_step(arch):
    """How far a float32 train step on the CPU lies from the same step
    computed wide.  The reduced yi-9b's random init gives attention logits
    so sharp that its float32 gradient norm lies ~5.5e-4 from the wide one
    (208.064 against 208.179), fifty times the stated ``grad_norm``
    tolerance: no float32 computation, the card's or the CPU's, can be held
    to another at ``rtol=1e-5`` there, and the moments, scaled by the
    clipped norm, follow.  The well-conditioned configs stay within the
    stated tolerance.  Every config's float32 step meets the wide limits
    the card's step is held to."""
    opt = T.AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3)
    tcfg = CFG if arch == "dense" else TC.reduce_for_smoke(TC.get_config(arch))
    gm, wm, readings = _wide_readings(tcfg, opt)
    gap = abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) / float(wm["grad_norm"])
    print(f"{arch}: grad_norm {float(gm['grad_norm'])} against {float(wm['grad_norm'])} wide "
          f"({gap:.3g} relative); off STATE_TOL share, largest difference: {readings}")
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), **LOSS_TOL)
    if arch == "yi-9b":
        assert gap > 10 * LOSS_TOL["rtol"], gap  # the ill-conditioned norm
    else:
        assert gap <= LOSS_TOL["rtol"], gap
    assert gap <= WIDE_GNORM_RTOL, gap
    for name, (share, worst) in readings.items():
        assert share <= WIDE_OFF_SHARE, (name, share)
    assert readings["params"][1] <= 2 * opt.lr


def test_eval_step_equals_the_reference():
    jcfg, tcfg = _configs("dense")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), device=CPU)
    jb = next(J.batch_iterator(jcfg, 2, 24, seed=2))
    tb = next(T.batch_iterator(tcfg, 2, 24, seed=2, device=CPU))
    want = J.make_eval_step(JModel(jcfg))(jparams, jb)
    got = T.make_eval_step(Model(tcfg))(params, tb)
    assert got["loss"].grad_fn is None
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL)


def test_the_loss_asks_for_the_plain_route(monkeypatch):
    """On the card the default backend follows the device; the train step's
    forward and backward see ``"torch"`` because the loss asks for it."""
    monkeypatch.delenv("REPRO_TORCH_MODEL_BACKEND", raising=False)
    cuda = torch.device("cuda")
    assert resolve_model_backend(None, cuda) == "cuda"
    seen = []
    model = Model(CFG)
    forward = model.forward

    def spy(params, batch):
        seen.append(resolve_model_backend(None, cuda))
        return forward(params, batch)

    monkeypatch.setattr(model, "forward", spy)
    state = T.init_state(model, 0, device=CPU)
    batch = next(T.batch_iterator(CFG, 2, 16, device=CPU))
    T.make_train_step(model, T.AdamWConfig())(state, batch)
    T.make_loss_fn(model)(state.params, batch)
    T.make_eval_step(model)(state.params, batch)
    assert seen == ["torch", "torch", "cuda"]
    assert resolve_model_backend(None, cuda) == "cuda"
    assert resolve_model_backend("cuda", cuda) == "cuda"  # an explicit choice wins
    with model_backend("torch"), model_backend("cuda"):
        assert resolve_model_backend(None, cuda) == "cuda"
    with pytest.raises(ValueError):
        with model_backend("xla"):
            pass


def test_the_guard_refuses_inputs_that_require_grad():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="no backward"):
        check_no_grad("flash_attention", y, x)
    check_no_grad("flash_attention", y, y)
    with torch.no_grad():
        check_no_grad("ssd_scan", x, y)


def test_remat_gives_the_same_gradients():
    cfg = dataclasses.replace(CFG, remat=True)
    state = T.init_state(Model(CFG), 4, device=CPU)
    batch = next(T.batch_iterator(CFG, 2, 16, device=CPU))
    opt = T.AdamWConfig()
    a, ma = T.make_train_step(Model(CFG), opt)(state, batch)
    b, mb = T.make_train_step(Model(cfg), opt)(state, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    torch.testing.assert_close(global_norm(b.params), global_norm(a.params), rtol=0, atol=0)


def test_launch_train_logs_as_the_reference_and_checkpoints(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    path = str(tmp_path / "ck.npz")
    launch_train.main(["--arch", "squeeze-lm", "--steps", "3", "--batch", "2", "--seq", "16",
                       "--ckpt", path, "--device", CPU])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     1 loss=") and " lr=" in out[0] and " gnorm=" in out[0]
    assert out[-2] == f"checkpoint -> {path}" and out[-1].startswith("final loss ")
    jcfg = JC.reduce_for_smoke(JC.get_config("squeeze-lm"))
    like = {"params": JModel(jcfg).init(jax.random.PRNGKey(0))}
    got, step = J.restore_checkpoint(path, like)  # the reference reads the port's file
    assert step == 3
    assert jax.tree.structure(got) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
