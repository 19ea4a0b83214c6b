"""npz checkpoints across the two packages, on the CPU.

A checkpoint written by the reference (``{"params": ...}`` and a whole
``TrainState`` after a train step) restores into the port, and one the
port writes restores into the reference: the same keys, one for one, the
same ``__step__``, and every array equal bit for bit (the port's per-layer
list is written as the reference's stacked leaves).
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.training as J  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.training as T  # noqa: E402
from repro_torch.models import Model, params_from_reference, params_to_reference  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

CPU = "cpu"


def _pair(arch):
    return JC.reduce_for_smoke(JC.get_config(arch)), TC.reduce_for_smoke(TC.get_config(arch))


def _trained(arch):
    """The reference's state after one step, and the port's copy of it."""
    jcfg, tcfg = _pair(arch)
    jmodel = JModel(jcfg)
    jstate = J.init_state(jmodel, jax.random.PRNGKey(0))
    step = jax.jit(J.make_train_step(jmodel, J.AdamWConfig(warmup_steps=1, total_steps=4)))
    jstate, _ = step(jstate, next(J.batch_iterator(jcfg, 2, 16)))

    def carry(t):
        return params_from_reference(tcfg, jax.tree.map(np.asarray, t), device=CPU)

    tstate = T.TrainState(carry(jstate.params), T.AdamWState(
        torch.tensor(int(jstate.opt.step), dtype=torch.int32),
        carry(jstate.opt.m), carry(jstate.opt.v)))
    return tcfg, jstate, tstate


def _assert_files_equal(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


ARCHS = ["yi-9b", "mamba2-130m", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_into_the_port(arch, tmp_path):
    tcfg, jstate, tstate = _trained(arch)
    for tree, like, step in (({"params": jstate.params}, {"params": tstate.params}, 7),
                             (jstate, tstate, 1)):
        path = J.save_checkpoint(str(tmp_path / "ref.npz"), tree, step=step)
        got, got_step = T.restore_checkpoint(path, like)
        assert got_step == step
        for a, b in zip(tree_leaves(got), tree_leaves(like)):
            assert a.dtype == b.dtype and a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_into_the_reference(arch, tmp_path):
    tcfg, jstate, tstate = _trained(arch)
    for tree, jtree, step in (({"params": tstate.params}, {"params": jstate.params}, 3),
                              (tstate, jstate, 1)):
        path = T.save_checkpoint(str(tmp_path / "port.npz"), tree, step=step)
        ref_path = J.save_checkpoint(str(tmp_path / "ref.npz"), jtree, step=step)
        _assert_files_equal(path, ref_path)  # key for key, array for array
        # the reference's restore rebuilds a NamedTuple by ``type(node)(vals)``,
        # which a TrainState does not take: its template is the plain tuples
        # of the same leaves and keys
        like = jtree if isinstance(jtree, dict) else (
            jtree.params, (jtree.opt.step, jtree.opt.m, jtree.opt.v))
        got, got_step = J.restore_checkpoint(path, like)
        assert got_step == step
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_params_round_trip_through_the_reference_layout():
    jcfg, tcfg = _pair("zamba2-1.2b")
    jparams = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(2)))
    back = params_to_reference(tcfg, params_from_reference(tcfg, jparams, device=CPU))
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        params_to_reference(TC.reduce_for_smoke(TC.get_config("yi-9b")),
                            params_from_reference(tcfg, jparams, device=CPU))


def test_bf16_leaves_round_trip(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(TC.reduce_for_smoke(TC.get_config("mamba2-130m")),
                              param_dtype="bfloat16", dtype="bfloat16")
    params = Model(cfg).init(0, device=CPU)
    path = T.save_checkpoint(os.path.join(tmp_path, "bf16.npz"), {"params": params}, step=2)
    got, step = T.restore_checkpoint(path, {"params": params})
    assert step == 2
    for a, b in zip(tree_leaves(got), tree_leaves({"params": params})):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with np.load(path) as f:
        assert f["params/layers/mamba/in_proj"].shape[0] == cfg.num_layers


def test_missing_key_raises_across_packages(tmp_path):
    tcfg, jstate, tstate = _trained("yi-9b")
    path = T.save_checkpoint(str(tmp_path / "p.npz"), {"params": tstate.params})
    with pytest.raises(ValueError, match="missing"):
        J.restore_checkpoint(path, {"params": jstate.params, "extra": jstate.opt.m})
    path = J.save_checkpoint(str(tmp_path / "j.npz"), {"params": jstate.params})
    with pytest.raises(ValueError, match="missing"):
        T.restore_checkpoint(path, tstate)
