"""The port's logical-axis sharding (``repro_torch.sharding``) against the
reference's (``repro.sharding``), on the CPU.

``resolve_spec`` must give the reference's ``PartitionSpec`` entries for
every parameter of every architecture, under the default, train and serve
rules and every rule set of the perf variants, on the production meshes and
small ones.  The reference reads only a mesh's ``axis_names`` and
``devices.shape``, so a stub stands in for its mesh; the port also reads a
``DeviceMesh``'s ``mesh_dim_names`` and ``shape``, which a second stub
gives.  The parameters' logical specs map to the reference's stacked tree,
and ``shard`` is the identity outside ``use_sharding``.
"""
from __future__ import annotations

import contextlib
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.sharding import DEFAULT_RULES as REF_DEFAULT, resolve_spec as ref_resolve  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import perf as port_perf  # noqa: E402
from repro_torch.launch import steps as port_steps  # noqa: E402
from repro_torch.models.carry import specs_to_reference  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    DEFAULT_RULES,
    current_ctx,
    placements_for,
    resolve_spec,
    shard,
    spec_for_shape,
)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
}


def ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def port_mesh(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape, ndim=len(shape))


@contextlib.contextmanager
def _environ_kept():
    """The reference's ``launch/perf.py`` sets XLA_FLAGS (512 devices) when
    it is imported; keep this process's environment as it was."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def rule_sets():
    import jax

    jax.devices()  # the backend is up before the reference's perf module is read
    with _environ_kept():
        from repro.launch import perf as ref_perf
        from repro.launch import steps as ref_steps
    sets = {"default": (REF_DEFAULT, DEFAULT_RULES),
            "train": (ref_steps.TRAIN_RULES, port_steps.TRAIN_RULES),
            "serve": (ref_steps.SERVE_RULES, port_steps.SERVE_RULES)}
    assert set(port_perf.VARIANTS) == set(ref_perf.VARIANTS)
    for name, v in ref_perf.VARIANTS.items():
        assert port_perf.VARIANTS[name]["rules"] == v["rules"], name
        assert port_perf.VARIANTS[name]["cfg_patch"] == v["cfg_patch"], name
        if v["rules"]:
            sets[name] = (dict(REF_DEFAULT, **v["rules"]),
                          dict(DEFAULT_RULES, **port_perf.VARIANTS[name]["rules"]))
    return sets


def stacked_leaves(cfg):
    """(name, reference-layout shape, logical) of every parameter, from the
    port's abstract parameters and logical specs."""
    model = Model(cfg)
    stacks = model.stack_sizes()
    specs = specs_to_reference(cfg, model.param_logical_specs())
    out = []

    def walk(name, p, lg, stack):
        if isinstance(p, dict):
            for k in p:
                walk(f"{name}/{k}", p[k], lg[k], stack)
        else:
            out.append((name, ((stack,) if stack else ()) + tuple(p.shape), lg))

    for k, p in model.abstract_params().items():
        if k in stacks:
            walk(k, p[0], specs[k], stacks[k])
        else:
            walk(k, p, specs[k], 0)
    return out


def test_rules_tables_match_the_reference():
    for name, (ref, port) in rule_sets().items():
        assert ref == port, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_matches_the_reference_for_every_parameter(arch):
    leaves = stacked_leaves(get_config(arch))
    assert all(p.device.type == "meta" for p in
               torch.utils._pytree.tree_leaves(Model(get_config(arch)).abstract_params()))
    for rname, (ref_rules, port_rules) in rule_sets().items():
        for mname, (shape, names) in MESHES.items():
            rm, pm = ref_mesh(shape, names), port_mesh(shape, names)
            for leaf, pshape, logical in leaves:
                want = tuple(ref_resolve(pshape, logical, rm, ref_rules))
                got = resolve_spec(pshape, logical, pm, port_rules)
                assert got == want, (arch, rname, mname, leaf, pshape, logical)
                assert resolve_spec(pshape, logical, rm, port_rules) == want
                pl = placements_for(pshape, logical, pm, port_rules)
                for axis, p in zip(names, pl):
                    dims = [d for d, e in enumerate(got) if e == axis or
                            isinstance(e, tuple) and axis in e]
                    assert (p.is_shard() and [p.dim] == dims) or (p.is_replicate() and not dims)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_specs_map_to_the_references_tree(arch):
    cfg = get_config(arch)
    assert specs_to_reference(cfg, Model(cfg).param_logical_specs()) == \
        RefModel(ref_config(arch)).param_logical_specs()


def test_resolve_cases_of_the_reference():
    """``tests/test_sharding.py``'s cases: divisibility fallback, no axis
    used twice, composite axes."""
    m44 = port_mesh((4, 4), ("data", "model"))
    assert resolve_spec((128, 64), ("vocab", "embed"), port_mesh((1, 1), ("data", "model")),
                        DEFAULT_RULES) == ("model",)
    assert resolve_spec((8, 4, 64), (None, "kv_heads", None), m44) == (None, "model")
    assert resolve_spec((8, 3, 64), (None, "kv_heads", None), m44) == ()
    rules = dict(DEFAULT_RULES, embed="data")
    assert resolve_spec((16, 8, 64), ("batch", None, "embed"), m44, rules) == ("data",)
    assert resolve_spec((8, 16), ("batch", None),
                        port_mesh((2, 2, 2), ("pod", "data", "model"))) == (("pod", "data"),)
    with pytest.raises(ValueError, match="rank"):
        resolve_spec((8, 16), ("batch",), m44)


def test_shard_is_the_identity_outside_a_context():
    x = torch.ones(4, 4)
    assert shard(x, "batch", None) is x
    assert current_ctx() == (None, DEFAULT_RULES)
    assert spec_for_shape((4, 4), ("batch", None)) == ()
