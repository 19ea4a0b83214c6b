"""The port's public names against the reference's ``__all__`` lists.

Every name that a reference subpackage exports is on the port's
counterpart, or stands in :data:`DIFFERENCES` below with the reason: a
deliberate difference of the port, or an item still to port, by its
``ROADMAP.md`` §1 number.  A name that the port gains must leave this
list, and a name that the reference gains must be ported or listed.
"""
from __future__ import annotations

import importlib

import pytest

pytest.importorskip("torch")

SUBPACKAGES = [
    "core", "obs", "serving", "models", "training", "configs", "kernels.ops", "launch",
    "sharding", "roofline",
]

DIFFERENCES = {
    "core": {
        # the GUS and class-allocator backend dispatch lives with the kernels,
        # with the port's backends ("torch" | "cuda" for "xla" | "pallas"):
        # kernels/gus.py (gus_assign, gus_assign_ref) and
        # core/options.py::resolve_backend for the first two ...
        "resolve_gus_backend",
        "gus_backend_fn",
        # ... and kernels/hier.py (hier_cells, hier_cells_ref) for the
        # allocator; the port has no numpy allocator (the plain PyTorch
        # version on the CPU is the reference path)
        "hier_cells",
        "hier_cells_np",
        "hier_backend_fn",
        # not a name: with rep_group=None the port cuts the fleet's
        # replications into one group a device (ceil(n_rep / devices)), the
        # reference into groups of FLEET_REP_GROUP = 8 (one compiled program
        # for XLA); rep_group=8 gives the reference's layout, and the
        # results do not depend on the width
    },
    "models": {
        # the reference stacks the layer leaves (init_from_decl(..., stack=));
        # the port keeps one dict per layer (layers.init_tree) and converts
        # in models/carry.py
        "init_from_decl",
    },
    "kernels.ops": {
        "on_tpu",             # TPU only: the port's route follows the tensors' device
    },
    "sharding": {
        # a jax NamedSharding; the port's counterpart gives the DTensor
        # placements of the same layout (sharding.placements_for)
        "named_sharding_for",
    },
    "roofline": {
        # the TPU v5e's rates; the port's spec is the H100's (roofline.H100)
        "V5E",
    },
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_reference_name_is_ported_or_listed(sub):
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    listed = DIFFERENCES.get(sub, set())
    missing = [n for n in ref.__all__ if not hasattr(port, n) and n not in listed]
    assert not missing, f"repro_torch.{sub} lacks {missing}"
    stale = sorted(n for n in listed if hasattr(port, n) or n not in ref.__all__)
    assert not stale, f"listed as differences but ported or not exported: {stale}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_the_port_exports_what_it_lists(sub):
    port = importlib.import_module(f"repro_torch.{sub}")
    assert all(hasattr(port, n) for n in port.__all__)
