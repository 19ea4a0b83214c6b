"""Command-line entry points of the port, the device layouts and the
input specifications of the sharded steps.

``dryrun`` and ``perf`` are not imported here: each sets up a ``fake``
process group of its own and runs as ``python -m``."""
from .mesh import make_fleet_mesh, make_production_mesh, make_test_mesh, mesh_name
from .specs import SHAPES, ShapeSpec, input_specs, model_flops, shape_config

__all__ = [
    "make_fleet_mesh",
    "make_production_mesh",
    "make_test_mesh",
    "mesh_name",
    "SHAPES",
    "ShapeSpec",
    "input_specs",
    "shape_config",
    "model_flops",
]
