"""The control of each cell's output check, on the card at the cell's own
size: the reference computed in float8 e4m3, put in the program's place,
has to fail the cell's limit, where the program served on the same seed
passes it, both read by the run's own code path (``run_cell``).  One
seed a cell here; ``bench/limits.py`` reads a dozen
program seeds and three or more control seeds in one process, which is
what the limits were set from.

    PYTHONPATH=src python -m pytest -q -m gpu bench/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest

from bench.harness.manifest import cell_metrics, find_cell, load_manifest
from bench.limits import readings

pytestmark = pytest.mark.gpu

SEED = 2**32 + 2027


@pytest.mark.parametrize("cell", [w["name"] for w in load_manifest()["workloads"]])
def test_the_control_fails_the_limit(cuda, cell):
    manifest = load_manifest()
    spec = find_cell(manifest, cell)
    r = readings(spec, cell_metrics(manifest, cell), SEED, True, 0, cuda)
    limit = spec["cell"]["check"]["max_logit_gap"]
    assert r["program"] <= limit < r["control"], r
