"""``BENCHMARK.json`` and the files it names: what the benchmark may import,
the names and units it uses, and the configurations against the
program's."""
from __future__ import annotations

import ast
import json
import re

import pytest

from conftest import stated_widths

from bench.harness.cell import _META, program_config
from bench.harness.manifest import BENCH, ROOT, find_cell, load_json, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: the JAX package and its stack, by top-level module name
BARRED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    """The top-level names of every module ``path`` imports (relative
    imports left out: they stay inside ``bench``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_the_jax_package(path):
    assert not _imports(path) & BARRED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    """The reference imports torch, the standard library and its own
    modules (relative imports) only."""
    assert _imports(path) <= {"torch", "math", "contextlib", "typing", "__future__"}


def test_names_and_units():
    m = load_manifest()
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    names += [k for c in m["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x["unit"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in m[kind]}) == len(m[kind]), kind


def test_every_name_has_its_file():
    m = load_manifest()
    for w in m["workloads"]:
        spec = find_cell(m, w["name"])  # raises where the files and the manifest disagree
        assert spec["cell"]["why"] == w["why"]
    for x in m["end_to_end"]:
        assert (BENCH / "e2e" / f"{x['name']}.py").is_file(), x["name"]
    for x in m["per_layer"]:
        assert (BENCH / "metrics" / f"{x['name']}.py").is_file(), x["name"]
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == m


@pytest.mark.parametrize("conf", load_manifest()["configs"], ids=lambda c: c["name"])
def test_configuration_widths_equal_the_programs(conf):
    c = load_json(ROOT / conf["file"])
    assert c["name"] == conf["name"] and c["source"] == conf["source"]
    assert c["reduced"] == conf["reduced"]
    cfg = program_config(c)  # raises on any setting that differs
    for key, value in stated_widths(c).items():
        assert value == getattr(cfg, key), key
    assert {k for k in c if k not in _META} <= {f for f in cfg.__dataclass_fields__}
