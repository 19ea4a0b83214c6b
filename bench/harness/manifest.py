"""What the benchmark runs, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics.  Each of them lives in a file of its own
under ``bench/``, found by its name:

  bench/configs/<config>.json    a model configuration as it is run
  bench/traffic/<traffic>.json   a traffic mix (parameters of traffic.py)
  bench/cells/<cell>.json        a cell: its configuration, traffic, chips,
                                 why, and the limits of its output check
  bench/e2e/<metric>.py          an end-to-end metric: ``value(run)``
  bench/metrics/<metric>.py      a per-layer metric: ``read(run)``

and each model family, by the ``family`` of a configuration file, in two:

  bench/families/<family>.py     its parameter layout and the sizes the
                                 metrics count: ``WIDTHS``, ``layout(c)``,
                                 ``matmul_weights(c)``, ``attention(c)``,
                                 ``ssd_blocks(c)``
  bench/reference/<family>.py    its trunk in the plain reference:
                                 ``trunk(c, weights, hs, precision)``

A later change adds a configuration, a family, a mix, a cell or a metric by
adding files and entries; no file here names one of them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
#: where a family's two files are found by its name
FAMILIES, REFERENCE = BENCH / "families", BENCH / "reference"

__all__ = ["BENCH", "ROOT", "FAMILIES", "REFERENCE", "Family", "family", "load_manifest",
           "find_cell", "load_json", "load_module", "cell_metrics"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(manifest: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic and cell files
    read; raises where ``BENCHMARK.json`` and the cell's file disagree."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in manifest["workloads"])
        raise KeyError(f"unknown workload {name!r}; known: {known}")
    cell = load_json(BENCH / "cells" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} is {cell[key]!r} in its file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return {
        "name": name,
        "chips": entry["chips"],
        "cell": cell,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
    }


def load_module(path: Path, package: Optional[str] = None) -> ModuleType:
    """A Python file loaded by its path (metric files carry dots in their
    names, so they are not importable by name); as a module of
    ``package``, where given, so that its relative imports resolve there."""
    name = (f"{package}.{path.stem}" if package
            else f"bench_file_{path.stem.replace('.', '_')}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Family(NamedTuple):
    #: ``bench/families/<family>.py``: layout, widths and the counted sizes
    model: ModuleType
    #: ``bench/reference/<family>.py``: the plain reference's trunk
    reference: ModuleType


def family(c: dict) -> Family:
    """The files of configuration ``c``'s ``family``; raises where either
    is missing."""
    name = c["family"]
    paths = (FAMILIES / f"{name}.py", REFERENCE / f"{name}.py")
    if not (name.isidentifier() and all(p.is_file() for p in paths)):
        raise ValueError(f"no model family {name!r}: looked for {paths[0]} and {paths[1]}")
    return Family(load_module(paths[0], "bench.families"),
                  load_module(paths[1], "bench.reference"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end metrics the cell reports, and its per-layer metrics:
    those that list the cell, or list no cells and move an end-to-end
    metric that the cell reports."""
    e2e = [m for m in manifest["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per_layer}
