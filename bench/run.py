"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json``.  The run makes its
weights and prompts from ``--seed`` on the card, warms up every shape the
cell's traffic sends, serves batches back to back for ``--seconds`` seconds
through the program's serving entry, and then checks a sample of the
served tokens against the plain reference.  ``--trace 1`` traces the window
with ``torch.profiler`` and reports the per-layer metrics instead of the
end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the check compared with
its limit); the last lines of standard error repeat the compared numbers.
Without as many CUDA devices as the cell asks for it exits with 2 and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: modules that may not be loaded in the process that prints the result
BARRED = ("jax", "jaxlib", "flax", "repro")


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a cell's first run there builds (the program's own CUDA
    libraries already build into ``src/repro_torch/kernels/_build``)."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness.manifest import cell_metrics, find_cell, load_manifest

    manifest = load_manifest(ROOT)
    spec = find_cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {spec['chips']} CUDA device(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    from bench.harness.cell import run_cell

    result = run_cell(spec, cell_metrics(manifest, args.workload), args.seed, args.seconds,
                      bool(args.trace), "cuda")
    barred = sorted(m for m in sys.modules if m.split(".")[0] in BARRED)
    if barred:
        print(f"barred modules loaded in this process: {', '.join(barred)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
