"""The readings that a cell's output limit is set from.

    python3 bench/limits.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--batches N] [--out FILE]

In one process, for each seed, one run of the cell through ``run_cell``,
the same code path as ``bench/run.py``'s (weights and prompts from the
seed, the warm-up, the window, the output check), with the window ended
after ``--batches`` batches (two cycles of the traffic by default) and the
widest logit gap of the served tokens against the reference read.  For
each control seed also the control's: the reference computed in float8
e4m3 put in the program's place, read at the same positions.  Prints one
line a seed and writes every reading as JSON.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(spec: dict, metrics: dict, seed: int, control: bool, batches: int, device,
             program_cfg=None) -> dict:
    """One seed's readings of cell ``spec``: the program's widest gap
    (``program``), and with ``control`` the control's."""
    from bench.harness.cell import run_cell

    batches = batches or 2 * sum(spec["traffic"]["per_cycle"])
    r = run_cell(spec, metrics, seed, 0.0, False, device, program_cfg=program_cfg,
                 control=control, batches=batches, log=lambda *a, **k: None)
    chk = r["check"]
    return {"seed": seed, "program": chk["gap"],
            "control": chk["control_gap"] if control else None,
            "served_tokens": chk["served_tokens"], "requests": chk["requests"],
            "batches": batches, "reference_s": chk["reference_s"], "correct": r["correct"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--batches", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness.manifest import cell_metrics, find_cell, load_manifest

    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    manifest = load_manifest(ROOT)
    spec = find_cell(manifest, args.workload)
    metrics = cell_metrics(manifest, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = []
    for seed in seeds + [s for s in controls if s not in seeds]:
        r = readings(spec, metrics, seed, seed in controls, args.batches, "cuda")
        out.append(r)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    prog = [r["program"] for r in out]
    ctl = [r["control"] for r in out if r["control"] is not None]
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
               "program_max": max(prog), "control_min": min(ctl) if ctl else None,
               "readings": out}
    print(json.dumps({k: v for k, v in summary.items() if k != "readings"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
