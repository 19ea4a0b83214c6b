"""The spread of a cell's end-to-end metrics, from which its bounds are set.

    python3 bench/sets.py --workload <cell> --seeds 1,2,3,4,5,6 [--sets 2] \
        [--seconds 30] [--out DIR]

Runs ``bench/run.py`` once a seed, one process after another, in each of
``--sets`` sets over the same seeds, keeps each run's output under
``--out``, and prints for every metric each set's median and spread: the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median.  A bound
is set at about five times the widest spread over the sets and cells.
``--report DIR`` prints the spreads of runs already kept there.  Needs
the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    """(IQR over median, median) of ``values``."""
    q = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q[2] - q[0]) / med, med


def report(out: Path) -> dict:
    sets = {}
    for f in sorted(out.glob("set*.out")):
        tag, seed = f.stem.split(".", 1)
        lines = f.read_text().strip().splitlines()
        sets.setdefault(tag, {})[seed] = json.loads(lines[-1]) if lines else None
    summary = {}
    for tag, runs in sorted(sets.items()):
        ok = [r for r in runs.values() if r is not None]
        for name in sorted({k for r in ok for k in r["metrics"]}):
            values = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            sp, med = spread(values)
            summary.setdefault(name, {})[tag] = {"spread": sp, "median": med,
                                                 "values": values}
            print(f"{name:16s} {tag}: median {med!r}, spread {100 * sp:.3f}%, "
                  f"values {values}")
        print(f"{tag}: {len(ok)} of {len(runs)} runs printed a result, correct "
              f"{[r['correct'] for r in ok]}")
    for name, by_set in summary.items():
        widest = max(s["spread"] for s in by_set.values())
        print(f"{name}: widest spread {100 * widest:.3f}%, five times it "
              f"{500 * widest:.2f}%")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--out", default="")
    ap.add_argument("--report", default="")
    args = ap.parse_args(argv)
    if args.report:
        report(Path(args.report))
        return 0
    out = Path(args.out or ROOT / "chiprun_out" / "sets" / args.workload)
    out.mkdir(parents=True, exist_ok=True)
    for k in range(args.sets):
        for seed in [s for s in args.seeds.split(",") if s]:
            with open(out / f"set{k}.{seed}.out", "w") as so, \
                    open(out / f"set{k}.{seed}.err", "w") as se:
                rc = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                                     "--workload", args.workload, "--seed", seed,
                                     "--seconds", str(args.seconds), "--trace", "0"],
                                    stdout=so, stderr=se, cwd=ROOT).returncode
            print(f"set {k} seed {seed}: exit {rc}", flush=True)
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
