#!/usr/bin/env python3
"""The port's paths over several cards, on a machine with two or more.

    PYTHONPATH=src python3 tools/multi_card_check.py [--out FILE.json]

``chip_smoke.py`` phase 17 runs these branches only where it finds more than
one card; this script runs them, and what they are compared with, alone:

1. the model kernels on every card in turn after ``cuda:0`` (the per-device
   shared-memory opt-in), each against its plain version;
2. the 1024-replication dense fleet of phase 3 on one card, then over every
   card at one group a card and at the reference's groups of 8, then on
   one card again: every result bit-equal to the first, walls and launches;
3. the full-width mega-city hierarchical fleet of phase 4 on one card, over
   every card with the class slabs (``_hier_device_inputs`` cuts the
   utility and feasibility grid over the cards), and over every card with
   the slabs taken out (the whole grid on the run's card), in turns (one,
   slabs, no slabs, no slabs, slabs, one): bit-equal, walls and
   ``dispatch_s``, the part of the wall the slabs can move;
4. yi-9b tensor parallel over 2 cards and over every card (phase 17c's
   ``tensor_parallel``): the prefill logits against the unsharded
   prefill's at ``chip_smoke.TP_LOGIT_TOL``, launches on every rank;
5. the sharded train step on a 1 x 2 mesh and, with four cards or more, a
   2 x 2 mesh (``chip_smoke.sharded_train_over_cards``): phase 17c's
   mamba2-130m, yi-9b and seamless-m4t-medium (2 layers) in float32 with
   q/k/v at a fan-in of d_model, two steps, held against the unsharded
   steps on one card at phase 14's wide limits.

``--parts`` picks some of them (``opt_in dense hier tp train``; all by
default).
The card's name and power limit are printed first; the last line is one
JSON object of every number, also written to ``--out``.  Exits 1 if a check
failed, 2 with fewer than two cards.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


PARTS = ("opt_in", "dense", "hier", "tp", "train")


def fields_equal(a, b) -> bool:
    import numpy as np

    return (a.n_requests == b.n_requests and a.n_served == b.n_served
            and np.array_equal(a.satisfied_per_rep, b.satisfied_per_rep)
            and np.array_equal(a.mean_us_per_rep, b.mean_us_per_rep)
            and a.mean_compute_inflation == b.mean_compute_inflation)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="chiprun_out/multi_card.json")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = ap.parse_args(argv)

    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"multi_card_check: needs two CUDA devices, found {n_cards}", file=sys.stderr)
        return 2

    from repro_torch.kernels.build import build_libraries

    # the train steps launch no kernel (they ask for the plain route)
    builds = build_libraries(["gus_assign", "hier_cells", "flash_attention",
                              "flash_attention_wgmma", "decode_attention", "ssd_scan",
                              "ssd_scan_wgmma"]) if set(args.parts) - {"train"} else {}
    for info in builds.values():
        print(f"build {info.name}: nvcc {info.seconds:.3f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    failed = []
    cs.check = lambda cond, msg: cond or (print(f"FAILED: {msg}") or failed.append(msg))
    dev = torch.device("cuda", 0)
    res = {"cards": smi.splitlines(), "n_cards": n_cards}

    # -- 1. the model kernels on every card after the first ------------------
    res["opt_in"] = {}
    for i in range(n_cards if "opt_in" in args.parts else 0):
        d = torch.device("cuda", i)
        res["opt_in"][str(d)] = cs.second_card_kernels(d)
        print(f"kernels on {d}: {res['opt_in'][str(d)]}")

    # -- 2.-3. the fleets ------------------------------------------------------
    if "dense" in args.parts:
        res["dense"] = dense_fleets(dev, n_cards)
    if "hier" in args.parts:
        res["hier"] = hier_fleets(dev, n_cards)

    # -- 4. yi-9b tensor parallel --------------------------------------------
    res["tensor_parallel"] = {}
    for n in sorted({2, n_cards}) if "tp" in args.parts else ():
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts, tp = cs.tensor_parallel(n)
        res["tensor_parallel"][n] = {"launches": counts, "worker": tp,
                                     "wall_s": time.perf_counter() - t0}

    # -- 5. the sharded train steps over cards ---------------------------------
    res["train"] = {}
    for data, model in ((1, 2), (2, 2)) if "train" in args.parts else ():
        if data * model > n_cards:
            continue
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tr = cs.sharded_train_over_cards(data, model)
        res["train"][f"{data}x{model}"] = {"result": tr, "wall_s": time.perf_counter() - t0}

    res["failed"] = failed
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps(res, default=str))
    return 1 if failed else 0


def dense_fleets(dev, n_cards):
    """Part 2 (module docstring): one row a run."""
    import torch

    from repro_torch.core import EngineOptions, simulate_fleet
    from repro_torch.kernels.gus import gus_assign

    spec, cfg, _ = cs.dense_fleet_window(dev, 1024, 5)

    def dense(devices, rep_group=None):
        n0 = gus_assign.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = simulate_fleet(spec, cfg, policy="gus", scenario="paper-default", n_rep=1024,
                            seed=0, device=dev,
                            options=EngineOptions(rng_mode="vectorized", window=5,
                                                  devices=devices, rep_group=rep_group))
        wall = time.perf_counter() - t0
        return fr, {"devices": devices, "rep_group": rep_group, "wall_s": wall,
                    "dispatch_s": fr.dispatch_s, "launches": gus_assign.launches - n0,
                    "n_devices": fr.n_devices}

    base, row = dense(1)
    rows = [row]
    for devices, rep_group in ((n_cards, None), (n_cards, 8), (1, None)):
        fr, row = dense(devices, rep_group)
        row["equal_to_one_card"] = fields_equal(fr, base)
        cs.check(row["equal_to_one_card"] and fr.n_devices == devices,
                 f"dense fleet devices={devices} rep_group={rep_group} != one card")
        rows.append(row)
        print(f"dense fleet: {row}")
    return rows


def hier_fleets(dev, n_cards):
    """Part 3 (module docstring): one row a run."""
    import torch

    import repro_torch.core.simulator as sim
    from repro_torch.core import (EngineOptions, SimConfig, demo_cluster_spec, get_scenario,
                                  simulate_fleet)
    from repro_torch.kernels.hier import hier_cells

    city = demo_cluster_spec(n_edge=20, n_cloud=1, n_services=5, n_variants=10)
    city_cfg = SimConfig(horizon_ms=9000.0)
    mega = get_scenario("mega-city")
    slabbed = sim._hier_device_inputs

    def whole_grid(host, d, devs=()):
        return slabbed(host, d)

    def hier(devices, slabs):
        sim._hier_device_inputs = slabbed if slabs else whole_grid
        try:
            n0 = hier_cells.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fh = simulate_fleet(city, city_cfg, scenario=mega, n_rep=cs.N_REP_CITY, seed=0,
                                device=dev,
                                options=EngineOptions(scheduler="hierarchical", window=1,
                                                      prefetch=2, devices=devices))
            wall = time.perf_counter() - t0
        finally:
            sim._hier_device_inputs = slabbed
        return fh, {"devices": devices, "slabs": slabs, "wall_s": wall,
                    "dispatch_s": fh.dispatch_s, "gen_s": fh.gen_s,
                    "launches": hier_cells.launches - n0, "n_devices": fh.n_devices}

    hbase, row = hier(1, True)
    rows = [row]
    for devices, slabs in ((n_cards, True), (n_cards, False), (n_cards, False),
                           (n_cards, True), (1, True)):
        fh, row = hier(devices, slabs)
        row["equal_to_one_card"] = fields_equal(fh, hbase)
        cs.check(row["equal_to_one_card"], f"hier fleet devices={devices} slabs={slabs} "
                 "!= one card")
        rows.append(row)
        print(f"hier fleet: {row}")
    return rows


if __name__ == "__main__":
    sys.exit(main())
