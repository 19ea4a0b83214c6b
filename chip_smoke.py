#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 chip_smoke.py

It drives the port (``src/repro_torch``) end to end and exits non-zero if
any phase fails:

1. builds every kernel of the main paths from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, all started together) and prints
   the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card — the
   GUS kernel's integer assignments must be equal (0 mismatches) on the
   golden frames, the paper's 20 000-instance numerical batch (plain and
   both Happy-* relaxations), degenerate frames and the dense fleet's own
   frames; the class allocator's ``take``/``start`` cells and fixed-order
   loads on class grids built from generated frames (several seeds and
   padding buckets, one above 4096), duplicate classes, tie,
   all-infeasible, zero-count, exact-capacity and budget-carry frames, and
   one full-width window of the hierarchical main path;
3. runs the dense Monte-Carlo fleet (``simulate_fleet``, policy ``gus``) on
   the fleet benchmark's cluster (9 edges + 1 cloud, 5 services, 10
   variants; 30 s horizon, 6 req/s per edge): 64 replications with
   congestion off, on, and on with a half drain must equal the same call on
   the CPU, then 1024 replications in windows of 5 frames — the dense main
   path, whose kernel launches are counted;
4. runs the hierarchical class-aggregate fleet
   (``EngineOptions(scheduler="hierarchical")``) on the ``mega-city``
   scenario and the users-sweep cluster (20 edges + 1 cloud, 5 services, 10
   variants; 9 s horizon): at ~10^3 users per frame and 4 replications,
   congestion off and on with a half drain, it must equal the same call on
   the CPU; then the scenario's own defaults (streamed arrivals, 2400 req/s
   per edge, ~1.4e5 users per frame), 8 replications, ``window=1``,
   ``prefetch=2`` — the hierarchical main path, whose launches are counted;
5. times each kernel with CUDA events at its main path's launch shape
   beside its plain version and its bound (bytes over the card's memory
   rate, or operations over its rate);
6. prints one JSON line listing every ported kernel, then the contract line
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package.  Without a CUDA device,
or without the rest of the repository beside it, it fails before printing
any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM: HBM3 rate and float32 rate outside the tensor cores (NVIDIA's
#: data sheet, dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: float32 operations GUS does per candidate: 2 subtractions, 2 divisions,
#: 2 multiplications, 1 addition (Eq. 1) and 6 comparisons (feasibility,
#: budgets, argmax)
GUS_OPS_PER_CANDIDATE = 13
#: operations the class allocator does per cell of a chunk step: 4
#: comparisons (feasibility, budgets) and 1 for the argmax
HIER_OPS_PER_CELL = 5
#: the stated tolerance of ``mean_us_per_rep`` between devices: its row
#: mean is a float32 reduction whose summation order differs
US_RTOL, US_ATOL = 1e-5, 1e-6


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.core import (
        CongestionConfig,
        EngineOptions,
        FlatInstance,
        GeneratorConfig,
        SimConfig,
        demo_cluster_spec,
        generate_batch,
        get_scenario,
        gus_schedule_batch,
        simulate_fleet,
    )
    from repro_torch.core.aggregation import QuantizationConfig, class_batch
    from repro_torch.core.simulator import (
        _build_hier_window,
        _build_window,
        _hier_device_inputs,
        _pad_bucket,
        _RepFrameSource,
    )
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.gus import gus_assign, gus_assign_ref
    from repro_torch.kernels.hier import hier_cells, hier_cells_ref
    from repro_torch.obs.trace import Stopwatch

    dev = torch.device("cuda")
    fields = [f.name for f in dataclasses.fields(FlatInstance)]
    t_start = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    builds = build_libraries(["gus_assign", "hier_cells"])
    for info in builds.values():
        print(f"build {info.name}: nvcc {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- 2. kernel vs plain version on the card -----------------------------
    max_err = 0.0

    def kernel_args(batch):
        B = batch.A.shape[0]
        return tuple(
            getattr(batch, f).expand(B).contiguous() if f in ("max_as", "max_cs")
            else getattr(batch, f).contiguous()
            for f in fields
        )

    def compare(label, batch, **relax):
        nonlocal max_err
        a = gus_schedule_batch(batch, backend="cuda", device=dev, **relax)
        b = gus_schedule_batch(batch, backend="torch", device=dev, **relax)
        torch.cuda.synchronize()
        mism = int((a.j != b.j).sum()) + int((a.l != b.l).sum())
        err = max(
            float((a.j - b.j).abs().max()) if a.j.numel() else 0.0,
            float((a.l - b.l).abs().max()) if a.l.numel() else 0.0,
            float((a.loads[0] - b.loads[0]).abs().max()),
            float((a.loads[1] - b.loads[1]).abs().max()),
        )
        max_err = max(max_err, err)
        served = float((a.j >= 0).float().mean()) if a.j.numel() else 0.0
        print(
            f"compare {label}: B={batch.A.shape[0]} N={batch.A.shape[-1]} "
            f"mismatches={mism} max_abs_err={err} served={served:.4f}"
        )
        check(mism == 0 and err == 0.0, f"kernel != plain version on {label}")
        return a

    def batch_of_one(d):
        one = FlatInstance.from_numpy(d, dev)
        return FlatInstance(**{f: getattr(one, f)[None] for f in fields})

    for path in sorted((ROOT / "tests" / "fixtures").glob("gus_golden_*.npz")):
        d = np.load(path)
        a = compare(path.stem, batch_of_one(d))
        check(
            np.array_equal(a.j[0].cpu().numpy(), d["exp_j"])
            and np.array_equal(a.l[0].cpu().numpy(), d["exp_l"]),
            f"kernel != golden assignment on {path.stem}",
        )

    t0 = time.perf_counter()
    paper = generate_batch(0, 20000, device=dev)
    print(f"paper batch generate_batch(0, 20000): {time.perf_counter() - t0:.3f} s host")
    compare("paper N=100 M=10 L=10", paper)
    compare("paper relax_compute", paper, relax_compute=True)
    compare("paper relax_comm", paper, relax_comm=True)

    # degenerate frames: empty, all-infeasible, exact-capacity fit, ties
    def first(batch, n_frames, n_rows=None):
        """The first frames of a batch, optionally cut to the first rows."""
        out = {}
        for f in fields:
            x = getattr(batch, f)[:n_frames]
            if n_rows is not None and f not in ("gamma", "eta", "max_as", "max_cs"):
                x = x[:, :n_rows]
            out[f] = x
        return FlatInstance(**out)

    n0 = gus_assign.launches
    a = compare("empty N=0", first(paper, 4, 0))
    check(tuple(a.j.shape) == (4, 0) and gus_assign.launches == n0, "N=0 must not launch")
    infeasible = first(paper, 64)
    a = compare(
        "all-infeasible",
        dataclasses.replace(infeasible, avail=torch.zeros_like(infeasible.avail)),
    )
    check(bool((a.j == -1).all()), "an all-infeasible frame must drop every request")
    N, M, L = 3, 2, 1
    fit = dict(
        cover=np.zeros(N, np.int32), A=np.full(N, 10.0), C=np.full(N, 1000.0),
        w_a=np.ones(N), w_c=np.ones(N), acc=np.full((N, M, L), 80.0),
        ctime=np.broadcast_to(np.array([100.0, 200.0])[None, :, None], (N, M, L)),
        v=np.ones((N, M, L)), u=np.zeros((N, M, L)), avail=np.ones((N, M, L), bool),
        gamma=np.array([2.0, 0.0]), eta=np.zeros(M), max_as=100.0, max_cs=1000.0,
    )
    a = compare("exact-capacity fit", batch_of_one(fit))
    check(a.j[0].tolist() == [0, 0, -1], "exact-capacity fit must serve exactly two")
    N, M, L = 6, 3, 2
    ties = dict(
        cover=np.zeros(N, np.int32), A=np.full(N, 10.0), C=np.full(N, 1000.0),
        w_a=np.ones(N), w_c=np.ones(N), acc=np.full((N, M, L), 50.0),
        ctime=np.full((N, M, L), 100.0), v=np.ones((N, M, L)), u=np.ones((N, M, L)),
        avail=np.ones((N, M, L), bool), gamma=np.full(M, 100.0), eta=np.full(M, 100.0),
        max_as=100.0, max_cs=1000.0,
    )
    a = compare("duplicate-utility ties", batch_of_one(ties))
    check(bool((a.j == 0).all() and (a.l == 0).all()), "ties must pick the lowest flat index")

    # the fleet's own frames: the first window of the 1024-replication run
    spec = demo_cluster_spec(n_edge=9, n_cloud=1, n_services=5, n_variants=10)
    cfg = SimConfig(
        horizon_ms=30_000.0, arrival_rate_per_s=6.0, delay_req_ms=6000.0,
        acc_req_mean=50.0, acc_req_std=10.0,
    )
    n_rep_scale, window = 1024, 5
    T = int(math.ceil(cfg.horizon_ms / cfg.frame_ms))
    scn = get_scenario("paper-default")
    t0 = time.perf_counter()
    sources = [
        _RepFrameSource(
            scn, r, spec.n_edge, spec.proc_ms.shape[1], cfg, T, False, False, "vectorized"
        )
        for r in range(n_rep_scale)
    ]
    n_pad = _pad_bucket(max(s.max_bucket for s in sources))
    host, _ = _build_window(sources, spec, cfg, scn, 0, window, n_pad, Stopwatch(), True)
    fleet_win = FlatInstance(**{f: host[f].to(dev) for f in fields})
    print(f"fleet window built: {time.perf_counter() - t0:.3f} s host, n_pad={n_pad}")
    compare("fleet window (1024 reps x 5 frames)", fleet_win)
    fleet_step = FlatInstance(**{f: getattr(fleet_win, f)[:n_rep_scale] for f in fields})

    # -- 3. the fleet main path ---------------------------------------------
    def fleet(n_rep, device, congestion=CongestionConfig(), **opt):
        return simulate_fleet(
            spec, dataclasses.replace(cfg, congestion=congestion), policy="gus",
            scenario="paper-default", n_rep=n_rep, seed=0,
            options=EngineOptions(rng_mode="vectorized", **opt), device=device,
        )

    # GUS honours the budgets it is given, so with the default drain of 1.0
    # its backlog stays at zero and the carry is inert; drain=0.5 carries
    # half of each frame's work over and feeds the backlog back into the
    # next frame's budgets — the path where a 1-ulp load sum would show
    parity = {}
    for label, congestion in (
        ("off", CongestionConfig()),
        ("on", CongestionConfig(enabled=True)),
        ("on drain=0.5", CongestionConfig(enabled=True, drain=0.5)),
    ):
        n0 = gus_assign.launches
        t0 = time.perf_counter()
        g = fleet(64, "cuda", congestion)
        t_gpu = time.perf_counter() - t0
        launched = gus_assign.launches - n0
        t0 = time.perf_counter()
        c = fleet(64, "cpu", congestion)
        t_cpu = time.perf_counter() - t0
        us_err = float(np.abs(g.mean_us_per_rep - c.mean_us_per_rep).max())
        same = (
            g.n_requests == c.n_requests and g.n_served == c.n_served
            and np.array_equal(g.satisfied_per_rep, c.satisfied_per_rep)
            and g.mean_compute_inflation == c.mean_compute_inflation
            and (not congestion.enabled
                 or np.array_equal(g.final_backlog_per_rep, c.final_backlog_per_rep))
        )
        backlog = None if g.final_backlog_per_rep is None else float(g.final_backlog_per_rep.sum())
        print(
            f"fleet parity n_rep=64 congestion {label}: cuda {t_gpu:.3f} s "
            f"({launched} launches) vs cpu {t_cpu:.3f} s; requests={g.n_requests} "
            f"served={g.n_served} satisfied={g.satisfied_pct:.4f}% "
            f"inflation={g.mean_compute_inflation} final_backlog_sum={backlog} "
            f"integer_fields_equal={same} mean_us_max_abs_diff={us_err}"
        )
        check(same, f"fleet on the card != fleet on the CPU (congestion {label})")
        check(launched > 0, "the card's fleet did not launch the GUS kernel")
        check(
            np.allclose(g.mean_us_per_rep, c.mean_us_per_rep, rtol=US_RTOL, atol=US_ATOL),
            "mean_us_per_rep out of tolerance",
        )
        parity[label] = g
    check(
        parity["on drain=0.5"].final_backlog_per_rep.sum() > 0,
        "the draining congested run never built a backlog",
    )

    gus_assign.launches = hier_cells.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr = fleet(n_rep_scale, "cuda", window=window)
    wall = time.perf_counter() - t0
    launches = gus_assign.launches
    check(hier_cells.launches == 0, "the dense main path launched the class allocator")
    print(
        f"fleet scale n_rep={fr.n_rep} frames={fr.n_frames} window={fr.window} "
        f"prefetch={fr.prefetch}: wall {wall:.3f} s dispatch_s {fr.dispatch_s:.3f} "
        f"gen_s {fr.gen_s:.3f} requests={fr.n_requests} "
        f"requests/s {fr.n_requests / wall:.1f} satisfied={fr.satisfied_pct:.4f}% "
        f"gus_assign launches={launches} device={fr.device}"
    )
    print("fleet scale timings " + json.dumps({k: round(v, 4) for k, v in fr.timings.items()}))
    check(launches > 0, "the main path never launched the GUS kernel")
    check(
        fr.satisfied_per_rep.shape == (n_rep_scale,) and fr.mean_us_per_rep.shape == (n_rep_scale,)
        and np.isfinite(fr.satisfied_per_rep).all() and np.isfinite(fr.mean_us_per_rep).all()
        and 0 < fr.n_served <= fr.n_requests,
        "scale run results malformed",
    )
    # replication r draws from seed + r whatever n_rep and window are, and
    # padding never changes an assignment: its first 64 replications
    # satisfy exactly the parity run's requests
    check(
        np.array_equal(fr.satisfied_per_rep[:64], parity["off"].satisfied_per_rep),
        "the scale run's first 64 replications disagree with the parity run",
    )

    # -- 4. the hierarchical path: class allocator vs plain, fleet parity,
    #       the counted main path ------------------------------------------
    hier_err = 0.0

    def compare_hier(label, args):
        """Kernel == plain version on one batch of class grids (cells and
        fixed-order loads)."""
        nonlocal hier_err
        got = hier_cells(*args, backend="cuda", loads=True)
        want = hier_cells_ref(*args, loads=True)
        torch.cuda.synchronize()
        mism = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        err = max(
            float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0,
            float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0,
            float((got[2] - want[2]).abs().max()) if got[2].numel() else 0.0,
            float((got[3] - want[3]).abs().max()) if got[3].numel() else 0.0,
        )
        hier_err = max(hier_err, err)
        B, C = args[0].shape[:2]
        print(
            f"compare hier_cells {label}: B={B} C={C} classes={int((args[5] > 0).sum())} "
            f"members={int(args[5].sum())} placed={int(got[0].sum())} "
            f"mismatches={mism} max_abs_err={err}"
        )
        check(mism == 0 and err == 0.0, f"class-allocator kernel != plain version on {label}")
        return got

    def frames_of(batch):
        return [FlatInstance(**{f: getattr(batch, f)[i] for f in fields})
                for i in range(batch.A.shape[0])]

    t0 = time.perf_counter()
    for seed in (0, 1, 2):
        frames = frames_of(generate_batch(seed, 64, device="cpu"))
        for pad_to in (None, 256, 4352):
            compare_hier(f"generated seed={seed} pad_to={pad_to}",
                         class_batch(frames, pad_to=pad_to, device=dev))
    dup_cfg = GeneratorConfig(n_requests=24, n_services=6)
    dups = []
    for f in frames_of(generate_batch(3, 16, dup_cfg, device="cpu")):
        dups.append(dataclasses.replace(f, **{
            k: getattr(f, k).repeat_interleave(5, 0)
            for k in ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")
        }))
    compare_hier("duplicate classes (rows x5)", class_batch(dups, device=dev))

    def degenerate(us, feas, v, u, cover, count, gamma, eta):
        f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)[None]  # noqa: E731
        i32 = lambda x: torch.tensor(np.asarray(x, np.int32), device=dev)[None]  # noqa: E731
        return (f32(us), torch.tensor(np.asarray(feas, bool), device=dev)[None], f32(v),
                f32(u), i32(cover), i32(count), f32(gamma), f32(eta))

    got = compare_hier("ties", degenerate(
        np.ones((3, 4, 2)), np.ones((3, 4, 2), bool), np.ones((3, 4, 2)), np.ones((3, 4, 2)),
        np.zeros(3), np.full(3, 2), np.full(4, 1e6), np.full(4, 1e6),
    ))
    check(bool((got[0][0, :, 0, 0] == 2).all()) and int(got[0].sum()) == 6,
          "ties must pick the lowest flat cell")
    feas_ = np.ones((4, 3, 2), bool)
    feas_[1] = False
    got = compare_hier("all-infeasible and zero-count rows", degenerate(
        np.random.default_rng(0).uniform(0, 1, (4, 3, 2)), feas_, np.ones((4, 3, 2)),
        np.ones((4, 3, 2)), np.zeros(4), [3, 3, 0, 3], np.full(3, 1e6), np.full(3, 1e6),
    ))
    check(int(got[0][0, 1].sum()) == 0 and int(got[0][0, 2].sum()) == 0,
          "an infeasible or zero-count class must place nobody")
    one_cell = np.array([[[1.0], [0.5]]])
    got = compare_hier("exact capacity (gamma)", degenerate(
        one_cell, [[[True], [False]]], np.ones((1, 2, 1)), np.zeros((1, 2, 1)),
        [0], [3], [2.0, 0.0], [1e6, 1e6],
    ))
    check(int(got[0][0, 0, 0, 0]) == 2 and int(got[0].sum()) == 2, "gamma must fit exactly two")
    got = compare_hier("exact capacity (eta)", degenerate(
        one_cell, [[[False], [True]]], np.ones((1, 2, 1)), np.ones((1, 2, 1)),
        [0], [3], [1e6, 1e6], [2.5, 1e6],
    ))
    check(int(got[0][0, 0, 1, 0]) == 2 and int(got[0].sum()) == 2, "eta must fit floor(2.5)")
    got = compare_hier("budget carry", degenerate(
        np.tile(np.array([[[1.0], [0.4]]]), (2, 1, 1)),
        np.ones((2, 2, 1), bool), np.ones((2, 2, 1)), np.zeros((2, 2, 1)),
        [0, 0], [3, 2], [3.0, 1e6], [1e6, 1e6],
    ))
    check(int(got[0][0, 1, 1, 0]) == 2, "the budget must carry across classes")
    print(f"hier_cells class-grid comparisons: {time.perf_counter() - t0:.3f} s")

    # the hierarchical main path's own frames: its first window, built as
    # the fleet builds it (8 replications x 1 frame, streamed arrivals)
    city = demo_cluster_spec(n_edge=20, n_cloud=1, n_services=5, n_variants=10)
    city_cfg = SimConfig(horizon_ms=9000.0)
    mega = get_scenario("mega-city")
    n_rep_city, T_city = 8, int(math.ceil(city_cfg.horizon_ms / city_cfg.frame_ms))
    t0 = time.perf_counter()
    city_sources = [
        _RepFrameSource(mega, r, city.n_edge, city.proc_ms.shape[1], city_cfg, T_city,
                        True, True, "vectorized")
        for r in range(n_rep_city)
    ]
    _, _, host, _, n_arr = _build_hier_window(
        city_sources, city, city_cfg, mega, 0, 1, QuantizationConfig(), Stopwatch(), True
    )
    city_inst, city_us, city_feas, city_count = _hier_device_inputs(host, dev)
    win_args = (city_us, city_feas, city_inst.v, city_inst.u, city_inst.cover, city_count,
                city_inst.gamma, city_inst.eta)
    print(f"hier window built: {time.perf_counter() - t0:.3f} s host, "
          f"users/frame={int(n_arr.sum()) / n_rep_city:.0f}, Cp={city_count.shape[1]}")
    compare_hier(f"hier main-path window ({n_rep_city} reps x 1 frame, full width)", win_args)

    def city_fleet(n_rep, device, scenario=mega, congestion=CongestionConfig()):
        return simulate_fleet(
            city, dataclasses.replace(city_cfg, congestion=congestion), scenario=scenario,
            n_rep=n_rep, seed=0, device=device,
            options=EngineOptions(scheduler="hierarchical", window=1, prefetch=2),
        )

    # ~10^3 users per frame; the half drain makes the backlog feed back
    small_city = dataclasses.replace(
        mega, rate_per_edge_per_s=1000.0 / (city.n_edge * city_cfg.frame_ms / 1000.0)
    )
    for label, congestion in (
        ("off", CongestionConfig()),
        ("on drain=0.5", CongestionConfig(enabled=True, drain=0.5)),
    ):
        n0 = hier_cells.launches
        t0 = time.perf_counter()
        g = city_fleet(4, "cuda", small_city, congestion)
        t_gpu = time.perf_counter() - t0
        launched = hier_cells.launches - n0
        t0 = time.perf_counter()
        c = city_fleet(4, "cpu", small_city, congestion)
        t_cpu = time.perf_counter() - t0
        same = (
            g.n_requests == c.n_requests and g.n_served == c.n_served
            and np.array_equal(g.satisfied_per_rep, c.satisfied_per_rep)
            and np.array_equal(g.mean_us_per_rep, c.mean_us_per_rep)
            and g.mean_compute_inflation == c.mean_compute_inflation
            and (not congestion.enabled
                 or np.array_equal(g.final_backlog_per_rep, c.final_backlog_per_rep))
        )
        backlog = None if g.final_backlog_per_rep is None else float(g.final_backlog_per_rep.sum())
        print(
            f"hier fleet parity n_rep=4 congestion {label}: cuda {t_gpu:.3f} s "
            f"({launched} launches) vs cpu {t_cpu:.3f} s; requests={g.n_requests} "
            f"served={g.n_served} satisfied={g.satisfied_pct:.4f}% "
            f"inflation={g.mean_compute_inflation} final_backlog_sum={backlog} "
            f"all_fields_equal={same}"
        )
        check(same, f"hier fleet on the card != hier fleet on the CPU (congestion {label})")
        check(launched > 0, "the card's hier fleet did not launch the class allocator")
        if congestion.enabled:
            check(g.final_backlog_per_rep.sum() > 0, "the draining hier run built no backlog")

    gus_assign.launches = hier_cells.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fh = city_fleet(n_rep_city, "cuda")
    hier_wall = time.perf_counter() - t0
    hier_launches = hier_cells.launches
    check(gus_assign.launches == 0, "the hierarchical main path launched the GUS kernel")
    print(
        f"hier main path mega-city n_rep={fh.n_rep} frames={fh.n_frames} window={fh.window} "
        f"prefetch={fh.prefetch}: wall {hier_wall:.3f} s dispatch_s {fh.dispatch_s:.3f} "
        f"gen_s {fh.gen_s:.3f} requests={fh.n_requests} "
        f"users/frame={fh.n_requests / (fh.n_rep * fh.n_frames):.0f} "
        f"requests/s {fh.n_requests / hier_wall:.1f} served={fh.n_served} "
        f"satisfied={fh.satisfied_pct:.4f}% hier_cells launches={hier_launches} "
        f"device={fh.device}"
    )
    print("hier main path timings " + json.dumps({k: round(v, 4) for k, v in fh.timings.items()}))
    check(hier_launches == fh.n_frames, "the hier main path must launch once per window")
    check(
        fh.satisfied_per_rep.shape == (n_rep_city,)
        and np.isfinite(fh.satisfied_per_rep).all() and np.isfinite(fh.mean_us_per_rep).all()
        and 0 < fh.n_served <= fh.n_requests and fh.n_requests > 1e5 * n_rep_city * fh.n_frames,
        "hier main path results malformed",
    )
    check(int(n_arr.sum()) < fh.n_requests, "the compared window is not the main path's")

    # -- 5. kernel timing ------------------------------------------------------
    def time_kernel(args, reps):
        for _ in range(2):
            gus_assign(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            gus_assign(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def time_plain(args, reps=2):
        gus_assign_ref(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            gus_assign_ref(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def bound(batch):
        B, N, M, L = batch.acc.shape
        # each input read once (candidates 4 x f32 + avail u8, request rows
        # 5 x 4 B, budgets 2 x 4 B, normalizers 2 x 4 B), each output
        # written once (j, l: 2 x 4 B per request; loads 2 x 4 B per server)
        nbytes = B * (N * M * L * 17 + N * 20 + M * 8 + 8 + N * 8 + M * 8)
        ops = B * N * M * L * GUS_OPS_PER_CANDIDATE
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    timing = {}
    for label, batch in (
        ("fleet frame step B=1024 N=256 M=10 L=10", fleet_step),
        ("paper batch B=20000 N=100 M=10 L=10", paper),
        ("fleet window launch B=5120 N=256 M=10 L=10", fleet_win),
    ):
        args = kernel_args(batch)
        ms = time_kernel(args, 10)
        plain_ms = time_plain(args)
        b_ms, b_by = bound(batch)
        timing[label] = (ms, plain_ms, b_ms, b_by)
        print(
            f"time gus_assign {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), kernel/bound {ms / b_ms:.2f}x; "
            "library: none (no single PyTorch call computes GUS)"
        )

    main_ms, main_plain, main_bound, main_by = timing["fleet window launch B=5120 N=256 M=10 L=10"]

    def time_hier(fn, args, reps):
        """Mean ms of ``fn(*args)`` after one warm-up call, both versions
        called as the main path calls the allocator (no loads)."""
        fn(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def hier_bound(args):
        us, _, _, _, _, count, _, _ = args
        B, C, M, L = us.shape
        real = int((count > 0).sum())
        # each input the function needs read once: the cells of the real
        # classes (us, v, u f32 + feas u8; padding rows are never read),
        # every row's cover and count, the budgets; each output written
        # once: take and start (int32) over the whole grid
        nbytes = real * M * L * 13 + B * C * 8 + B * M * 8 + B * C * M * L * 8
        ops = real * M * L * HIER_OPS_PER_CELL  # at least one chunk step per class
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    hier_ms = time_hier(lambda *a: hier_cells(*a, backend="cuda"), win_args, 5)
    hier_plain_ms = time_hier(hier_cells_ref, win_args, 2)
    hb_ms, hb_by = hier_bound(win_args)
    print(
        f"time hier_cells main-path launch B={city_us.shape[0]} C={city_us.shape[1]} "
        f"M={city_us.shape[2]} L={city_us.shape[3]}: kernel {hier_ms:.4f} ms, plain "
        f"{hier_plain_ms:.4f} ms, bound {hb_ms:.4f} ms ({hb_by}), kernel/bound "
        f"{hier_ms / hb_ms:.2f}x; library: none (no single PyTorch call computes the allocator)"
    )
    kernels = {"kernels": [{
        "name": "gus_assign",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gus_assign.cu",
        "replaces": "src/repro/kernels/gus_pallas.py:155",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_ms,
        "plain_ms": main_plain,
        "bound_ms": main_bound,
        "bound_by": main_by,
        "library_ms": None,
    }, {
        "name": "hier_cells",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hier_cells.cu",
        "replaces": "src/repro/kernels/hier_pallas.py:178",
        "launches": hier_launches,
        "max_abs_err": hier_err,
        "ms": hier_ms,
        "plain_ms": hier_plain_ms,
        "bound_ms": hb_ms,
        "bound_by": hb_by,
        "library_ms": None,
    }]}
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
