"""Run any registered workload scenario through the port's virtual testbed.

``python -m repro_torch.launch.run_scenario`` is the port's counterpart of
``examples/run_scenario.py``, flag for flag: pick a scenario, a policy and
a load level; optionally also run the Monte-Carlo fleet for replicated
statistics.  It runs on the CUDA device unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.run_scenario --list
    PYTHONPATH=src python -m repro_torch.launch.run_scenario --scenario flash-crowd
    PYTHONPATH=src python -m repro_torch.launch.run_scenario --scenario outage \\
        --policy local_all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.run_scenario --scenario diurnal \\
        --policy random --fleet 32

Telemetry: ``--metrics`` writes the per-decision metric stream as JSONL
under ``results/telemetry/`` (``<scenario>-<policy>.metrics.jsonl``, and
``.fleet.metrics.jsonl`` for the fleet), ``--trace PATH`` saves a Chrome
trace of the run's host spans, ``--profile DIR`` a ``torch.profiler``
trace (the card's kernels included) into ``DIR``:

    PYTHONPATH=src python -m repro_torch.launch.run_scenario \\
        --scenario sustained-overload --congestion --metrics \\
        --trace trace.json --horizon-s 6
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

from ..core import (
    CongestionConfig,
    EngineOptions,
    SimConfig,
    demo_cluster_spec,
    get_policy,
    get_scenario,
    gus_schedule_np,
    list_policies,
    list_scenarios,
    simulate,
    simulate_fleet,
)
from ..core.instance import resolve_device
from ..core.options import BACKENDS
from ..obs import AsyncJsonlWriter, profile_trace, recording, validate_chrome_trace

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="paper-default")
    ap.add_argument("--policy", default="gus",
                    help="registered policy name, or 'gus-np' for the NumPy oracle")
    ap.add_argument("--rate", type=float, default=2.0, help="arrivals/s per edge")
    ap.add_argument("--horizon-s", type=float, default=60.0)
    ap.add_argument("--deadline-ms", type=float, default=6000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fleet", type=int, default=0, metavar="R",
                    help="also run R Monte-Carlo replications")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="shard the fleet's replication axis across N local "
                         "devices of --device's type (default: all; asking for "
                         "more than exist raises, never falls back)")
    ap.add_argument("--window", type=int, default=None, metavar="W",
                    help="run the fleet W frames at a time (bounded memory on "
                         "long horizons)")
    ap.add_argument("--prefetch", type=int, default=None, metavar="D",
                    help="fleet host-pipeline depth: build window k+1's "
                         "arrivals+grid in a producer thread while window k "
                         "runs (identical results; 0 = serial build, default 1)")
    ap.add_argument("--rng-mode", choices=["paper-default", "vectorized"], default=None,
                    help="arrival generator: 'paper-default' keeps the frozen "
                         "per-request draw order, 'vectorized' batches the draws "
                         "in numpy (same distribution, different traces)")
    ap.add_argument("--backend", choices=list(BACKENDS), default=None,
                    help="GUS (or class allocator) implementation: 'torch' the "
                         "plain loop, 'cuda' the kernel (default: by the device). "
                         "Applies to the default/'gus' policy only")
    ap.add_argument("--device", default="cuda",
                    help="device the decisions run on ('cuda' or 'cpu')")
    ap.add_argument("--scheduler", choices=["dense", "hierarchical"], default=None,
                    help="scheduling granularity: 'dense' (default) ranks every "
                         "request; 'hierarchical' buckets requests into QoS "
                         "class aggregates first (gus-family policies only)")
    ap.add_argument("--congestion", action="store_true",
                    help="enable load-dependent service times (queueing model)")
    ap.add_argument("--metrics", action="store_true",
                    help="collect the per-frame metric stream (utilization, "
                         "backlog, QoS-class satisfaction, assignment tiers) and "
                         "write it as JSONL under results/telemetry/")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="override the metric stream's JSONL path (default "
                         "results/telemetry/<scenario>-<policy>.metrics.jsonl)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record host spans for the whole run and save a Chrome "
                         "trace-event JSON (chrome://tracing or Perfetto)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run (CUDA "
                         "kernels included on the card) into DIR")
    stream = ap.add_mutually_exclusive_group()
    stream.add_argument("--streaming", dest="streaming", action="store_true", default=None,
                        help="force the bounded-memory arrival stream")
    stream.add_argument("--materialized", dest="streaming", action="store_false",
                        help="force the materialized arrival trace")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and policies, then exit")
    args = ap.parse_args(argv)

    if not args.fleet and (
        args.devices is not None or args.window is not None or args.prefetch is not None
    ):
        ap.error("--devices/--window/--prefetch configure the Monte-Carlo fleet; add --fleet R")

    if args.list:
        print("scenarios:")
        for name in list_scenarios():
            print(f"  {name:15s} {get_scenario(name).description}")
        print("policies:")
        for name in list_policies():
            print(f"  {name:20s} {get_policy(name).description}")
        return

    dev = resolve_device(args.device)
    spec = demo_cluster_spec()
    cfg = SimConfig(
        horizon_ms=args.horizon_s * 1000.0,
        arrival_rate_per_s=args.rate,
        delay_req_ms=args.deadline_ms,
        acc_req_mean=50.0,
        acc_req_std=10.0,
        congestion=CongestionConfig(enabled=args.congestion),
    )
    try:
        scn = get_scenario(args.scenario)
    except KeyError as e:
        raise SystemExit(e.args[0])
    # `gus-np` is the NumPy parity oracle, not a registered policy (it is the
    # thing the registered `gus` is tested against)
    sim_kw = (
        {"scheduler": gus_schedule_np} if args.policy == "gus-np"
        else {"policy": args.policy}
    )
    if args.policy == "gus-np":
        if args.backend is not None:
            raise SystemExit("--backend selects the GUS implementation; gus-np is the "
                             "host-side NumPy oracle")
        if args.scheduler == "hierarchical":
            raise SystemExit("--scheduler hierarchical needs a registered gus-family "
                             "policy (not gus-np)")
    sim_opts = EngineOptions(
        streaming=args.streaming,
        rng_mode=args.rng_mode,
        backend=args.backend,
        scheduler=args.scheduler,
        metrics=args.metrics,
    )
    mode = []
    if args.congestion:
        mode.append("congestion")
    if args.backend is not None:
        mode.append(f"{args.backend}-backend")
    if args.scheduler == "hierarchical":
        mode.append("hier-scheduler")
    if args.streaming or (args.streaming is None and scn.streaming):
        mode.append("streaming")
    if args.rng_mode == "vectorized" or (args.rng_mode is None and scn.rng_mode == "vectorized"):
        mode.append("vectorized-rng")
    tag = f" [{', '.join(mode)}]" if mode else ""
    print(f"=== scenario {scn.name!r} / policy {args.policy!r} on {dev}{tag} ===")
    if args.metrics and args.policy == "gus-np":
        raise SystemExit("--metrics needs a registered policy (not gus-np)")

    fr = None
    rec_ctx = recording() if args.trace else contextlib.nullcontext()
    with profile_trace(args.profile, device=dev), rec_ctx as rec:
        try:
            r = simulate(spec, cfg, **sim_kw, scenario=scn, seed=args.seed,
                         options=sim_opts, device=dev)
        except (KeyError, ValueError) as e:  # unknown policy / ILP too big
            raise SystemExit(str(e.args[0]))
        for k, v in r.as_dict().items():
            print(f"  {k:20s} {float(v):10.3f}")
        if args.metrics:
            # export while the recorder is live: the writer thread's io
            # spans land in the trace beside the simulation's
            out = args.metrics_out or os.path.join(
                "results", "telemetry", f"{scn.name}-{args.policy}.metrics.jsonl")
            with AsyncJsonlWriter(out) as w:
                n_rows = r.metrics.to_jsonl(None, writer=w)
            print(f"=== metrics: {n_rows} rows -> {out} ===")
            for k, v in r.metrics.aggregate().items():
                print(f"  {k:20s} {v}")

        if args.fleet:
            if args.policy == "gus-np":
                raise SystemExit("gus-np is host-only; the fleet needs a registered policy")
            try:
                fleet_opts = dataclasses.replace(
                    sim_opts, devices=args.devices, window=args.window,
                    **({"prefetch": args.prefetch} if args.prefetch is not None else {}),
                )
                fr = simulate_fleet(spec, cfg, **sim_kw, scenario=scn, n_rep=args.fleet,
                                    seed=args.seed, options=fleet_opts, device=dev)
            except ValueError as e:  # bad --devices, ILP uncapped frame, ...
                raise SystemExit(str(e.args[0]))
            print(f"=== fleet: {args.fleet} replications on {fr.n_devices} device(s) "
                  f"({fr.device}) ===")
            for k, v in fr.as_dict().items():
                print(f"  {k:20s} {float(v):10.3f}")
            if args.metrics:
                out = os.path.join(
                    "results", "telemetry", f"{scn.name}-{args.policy}.fleet.metrics.jsonl",
                ) if args.metrics_out is None else args.metrics_out + ".fleet"
                with AsyncJsonlWriter(out) as w:
                    n_rows = fr.metrics.to_jsonl(None, writer=w)
                print(f"=== fleet metrics: {n_rows} rows -> {out} ===")

    if args.trace:
        rec.save(args.trace)
        with open(args.trace) as f:
            errs = validate_chrome_trace(json.load(f))
        cats = sorted(rec.categories())
        print(f"=== trace: {len(rec)} events, categories {cats}, "
              f"{len(rec.thread_ids())} thread(s) -> {args.trace} "
              f"({'valid' if not errs else errs}) ===")
    return r, fr


if __name__ == "__main__":
    main()
