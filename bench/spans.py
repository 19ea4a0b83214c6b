"""A cell's traced window split by the program's spans.

    python3 bench/spans.py --workload <cell> --seed <n> [--seconds S]

from the root of a checkout.  Sets the cell up and serves it as every
``bench/run.py`` run does (``cell.serve_run``: weights and prompts from the
seed, every shape warmed up), for ``--seconds`` (at most and by default the
mix's traced window) under ``torch.profiler``, with the trace reduced by
``bench/harness/spans.py``:
device seconds by span (with and without the children's), idle seconds by
``<span> / <host op>`` and by part of the serving path, the window's
counters (``repro_torch.obs.counters``), the span metrics
(``spans.METRICS``), the benchmark's per-layer metrics of the cell on the
same window, and the cross-checks of the spans against the kernels' names
and the harness's own counts.  The host's cost of one span, off and under
a recording profile, is timed at the end.  The last line of standard
output is one JSON object; standard error has the tables.  Checks no
output: ``bench/run.py`` does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: annotate calls timed for the host cost of a span
SPAN_COST_CALLS = 20000


def span_cost_us(calls: int = SPAN_COST_CALLS):
    """Host microseconds of one ``with annotate(...)`` with no profile
    recording, and under a recording CPU profile."""
    import torch
    from repro_torch.obs.profiler import annotate

    def timed():
        t0 = time.perf_counter()
        for _ in range(calls):
            with annotate("bench/span_cost"):
                pass
        return (time.perf_counter() - t0) * 1e6 / calls

    off = timed()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = timed()
    return off, on


def trace_spans(spec: dict, metrics, seed: int, seconds: float, device, program_cfg=None,
                batches=None, log=print) -> dict:
    """One traced window of cell ``spec`` (``manifest.find_cell``'s), as
    the JSON object this script prints; set up and served by
    ``cell.serve_run``, the path of every ``bench/run.py`` run;
    ``program_cfg`` and ``batches`` as there."""
    import torch

    from bench.harness.cell import metric_values, serve_run
    from bench.harness.spans import METRICS, by_span_table

    dev = torch.device(device)
    run, _, _, _ = serve_run(spec, seed, seconds, True, dev, program_cfg, batches, log)
    trace, spans, counts, done, window_s = (run.trace, run.spans, run.counters, run.batches,
                                            run.window_s)
    per_layer = {n: v["value"] for n, v in metric_values("metrics", metrics["per_layer"],
                                                          run).items()}
    span_metrics = {n: v for n, read in METRICS.items()
                    if (v := read(spans, counts)) is not None}
    tokens = sum(b.batch * b.length for b in done)
    n = len(done)
    named = {k: sum(d for _, _, d in trace.kernels(k)) for k in ("flash_attention", "ssd_scan")}
    device_total = sum(d for _, _, d in trace.ops)
    checks = {
        "batches": n,
        "prompt_tokens": tokens,
        "counted_prompt_tokens": counts.get("serve.prompt_tokens", 0),
        "device_s": device_total,
        "attributed_share": 1 - spans.unattributed_s / device_total if device_total else None,
        "generate_self_share": (spans.self_s.get("serve/generate", 0.0)
                                / spans.device_s["serve/generate"]
                                if spans.device_s.get("serve/generate") else None),
        "attn_core_over_flash": (spans.device_s.get("attn/core", 0.0) / named["flash_attention"]
                                 if named["flash_attention"] else None),
        "ssm_scan_over_ssd_scan": (spans.device_s.get("ssm/scan", 0.0) / named["ssd_scan"]
                                   if named["ssd_scan"] else None),
        "launches_per_batch": {k: v / n for k, v in counts.items()
                               if k.startswith("kernel.launches.")} if n else {},
        "kernel_builds": counts.get("kernel.builds", 0),
        "spans": spans.spans,
        "spans_per_batch": spans.spans / n if n else None,
    }
    off, on = span_cost_us()
    out = {
        "workload": spec["name"], "seed": seed, "window_s": window_s,
        "traced_window_s": trace.window_s, "busy_s": trace.busy_s,
        "per_layer": per_layer, "span_metrics": span_metrics, "counters": counts,
        "device_s_by_span": spans.device_s, "self_s_by_span": spans.self_s,
        "unattributed_s": spans.unattributed_s, "idle_s_by_scope": spans.idle_s,
        "idle_gaps": trace.breakdown()["idle_gaps"], "checks": checks,
        "span_cost_us": {"off": off, "profiled": on},
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
    }
    log("device seconds by span: " + by_span_table(spans), file=sys.stderr)
    log("idle seconds by span / host op: " + ", ".join(
        f"{k} {v:.4f}" for k, v in trace.idle_seconds[:15]), file=sys.stderr)
    log("counters: " + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())),
        file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.run import _caches

    _caches()
    from bench.harness.manifest import cell_metrics, find_cell, load_manifest

    manifest = load_manifest(ROOT)
    spec = find_cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    seconds = args.seconds or float(spec["traffic"]["trace_seconds"])
    out = trace_spans(spec, cell_metrics(manifest, args.workload), args.seed, seconds, "cuda")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
