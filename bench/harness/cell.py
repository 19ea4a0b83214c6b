"""One run of one cell: set-up, warm-up, the measured window, the metrics,
the output check.

The window drives the program's serving entry, ``ServingEngine.generate``
(prefill, then greedy decode steps through the cache), once per batch, back
to back: a closed loop with one caller.  A request's time to its first
token is its batch's time from the call to the served tokens on the host
(the call ends in a copy to the host, which waits for the device).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import check as checks
from .manifest import BENCH, family, load_module
from .spans import SpanSummary, by_span_table
from .trace import TraceSummary, Tracer
from .traffic import Traffic
from .weights import layout, leaves, make_weights

__all__ = ["Batch", "Run", "program_config", "Program", "serve_window", "serve_run",
           "metric_values", "check_outputs", "run_cell", "process_seconds"]

#: the configuration file's keys that are not settings of the program
_META = {"name", "arch", "source", "paper", "reduced", "assumed", "published",
         "context_length"}


@dataclasses.dataclass
class Batch:
    index: int          # position in the traffic's sequence of batches
    length: int         # prompt tokens each
    batch: int          # prompts
    new: int            # greedy tokens served each
    start_s: float      # from the window's start, on the host's clock
    end_s: float
    tokens: np.ndarray  # (batch, new) served tokens


@dataclasses.dataclass
class Run:
    """What the metric files read."""
    cfg: dict                       # the configuration file
    batches: List[Batch]            # those of the window
    window_s: float
    setup_s: float
    trace: Optional[TraceSummary]   # with --trace 1
    spans: Optional[SpanSummary] = None   # with --trace 1
    #: the program's counters that grew over the window (``obs.counters``)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


def process_seconds() -> float:
    """Seconds since this process started, from the kernel's clock ticks."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def program_config(c: dict):
    """The program's configuration of the file's ``arch``, held to every
    setting the file states."""
    from repro_torch.configs import get_config

    cfg = get_config(c["arch"])
    differ = {k: (v, getattr(cfg, k)) for k, v in c.items()
              if k not in _META and getattr(cfg, k) != v}
    if differ:
        raise ValueError(f"{c['name']}: the program's configuration {c['arch']!r} differs from "
                         f"the benchmark's file (file, program): {differ}")
    return cfg


class Program:
    """The system under test for one configuration, on ``device``: the
    model and its serving engine over the benchmark's weights."""

    def __init__(self, c: dict, cfg, weights, device):
        import torch
        from repro_torch.models import Model
        from repro_torch.serving import ServingEngine

        self.model = Model(cfg)
        want = {p: tuple(t.shape) for p, t in leaves(self.model.abstract_params())}
        have = {p: l.shape for p, l in leaves(layout(c))}
        if want != have:
            raise ValueError(f"{c['name']}: the program's parameter layout differs from the "
                             "benchmark's")
        self.engine = ServingEngine(self.model, weights, device=torch.device(device))

    def generate(self, tokens, new_tokens: int):
        return self.engine.generate({"tokens": tokens}, max_new_tokens=new_tokens)


def serve_window(program: Program, traffic: Traffic, seconds: float, device,
                 tracer: Tracer, batches: Optional[int] = None):
    """Batches back to back until ``seconds`` have passed (or ``batches``
    are done); (the batches, the window's seconds)."""
    done: List[Batch] = []
    with tracer.window():
        t0 = time.perf_counter()
        end = t0
        i = 0
        while True:
            tokens = traffic.tokens(i, device)
            with tracer.batch():
                tb = time.perf_counter()
                res = program.generate(tokens, traffic.new_tokens)
                end = time.perf_counter()
            done.append(Batch(i, traffic.length(i), traffic.batch, traffic.new_tokens,
                              tb - t0, end - t0, res.tokens))
            i += 1
            if (batches is None and end - t0 >= seconds) or (batches is not None and i >= batches):
                break
    return done, end - t0


def warm_up(program: Program, traffic: Traffic, device) -> None:
    """One batch of every prompt length the traffic sends, at its batch size
    and new tokens: every shape the window will run."""
    for length in sorted(set(traffic.lengths)):
        program.generate(traffic.warmup_tokens(length, device), traffic.new_tokens)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def metric_values(kind: str, metrics: List[dict], run: Run) -> Dict[str, Dict[str, Any]]:
    """{name: {"value", "unit"}} of ``metrics``, each read by its file
    under ``bench/<kind>/``; a metric that reads nothing is left out."""
    out = {}
    for m in metrics:
        mod = load_module(BENCH / kind / f"{m['name']}.py")
        value = mod.value(run) if kind == "e2e" else mod.read(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _mark(marks: list, name: str, sync) -> None:
    if sync is not None:
        sync()
    marks.append((name, process_seconds()))


def check_outputs(c: dict, cell: dict, weights, traffic: Traffic, batches: List[Batch],
                  seed: int, dev, control: bool = False, log=print) -> Dict[str, float]:
    """The output check of a finished window: the widest logit gap of a
    seeded sample of its served tokens against the reference (``gap``),
    with ``control`` also the control's (``control_gap``)."""
    from bench.reference import logits_at

    trunk = family(c).reference.trunk
    t0 = time.perf_counter()
    picks = checks.sample_requests(batches, int(cell["check"]["requests"]), seed,
                                   cell["check"].get("rest", "any"))
    seqs, at, served = checks.compared_sequences(batches, picks, traffic, dev)
    ref = logits_at(c, weights, seqs, at, trunk=trunk)
    ref_s = time.perf_counter() - t0
    ctl = logits_at(c, weights, seqs, at, "fp8", trunk=trunk) if control else None
    gap, ctl_gap, n_tokens = checks.widest_gaps(ref, served, ctl)
    log(f"check: {len(picks)} requests, {n_tokens} served tokens against the reference in "
        f"{ref_s:.1f} s", file=sys.stderr)
    out = {"gap": gap, "requests": len(picks), "served_tokens": n_tokens, "reference_s": ref_s}
    if control:
        out["control_gap"] = ctl_gap
    return out


def serve_run(spec: dict, seed: int, seconds: float, trace: bool, device, program_cfg=None,
              batches: Optional[int] = None, log=print):
    """Set-up, warm-up and the measured window of one run of cell ``spec``
    (``manifest.find_cell``'s), traced with ``trace`` over at most the
    mix's traced window: (the :class:`Run`, the weights, the traffic, the
    card's memory peak in bytes).  ``program_cfg`` stands in for the
    registry's configuration (the tests' small models); ``batches`` ends
    the window after that many batches instead of ``seconds``."""
    import torch

    marks = [("imports", process_seconds())]
    c = spec["config"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else None
    cfg = program_cfg if program_cfg is not None else program_config(c)
    import repro_torch.models  # noqa: F401  (the program's modules, timed apart)
    import repro_torch.serving  # noqa: F401
    from repro_torch.obs import counters

    _mark(marks, "program imports", None)
    torch.empty(1, device=dev)
    _mark(marks, "device ready", sync)
    traffic = Traffic(spec["traffic"], seed, c["vocab_size"], c["context_length"])
    weights = make_weights(c, seed, dev, getattr(torch, c["param_dtype"]))
    _mark(marks, "weights", sync)
    program = Program(c, cfg, weights, dev)
    _mark(marks, "engine", sync)
    warm_up(program, traffic, dev)
    _mark(marks, "warm-up", sync)
    setup_s = marks[-1][1]
    log("set-up: " + ", ".join(f"{k} done at {v:.2f} s" for k, v in marks), file=sys.stderr)
    window = min(seconds, traffic.trace_seconds) if trace else seconds
    tracer = Tracer(trace)
    before = counters.snapshot()
    done, window_s = serve_window(program, traffic, window, dev, tracer, batches)
    counts = counters.delta(before)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    run = Run(c, done, window_s, setup_s, tracer.summary(), tracer.spans, counts)
    return run, weights, traffic, peak


def run_cell(spec: dict, metrics: Dict[str, List[dict]], seed: int, seconds: float,
             trace: bool, device, program_cfg=None, log=print, control: bool = False,
             batches: Optional[int] = None) -> Dict[str, Any]:
    """One run of cell ``spec`` (``manifest.find_cell``'s): :func:`serve_run`,
    the metrics and the output check; the result's line as a dict.  For the
    readings that a limit is set from (``bench/limits.py``), ``control``
    adds the control's gap to the result's ``check``."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    c, cell = spec["config"], spec["cell"]
    run, weights, traffic, peak = serve_run(spec, seed, seconds, trace, dev, program_cfg,
                                            batches, log)
    done = run.batches
    values = metric_values("metrics" if trace else "e2e",
                           metrics["per_layer" if trace else "end_to_end"], run)

    # the output check, with the program's state freed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checked = check_outputs(c, cell, weights, traffic, done, seed, dev, control, log)
    gap, limit = checked["gap"], float(cell["check"]["max_logit_gap"])

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": spec["chips"], "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    requests = sum(b.batch for b in done)
    result = {"correct": bool(gap <= limit), "attempted": requests, "failed": 0,
              "metrics": values, "device": device_info}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
        kind = load_module(BENCH / "metrics" / "elementwise_ns_per_tok.prefill.py").kind
        by_kind: Dict[str, float] = {}
        for n, _, d in run.trace.ops:
            by_kind[kind(n)] = by_kind.get(kind(n), 0.0) + d
        log("device seconds by kind: " + ", ".join(
            f"{k} {v:.4f} ({100 * v / run.trace.busy_s:.1f}%)"
            for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])), file=sys.stderr)
        log("device seconds by span: " + by_span_table(run.spans), file=sys.stderr)
        log("counters: " + ", ".join(f"{k} {v}" for k, v in sorted(run.counters.items())),
            file=sys.stderr)
    log(f"card: {_power_limit() if on_card else 'none'}; {len(done)} batches, {requests} "
        f"requests in {run.window_s:.3f} s", file=sys.stderr)
    result["check"] = checked
    result["compared"] = {"widest_logit_gap": {"value": gap, "limit": limit},
                          "failed_requests": {"value": 0, "limit": 0}}
    return result
