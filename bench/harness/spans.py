"""The program's spans in a device trace: device time and idle by span.

The program marks its serving path with host-side ranges of the profile
(``repro_torch.obs.profiler.annotate``: ``serve/*``, ``model/*``,
``cache/write``, ``norm``, ``mlp``, ``attn/*``, ``ssm/*``), nested as its
calls nest, on the loop's thread.  They have no device-side range, so a
kernel is placed in the span tree by its launch: the runtime call on the
loop's thread (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``, ...) that carries the kernel's correlation id, and
the spans open at that call's start.  That holds however long the kernel
waits in the stream's queue; a span's device-side range (where a span has
one) runs from its first kernel's start to its last one's end and covers
whatever other work ran in between.

:func:`summarize` returns :mod:`.trace`'s :class:`TraceSummary`, with
every device-side range of a span left out (``bench/window`` and
``bench/batch`` as before, and any other span that has one), and each
idle gap labelled ``<innermost program span> / <innermost host op>``
(``... / host (between ops)`` where no op is open); with no program span
open the label is the innermost host op's alone.  Beside it a
:class:`SpanSummary`: device seconds by span, with and without the
children's, and the idle seconds by the part of the serving path the host
was in at the gap's middle.  It is the benchmark's only reduction of a
trace (:meth:`.trace.Tracer.summary`).  :data:`METRICS` are the per-layer
metrics that read a run's spans and counters, one file each under
``bench/metrics/`` (:func:`read_metric`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .trace import HOST_ONLY, TraceSummary, union_busy

__all__ = ["SpanSummary", "summarize", "is_span", "idle_ms_per_batch", "ns_per_token", "METRICS",
           "read_metric", "by_span_table"]

#: the program's spans named without a ``/``
BARE_SPANS = ("norm", "mlp")
#: the serving call and its prefill: the scopes of the idle split
GENERATE, PREFILL = "serve/generate", "serve/prefill"


def is_span(name: str) -> bool:
    """A program span: ``<part>/<name>`` (not the benchmark's ``bench/``),
    or one of :data:`BARE_SPANS`.  Operators are ``aten::...``, runtime
    calls ``cu...``, the profiler's own markers words with spaces."""
    if name in BARE_SPANS:
        return True
    head, sep, _ = name.partition("/")
    return bool(sep) and head.isidentifier() and head != "bench"


def is_runtime(name: str) -> bool:
    """A call of the CUDA runtime (``cuda*``) or of its lower-level API
    (``cu*``)."""
    return name.startswith("cu")


@dataclasses.dataclass
class SpanSummary:
    #: device seconds of the kernels launched inside each span (by name),
    #: its children's included, and only those it launched itself
    device_s: Dict[str, float]
    self_s: Dict[str, float]
    #: device seconds of kernels launched outside every span, or whose
    #: launch is not in the loop thread's events
    unattributed_s: float
    #: idle seconds by where the host was at the gap's middle: ``engine``
    #: (in serve/generate, outside serve/prefill), ``model`` (in
    #: serve/prefill), ``outside`` (in no serve/generate)
    idle_s: Dict[str, float]
    #: span instances that start in the window
    spans: int


def _open_at(events: Sequence[tuple], points: Sequence[float]) -> List[Tuple[str, ...]]:
    """For each of ``points`` (ascending), the names of ``events``
    (name, start, end, ...; nested, one thread's) open at it, outermost
    first."""
    events = sorted(events, key=lambda e: e[1])
    out, stack, j = [], [], 0
    for t in points:
        while j < len(events) and events[j][1] <= t:
            while stack and stack[-1][2] <= events[j][1]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(tuple(e[0] for e in stack))
    return out


def _scope(stack: Tuple[str, ...]) -> str:
    if PREFILL in stack:
        return "model"
    return "engine" if GENERATE in stack else "outside"


def summarize(device_events, host_events, window: Tuple[float, float]
              ) -> Tuple[TraceSummary, SpanSummary]:
    """``device_events`` (name, start, end, correlation id, whether a
    span's device-side range) and ``host_events`` (name, start, end,
    correlation id) of the loop's thread, in seconds of one clock;
    ``window`` (start, end) on it."""
    w0, w1 = window
    kept = [(n, a, b, c) for n, a, b, c, user in device_events
            if not user and not n.startswith("bench/") and b > w0 and a < w1]
    kept.sort(key=lambda o: max(o[1], w0))
    ops = [(n, max(a, w0) - w0, min(b, w1) - max(a, w0)) for n, a, b, _ in kept]
    busy, merged = union_busy([(s, s + d) for _, s, d in ops])
    by_name: Dict[str, float] = {}
    for n, _, d in ops:
        by_name[n] = by_name.get(n, 0.0) + d
    gaps, at = [], 0.0
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < w1 - w0:
        gaps.append((at, w1 - w0))

    host = [(n, a - w0, b - w0) for n, a, b, _ in host_events
            if not n.startswith("bench/") and b > w0 and a < w1]
    spans = [e for e in host if is_span(e[0])]
    others = [e for e in host if not is_span(e[0])]
    mids = [0.5 * (a + b) for a, b in gaps]
    idle: Dict[str, float] = {}
    idle_s = {"engine": 0.0, "model": 0.0, "outside": 0.0}
    for (a, b), op, sp in zip(gaps, _open_at(others, mids), _open_at(spans, mids)):
        label = op[-1] if op else HOST_ONLY
        if sp:
            label = f"{sp[-1]} / {label}"
        idle[label] = idle.get(label, 0.0) + (b - a)
        idle_s[_scope(sp)] += b - a

    # each kernel at its launch: the runtime call with its correlation id
    launch = {c: a - w0 for n, a, _, c in host_events if c and is_runtime(n)}
    found = sorted((launch[c], d) for (_, _, d), (_, _, _, c) in zip(ops, kept) if c in launch)
    device_s: Dict[str, float] = {}
    self_s: Dict[str, float] = {}
    attributed = 0.0
    for (_, d), stack in zip(found, _open_at(spans, [t for t, _ in found])):
        if not stack:
            continue
        attributed += d
        for name in set(stack):
            device_s[name] = device_s.get(name, 0.0) + d
        self_s[stack[-1]] = self_s.get(stack[-1], 0.0) + d
    trace = TraceSummary(
        ops=ops, window_s=w1 - w0, busy_s=busy,
        op_seconds=sorted(by_name.items(), key=lambda kv: -kv[1]),
        idle_seconds=sorted(idle.items(), key=lambda kv: -kv[1]),
    )
    return trace, SpanSummary(device_s, self_s, sum(d for _, _, d in ops) - attributed, idle_s,
                              sum(1 for _, a, _ in spans if a >= 0))


def idle_ms_per_batch(scope: str):
    """The reader of idle ms a batch whose gaps' middles lie in ``scope``
    (``engine``, ``model`` or ``outside``)."""
    def read(spans: SpanSummary, counts: Dict[str, int]) -> Optional[float]:
        batches = counts.get("serve.batches", 0)
        if not batches or GENERATE not in spans.device_s:
            return None
        return 1e3 * spans.idle_s[scope] / batches
    return read


def ns_per_token(*names: str):
    """The reader of the device ns a prompt token of the kernels launched
    inside the spans ``names``; ``None`` where none ran."""
    def read(spans: SpanSummary, counts: Dict[str, int]) -> Optional[float]:
        tokens = counts.get("serve.prompt_tokens", 0)
        seconds = sum(spans.device_s.get(n, 0.0) for n in names)
        return 1e9 * seconds / tokens if tokens and seconds > 0 else None
    return read


#: per-layer metrics of a traced window: (its spans, the window's counter
#: deltas) -> value, or None where the program gave no such span
METRICS: Dict[str, Callable[[SpanSummary, Dict[str, int]], Optional[float]]] = {
    # device idle a batch whose middle the host spent in the engine's own
    # code (cache allocation, the waits, the greedy pick, the copy out)
    "engine_idle_ms_per_batch.prefill": idle_ms_per_batch("engine"),
    # ... and inside the model's prefill (host dispatch of the layers)
    "model_idle_ms_per_batch.prefill": idle_ms_per_batch("model"),
    # device time of the norms (the layers' pre-norms and the final one) a
    # prompt token
    "norm_ns_per_tok.prefill": ns_per_token("norm"),
    # ... of the Mamba-2 block's gated norm
    "gated_norm_ns_per_tok.prefill": ns_per_token("ssm/gated_norm"),
    # ... of the Mamba-2 block's causal conv and SiLU
    "ssm_conv_ns_per_tok.prefill": ns_per_token("ssm/conv"),
}


def read_metric(name: str, run) -> Optional[float]:
    """:data:`METRICS` ``name`` of a run (``cell.Run``): ``None`` unless
    it was traced."""
    return None if run.spans is None else METRICS[name](run.spans, run.counters)


def by_span_table(spans: SpanSummary, top: int = 15) -> str:
    """The spans with the most device time: seconds with and without their
    children's, and their share of the attributed time."""
    total = spans.device_s.get(GENERATE) or max(spans.device_s.values(), default=0.0) or 1.0
    rows = sorted(spans.device_s.items(), key=lambda kv: -kv[1])[:top]
    return ", ".join(f"{n} {s:.4f} (self {spans.self_s.get(n, 0.0):.4f}, {100 * s / total:.1f}%)"
                     for n, s in rows)
