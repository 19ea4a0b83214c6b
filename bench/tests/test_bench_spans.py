"""The span reduction (``bench/harness/spans.py``) on made-up events, its
metrics by hand, and a traced run's window (``run_cell`` and
``bench/spans.py``, one path) on small models on the CPU."""
from __future__ import annotations

import dataclasses

import pytest

from bench.harness.cell import Run
from bench.harness.manifest import BENCH, load_module
from bench.harness.spans import METRICS, SpanSummary, is_span, summarize
from bench.harness.trace import HOST_ONLY

torch = pytest.importorskip("torch")

WINDOW = (0.0, 12.0)


def _dev(events, corr=None, user=()):
    """(name, start, end) -> (name, start, end, correlation id, user range)."""
    corr = corr or {}
    return [(n, a, b, corr.get(i, 0), i in user) for i, (n, a, b) in enumerate(events)]


def _host(events, corr=None):
    corr = corr or {}
    return [(n, a, b, corr.get(i, 0)) for i, (n, a, b) in enumerate(events)]


CASES = {
    # test_bench_metrics.py::test_trace_reduction's events
    "reduction": ([("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0), ("outside", 20.0, 21.0)],
                  [("aten::mm", 3.2, 4.5), ("cudaLaunchKernel", 3.4, 3.6),
                   ("aten::add", 6.5, 9.5)]),
    # the benchmark's own spans, nested ops, a gap in none
    "bench spans": ([("k", 0.5, 1.0), ("Memcpy DtoH (Device -> Pageable)", 4.0, 4.2),
                     ("k", 7.0, 11.0)],
                    [("bench/batch", 0.0, 6.0), ("aten::copy_", 1.5, 5.0),
                     ("cudaMemcpyAsync", 1.6, 4.3), ("bench/batch", 6.0, 12.0),
                     ("aten::mul", 6.1, 6.3)]),
}


#: the trace summary of each case by the reduction that ``bench/harness/trace.py`` had
#: before the span reduction became the only one, as it printed them
OLD = {
    "reduction": {
        "ops": [("k1", 1.0, 1.0), ("k2", 1.5, 1.5), ("k1", 5.0, 1.0)], "window_s": 12.0,
        "busy_s": 3.0, "op_seconds": [("k1", 2.0), ("k2", 1.5)],
        "idle_seconds": [("aten::add", 6.0), ("aten::mm", 2.0), (HOST_ONLY, 1.0)]},
    "bench spans": {
        "ops": [("k", 0.5, 0.5), ("Memcpy DtoH (Device -> Pageable)", 4.0, 0.20000000000000018),
                ("k", 7.0, 4.0)], "window_s": 12.0, "busy_s": 4.7,
        "op_seconds": [("k", 4.5), ("Memcpy DtoH (Device -> Pageable)", 0.20000000000000018)],
        "idle_seconds": [(HOST_ONLY, 4.3), ("cudaMemcpyAsync", 3.0)]},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_without_program_spans_the_trace_summary_is_the_old_one(case):
    dev, host = CASES[case]
    want = OLD[case]
    # a device-side range of the benchmark's span is left out, as the old tracer left it out
    got, spans = summarize(_dev(dev + [("bench/batch", 0.0, 6.0)], user={len(dev)}),
                           _host(host), WINDOW)
    assert dataclasses.asdict(got) == want
    assert spans.device_s == {} and spans.spans == 0
    assert spans.unattributed_s == pytest.approx(sum(d for _, _, d in want["ops"]))


# a batch: generate [0, 10] > prefill [1, 8] > layer [1.5, 7] > norm [2, 3], attn/core [3, 4];
# launches (runtime calls, correlation 11-15) inside norm, attn/core, the layer, generate, and
# outside every span; the card runs each kernel well after its launch
HOST = [("serve/generate", 0.0, 10.0), ("serve/prefill", 1.0, 8.0), ("model/layer", 1.5, 7.0),
        ("norm", 2.0, 3.0), ("cudaLaunchKernel", 2.5, 2.6), ("attn/core", 3.0, 4.0),
        ("cudaLaunchKernel", 3.5, 3.6), ("aten::add", 4.9, 5.2), ("cudaLaunchKernel", 5.0, 5.1),
        ("serve/sync", 8.0, 9.5), ("cudaDeviceSynchronize", 8.1, 9.4),
        ("cudaLaunchKernel", 9.6, 9.7), ("aten::randint", 10.5, 10.9),
        ("cudaLaunchKernel", 10.6, 10.7)]
HOST_CORR = {4: 11, 6: 12, 8: 13, 11: 14, 13: 15}
DEV = [("elementwise_kernel", 4.0, 5.0), ("flash_attention_wgmma_kernel", 5.0, 7.0),
       ("vectorized_elementwise_kernel", 7.0, 7.5), ("argmax_kernel", 9.8, 10.0),
       ("randint_kernel", 11.0, 11.5), ("serve/prefill", 4.0, 7.5)]
DEV_CORR = {0: 11, 1: 12, 2: 13, 3: 14, 4: 15}


def _batch():
    return summarize(_dev(DEV, DEV_CORR, user={5}), _host(HOST, HOST_CORR), WINDOW)


def test_a_span_device_range_is_left_out():
    trace, _ = _batch()
    assert "serve/prefill" not in dict(trace.op_seconds)
    assert trace.busy_s == pytest.approx(1.0 + 2.0 + 0.5 + 0.2 + 0.5)
    assert len(trace.ops) == 5


def test_kernels_go_to_the_spans_open_at_their_launch():
    _, spans = _batch()
    assert spans.device_s == pytest.approx({
        "serve/generate": 1.0 + 2.0 + 0.5 + 0.2, "serve/prefill": 3.5, "model/layer": 3.5,
        "norm": 1.0, "attn/core": 2.0})
    assert spans.self_s == pytest.approx({"norm": 1.0, "attn/core": 2.0, "model/layer": 0.5,
                                          "serve/generate": 0.2})
    assert spans.unattributed_s == pytest.approx(0.5)  # the harness's own kernel
    assert spans.spans == 6


def test_idle_gaps_are_labelled_by_span_and_host_op():
    trace, spans = _batch()
    # gaps [0, 4] (mid 2.0: norm, no op), [7.5, 9.8] (mid 8.65: serve/sync in the wait),
    # [10, 11] (mid 10.5: aten::randint, no span), [11.5, 12] (mid 11.75: nothing)
    assert dict(trace.idle_seconds) == pytest.approx({
        f"norm / {HOST_ONLY}": 4.0, "serve/sync / cudaDeviceSynchronize": 2.3,
        "aten::randint": 1.0, HOST_ONLY: 0.5})
    assert spans.idle_s == pytest.approx({"model": 4.0, "engine": 2.3, "outside": 1.5})


def test_span_names():
    for name in ("serve/generate", "model/layer", "cache/write", "norm", "mlp", "attn/core",
                 "ssm/gated_norm", "fleet/window#3", "sim/schedule"):
        assert is_span(name), name
    for name in ("bench/batch", "aten::mul", "cudaLaunchKernel", "Command Buffer Full",
                 "Memcpy DtoH (Device -> Pageable)", "Activity Buffer Request"):
        assert not is_span(name), name


def test_span_metrics_by_hand():
    spans = SpanSummary(
        device_s={"serve/generate": 2.0, "norm": 0.3, "ssm/gated_norm": 0.2, "ssm/conv": 0.4},
        self_s={}, unattributed_s=0.0, idle_s={"engine": 0.012, "model": 0.006, "outside": 0.1},
        spans=0)
    counts = {"serve.batches": 4, "serve.prompt_tokens": 1000}
    want = {"engine_idle_ms_per_batch.prefill": 3.0, "model_idle_ms_per_batch.prefill": 1.5,
            "norm_ns_per_tok.prefill": 0.3e9 / 1000, "gated_norm_ns_per_tok.prefill": 0.2e9 / 1000,
            "ssm_conv_ns_per_tok.prefill": 0.4e9 / 1000}
    got = {n: read(spans, counts) for n, read in METRICS.items()}
    assert got == pytest.approx(want)
    # each metric's file reads a run's spans and counters through METRICS
    run = Run({}, [], 1.0, 0.0, None, spans, counts)
    files = {n: load_module(BENCH / "metrics" / f"{n}.py").read for n in METRICS}
    assert {n: read(run) for n, read in files.items()} == pytest.approx(want)
    # a run not traced reads nothing
    assert all(read(Run({}, [], 1.0, 0.0, None)) is None for read in files.values())
    # a dense model's spans: no Mamba-2 block, so no conv and no gated norm
    dense = dataclasses.replace(spans, device_s={"serve/generate": 2.0, "norm": 0.3})
    got = {n: read(Run({}, [], 1.0, 0.0, None, dense, counts)) for n, read in files.items()}
    assert got["ssm_conv_ns_per_tok.prefill"] is None
    assert got["gated_norm_ns_per_tok.prefill"] is None
    assert got["norm_ns_per_tok.prefill"] == pytest.approx(0.3e9 / 1000)
    # a program without spans (no serve/generate, no norm) reads nothing
    bare = SpanSummary({}, {}, 1.0, {"engine": 0.0, "model": 0.0, "outside": 0.5}, 0)
    assert all(read(bare, counts) is None for read in METRICS.values())
    assert all(read(spans, {}) is None for read in METRICS.values())


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_a_small_window_on_the_cpu(family, monkeypatch):
    """A traced ``run_cell`` fills its run's spans and counters and prints
    them; ``bench/spans.py`` serves its window through the same path."""
    from conftest import CELL, program_config, small_spec

    from bench.harness import cell
    from bench.harness.manifest import cell_metrics, load_manifest
    from bench.spans import trace_spans

    runs, lines = [], []
    serve_run = cell.serve_run

    def kept(*a, **k):
        out = serve_run(*a, **k)
        runs.append(out[0])
        return out

    monkeypatch.setattr(cell, "serve_run", kept)
    spec = small_spec(family, lengths=(40, 70), per_cycle=(1, 1))
    metrics = cell_metrics(load_manifest(), CELL[family])
    L = spec["config"]["num_layers"]
    kernel = "flash_attention" if family == "dense" else "ssd"
    # a batch: generate, cache_init, 3 syncs, prefill, greedy, to_host; embed; 9 spans a layer;
    # unembed and its norm
    per_batch = 8 + 1 + 9 * L + 2

    result = cell.run_cell(spec, metrics, 2**33 + 3, 1.0, True, "cpu",
                           program_cfg=program_config(spec["config"]), batches=3,
                           log=lambda *a, **k: lines.append(" ".join(map(str, a))))
    run = runs[-1]
    assert result["correct"] and len(run.batches) == 3
    assert isinstance(run.spans, SpanSummary) and run.spans.spans == 3 * per_batch
    assert run.counters["serve.batches"] == 3
    assert run.counters["serve.prompt_tokens"] == sum(b.batch * b.length for b in run.batches)
    assert run.counters[f"kernel.launches.{kernel}.plain"] == 3 * L
    assert any(x.startswith("device seconds by span: ") for x in lines)
    assert any(x.startswith("counters: ") and "serve.batches 3" in x for x in lines)

    out = trace_spans(spec, metrics, 2**33 + 5, 1.0, "cpu",
                      program_cfg=program_config(spec["config"]), batches=3,
                      log=lambda *a, **k: None)
    assert len(runs) == 2 and out["counters"] == runs[-1].counters
    checks = out["checks"]
    assert checks["batches"] == 3 and out["counters"]["serve.batches"] == 3
    assert checks["counted_prompt_tokens"] == checks["prompt_tokens"] > 0
    assert checks["spans_per_batch"] == per_batch
    assert checks["launches_per_batch"] == {f"kernel.launches.{kernel}.plain": L}
    assert checks["kernel_builds"] == 0 and out["device"] == "cpu"
    assert out["span_cost_us"]["off"] > 0 and out["span_cost_us"]["profiled"] > 0
    # the cell's span metrics in its per-layer line are those the script prints
    assert {n: v for n, v in out["per_layer"].items() if n in METRICS} == out["span_metrics"]
