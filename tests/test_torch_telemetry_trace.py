"""The port's span tracing (``repro_torch.obs.trace``), on the CPU.

The reference's tracing tests (``tests/test_telemetry.py``) run against
the port: spans are inert without a recorder, ``Stopwatch`` accumulates
with tracing off, a recording has the pipeline's categories and a valid
Chrome-trace schema, the validator rejects garbage, the fleet producer's
spans sit on its own thread id, and the timing fields are built from the
same spans.  The two validators accept each other's traces: the port's
saved trace passes ``repro.obs.validate_chrome_trace``, and the
reference's golden trace passes the port's.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.obs as RO  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.obs as PO  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPEC = P.demo_cluster_spec()


def cfg(**kw) -> P.SimConfig:
    base = dict(horizon_ms=4000.0, arrival_rate_per_s=4.0, delay_req_ms=3000.0,
                acc_req_mean=50.0, acc_req_std=10.0,
                admission=P.AdmissionConfig(enabled=True, shed=True, queue_cap_mult=2.0))
    base.update(kw)
    return P.SimConfig(**base)


def fleet(**opts):
    return P.simulate_fleet(SPEC, cfg(), n_rep=2, seed=0, device="cpu",
                            options=P.EngineOptions(**opts))


def test_obs_exports_the_reference_names():
    assert PO.__all__ == RO.__all__
    assert all(hasattr(PO, name) for name in PO.__all__)
    assert PO.QOS_ACC_EDGES == RO.QOS_ACC_EDGES
    assert PO.MetricsFrame._fields == RO.MetricsFrame._fields


def test_span_inert_without_recorder():
    assert PO.active_recorder() is None
    with PO.span("unit/x") as s:
        pass
    assert s.elapsed_s >= 0.0
    PO.instant("unit/i")  # a no-op, must not raise
    assert PO.active_recorder() is None


def test_stopwatch_accumulates_with_tracing_off():
    sw = PO.Stopwatch()
    for name in ("a", "a", "b"):
        with sw.span(name, PO.CAT_BUILD, arg=1):
            pass
    assert sw.total("a") > 0.0
    assert sw.total("a", "b") == pytest.approx(sw.total("a") + sw.total("b"))
    assert set(sw.as_dict()) == {"a", "b"}


def test_recording_scopes_and_schema(tmp_path):
    with PO.recording() as rec:
        fleet(metrics=True)
    assert PO.active_recorder() is None
    assert {"gen", "build", "dispatch", "metrics", "compile"} <= rec.categories()
    assert {"fleet/dispatch", "fleet/window_metrics", "fleet/grid_build"} <= rec.span_names()
    path = tmp_path / "trace.json"
    rec.save(path)
    obj = json.loads(path.read_text())
    assert PO.validate_chrome_trace(obj) == []
    assert RO.validate_chrome_trace(obj) == []  # the reference's validator too
    assert any(e["ph"] == "M" for e in obj["traceEvents"])
    dispatch = [e for e in obj["traceEvents"] if e.get("name") == "fleet/dispatch"]
    assert dispatch and dispatch[0]["cat"] == "dispatch" and dispatch[0]["args"] == {"window": 0}
    # after the recorder is gone, new spans do not grow it
    n = len(rec)
    with PO.span("unit/after"):
        pass
    assert len(rec) == n


def test_recording_covers_simulate_and_the_hierarchical_fleet():
    with PO.recording() as rec:
        P.simulate(SPEC, cfg(), seed=0, device="cpu")
        P.simulate_fleet(SPEC, cfg(), n_rep=2, seed=0, device="cpu", scenario="flash-crowd",
                         options=P.EngineOptions(scheduler="hierarchical", streaming=True,
                                                 window=1))
    names = rec.span_names()
    assert {"sim/frame_build", "sim/schedule", "sim/realize", "sim/arrival_pull"} <= names
    assert {"fleet/hier_build", "fleet/hier_aggregate", "fleet/hier_post"} <= names
    cats = {e["name"]: e["cat"] for e in rec.events() if e["ph"] == "X"}
    assert cats["sim/schedule"] == "sched" and cats["sim/realize"] == "metrics"
    assert cats["fleet/hier_post"] == "metrics" and cats["fleet/hier_build"] == "build"


def test_validate_chrome_trace_rejects_garbage():
    assert PO.validate_chrome_trace(42)
    assert PO.validate_chrome_trace({"nope": []})
    assert PO.validate_chrome_trace({"traceEvents": [{"ph": "Z"}]})
    bad_dur = {"traceEvents": [
        {"ph": "X", "name": "a", "cat": "c", "pid": 1, "tid": 1, "ts": 0.0, "dur": -1.0}
    ]}
    assert PO.validate_chrome_trace(bad_dur)


@pytest.mark.parametrize("scheduler,producer", [
    ("dense", "fleet-window-producer"), ("hierarchical", "fleet-hier-producer"),
])
def test_producer_thread_spans_on_own_tid(scheduler, producer):
    with PO.recording() as rec:
        fleet(window=1, prefetch=1, scheduler=scheduler)
    trace = rec.to_chrome_trace()
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    assert producer in names.values()
    prod_tid = next(t for t, n in names.items() if n == producer)
    prod_spans = {e["name"] for e in trace["traceEvents"]
                  if e["ph"] == "X" and e["tid"] == prod_tid}
    assert prod_spans >= {"fleet/arrivals", "fleet/grid_build"}
    # the consumer's spans are not on the producer's track
    assert "fleet/dispatch" not in prod_spans
    assert len(rec.thread_ids()) >= 2


def test_timings_fields_derive_from_spans():
    r = P.simulate(SPEC, cfg(), seed=0, device="cpu")
    assert set(r.timings) >= {"gen_s", "build_s", "sched_s", "realize_s", "total_s"}
    assert all(v >= 0.0 for v in r.timings.values())
    fr = fleet()
    assert fr.timings["total_s"] > 0.0
    assert fr.gen_s == pytest.approx(
        fr.timings.get("fleet/generate_traces", 0.0) + fr.timings.get("fleet/window_wait", 0.0)
    )
    assert fr.dispatch_s == pytest.approx(fr.timings.get("fleet/dispatch", 0.0))


def test_golden_trace_passes_the_port_validator():
    obj = json.loads((ROOT / "results" / "telemetry" / "golden_trace.json").read_text())
    assert PO.validate_chrome_trace(obj) == []
    cats = {e["cat"] for e in obj["traceEvents"] if e["ph"] != "M"}
    assert len(cats) >= 4
    assert len({e["tid"] for e in obj["traceEvents"]}) >= 2


def test_kernel_library_load_drops_a_compile_instant(monkeypatch, tmp_path):
    """A library's first load drops ``compile/<name>`` on an active
    recorder, once (the build and the library are stubbed: no ``nvcc``
    here)."""
    from repro_torch.kernels import build as PB

    class Info:
        path = tmp_path / "libx.so"
        seconds = 1.5

    monkeypatch.setattr(PB, "build_libraries", lambda names: {n: Info() for n in names})
    monkeypatch.setattr(PB.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(PB, "_LOADED", {})
    with PO.recording() as rec:
        PB.load_library("unit_kernel")
        PB.load_library("unit_kernel")  # served from the cache: no second event
    ev = [e for e in rec.events() if e["ph"] == "i"]
    assert [(e["name"], e["cat"]) for e in ev] == [("compile/unit_kernel", "compile")]
