"""The port's scenario-runner CLI (``python -m repro_torch.launch.run_scenario``),
on the CPU, against the reference's ``examples/run_scenario.py``.

The reference's documented telemetry call runs through both CLIs with
``--device cpu`` for the port: the port's trace passes both validators with
at least 4 categories and 2 threads, its JSONL rows sum to the printed
result, and they equal the reference CLI's rows (integers exactly, floats
within ``rtol=1e-5, atol=1e-6``: ROADMAP.md §3 "Reduction order").
"""
from __future__ import annotations

import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as RO  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.launch import run_scenario as cli  # noqa: E402
from repro_torch.obs import validate_chrome_trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DOC_CALL = ["--scenario", "sustained-overload", "--congestion", "--metrics",
            "--horizon-s", "6"]
ROW_INTS = ("frame", "n_arrivals", "n_served", "n_satisfied", "n_shed", "n_refused", "tier",
            "qos_sat", "qos_count")


def _reference_cli():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import run_scenario
    finally:
        sys.path.pop(0)
    return run_scenario


def _rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_list(capsys):
    assert cli.main(["--list"]) is None
    out = capsys.readouterr().out
    for name in P.list_scenarios() + P.list_policies():
        assert f"  {name}" in out


def test_documented_call_writes_a_valid_trace_and_rows_equal_to_the_reference(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / "trace.json"
    r, fr = cli.main(DOC_CALL + ["--trace", str(trace), "--device", "cpu"])
    assert fr is None and r.metrics is not None
    obj = json.loads(trace.read_text())
    assert validate_chrome_trace(obj) == [] and RO.validate_chrome_trace(obj) == []
    events = obj["traceEvents"]
    assert len({e["cat"] for e in events if e["ph"] != "M"}) >= 4
    assert len({e["tid"] for e in events}) >= 2
    out = tmp_path / "results" / "telemetry" / "sustained-overload-gus.metrics.jsonl"
    rows = _rows(out)
    assert sum(row["n_satisfied"] for row in rows) == r.n_satisfied
    assert sum(row["n_arrivals"] for row in rows) == r.n_requests
    assert sum(row["n_served"] for row in rows) == r.n_served

    # the reference CLI's rows for the same call
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    monkeypatch.chdir(ref_dir)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref_r, _ = _reference_cli().main(DOC_CALL)
    assert ref_r.as_dict() == r.as_dict()
    ref_rows = _rows(ref_dir / "results" / "telemetry" / "sustained-overload-gus.metrics.jsonl")
    assert len(ref_rows) == len(rows)
    for a, b in zip(ref_rows, rows):
        assert set(a) == set(b)
        for k in ROW_INTS:
            assert a[k] == b[k], k
        for k in set(a) - set(ROW_INTS):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_fleet_metrics_and_the_numpy_oracle(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    r, fr = cli.main(["--scenario", "flash-crowd", "--metrics", "--horizon-s", "6",
                      "--fleet", "2", "--window", "1", "--device", "cpu"])
    rows = _rows(tmp_path / "results" / "telemetry" / "flash-crowd-gus.fleet.metrics.jsonl")
    assert len(rows) == fr.n_rep * fr.n_frames
    assert sum(row["n_arrivals"] for row in rows) == fr.n_requests
    assert sum(row["n_served"] for row in rows) == fr.n_served
    assert "served_pct" in capsys.readouterr().out
    # gus-np, the NumPy oracle, schedules as the registered gus does
    r_np, _ = cli.main(["--scenario", "flash-crowd", "--policy", "gus-np", "--horizon-s", "6",
                        "--device", "cpu"])
    r_gus, _ = cli.main(["--scenario", "flash-crowd", "--horizon-s", "6", "--device", "cpu"])
    assert r_np.as_dict() == r_gus.as_dict()


def test_devices_above_one_exits_naming_item_9():
    """``--devices`` (item 9) above the devices a CPU run sees exits with
    the fleet's error, never running on fewer."""
    with pytest.raises(SystemExit, match="local device"):
        cli.main(["--fleet", "2", "--devices", "2", "--horizon-s", "3", "--device", "cpu"])
    with pytest.raises(SystemExit):  # --devices configures the fleet
        cli.main(["--devices", "2", "--device", "cpu"])


def test_runs_on_the_card_unless_asked_for_the_cpu():
    """Without ``--device`` the runner asks for the card; without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the runner runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--horizon-s", "3"])
