"""The port's metric streams against the JAX reference, on the CPU.

* ``MetricsResult`` on the same stacked arrays aggregates, rolls up and
  exports exactly as the reference's; ``AsyncJsonlWriter`` round-trips.
* **Inertness**: ``metrics=True`` changes no result field, for every
  vmappable policy x congestion x impairment on the dense fleet, for
  ``simulate`` and for the host policies' loop and the hierarchical fleet.
* **Rows equal the reference's**, row for row, on every path: integer
  fields exactly; on the dense fleet ``us_sum``, ``util_*`` and
  ``backlog_*`` within ``rtol=1e-5, atol=1e-6`` (the row mean's float32
  summation order, ROADMAP.md §3 "Reduction order"); ``simulate``'s rows
  exactly; the host loop's exactly but ``us_sum`` (the same row mean); the
  hierarchical fleet's exactly but ``util_gamma`` and ``backlog_gamma``
  at ``rtol=1e-5`` (the committed compute load's summation order, ROADMAP.md
  §3 "Committed-load order vs XLA").
* **Rows aggregate exactly** to the port's own ``SimResult`` /
  ``FleetResult`` totals.
"""
from __future__ import annotations

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.obs as RO  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.obs as PO  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
INT_FIELDS = ("n_arrivals", "n_served", "n_satisfied", "n_shed", "n_refused", "tier_hist",
              "qos_sat", "qos_count")
FLOAT_FIELDS = ("util_gamma", "util_eta", "backlog_gamma", "backlog_eta", "us_sum")
VMAPPABLE = [p for p in P.list_policies() if P.get_policy(p).vmappable]
SPEC = P.demo_cluster_spec()


def cfgs(congestion=False, impaired=False, **kw):
    """The reference's telemetry-test config (admission on), for both
    packages; congestion at a half drain, so the backlog rows move."""
    out = []
    for M in (R, P):
        imp = M.ImpairmentConfig()
        if impaired:
            imp = M.ImpairmentConfig(
                enabled=True, link_profiles=(M.IntermittentLink(),), seed=3,
                outage_mtbf_frames=6.0, outage_mttr_frames=3.0, outage_servers=(1,))
        base = dict(horizon_ms=4000.0, arrival_rate_per_s=4.0, delay_req_ms=3000.0,
                    acc_req_mean=50.0, acc_req_std=10.0,
                    congestion=M.CongestionConfig(enabled=congestion, drain=0.5),
                    admission=M.AdmissionConfig(enabled=True, shed=True, queue_cap_mult=2.0),
                    impairments=imp)
        base.update(kw)
        out.append(M.SimConfig(**base))
    return out


def ref_fleet(rcfg, **kw):
    opts = dict(metrics=True)
    for k in ("scheduler", "streaming", "window", "rng_mode"):
        if k in kw:
            opts[k] = kw.pop(k)
    return R.simulate_fleet(R.demo_cluster_spec(), rcfg, options=R.EngineOptions(**opts), **kw)


def port_fleet(pcfg, metrics=True, **kw):
    opts = dict(metrics=metrics)
    for k in ("scheduler", "streaming", "window", "rng_mode", "prefetch"):
        if k in kw:
            opts[k] = kw.pop(k)
    return P.simulate_fleet(SPEC, pcfg, device="cpu", options=P.EngineOptions(**opts), **kw)


def assert_rows(ref, got, exact=(), close=FLOAT_FIELDS):
    """Row for row: integers exact, ``exact`` floats bitwise, ``close``
    floats within TOL."""
    assert got.fleet == ref.fleet and got.n_frames == ref.n_frames
    assert got.n_edge == ref.n_edge and got.frame_ms == ref.frame_ms
    np.testing.assert_array_equal(got.t_ms, ref.t_ms)
    for f in INT_FIELDS + FLOAT_FIELDS:
        a, b = ref.data[f], got.data[f]
        assert b.dtype == a.dtype and b.shape == a.shape, f
        if f in INT_FIELDS or f in exact:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert f in close, f
            np.testing.assert_allclose(b, a, err_msg=f, **TOL)


def assert_fleet_totals(fr):
    """The rows aggregate exactly to the fleet's own integer totals."""
    m = fr.metrics
    agg = m.aggregate()
    assert m.fleet and m.n_rep == fr.n_rep and m.n_frames == fr.n_frames
    assert agg["n_arrivals"] == fr.n_requests and agg["n_served"] == fr.n_served
    reqs = m.data["n_arrivals"].sum(1)
    np.testing.assert_array_equal(
        100.0 * m.data["n_satisfied"].sum(1) / np.maximum(reqs, 1), fr.satisfied_per_rep)
    np.testing.assert_allclose(m.data["us_sum"].sum(1, dtype=np.float64) / np.maximum(reqs, 1),
                               fr.mean_us_per_rep, rtol=1e-5, atol=1e-6)
    d = m.data
    assert np.all(d["tier_hist"].sum(-1) == d["n_served"])
    assert np.all(d["qos_count"].sum(-1) == d["n_arrivals"])
    assert np.all(d["n_shed"] <= d["n_arrivals"]) and np.all(d["qos_sat"] <= d["qos_count"])
    for f in ("util_gamma", "util_eta", "backlog_gamma", "backlog_eta"):
        assert np.all(np.isfinite(d[f])) and np.all(d[f] >= 0.0)


def assert_fleet_equal(a, b):
    assert a.n_requests == b.n_requests and a.n_served == b.n_served
    np.testing.assert_array_equal(a.satisfied_per_rep, b.satisfied_per_rep)
    np.testing.assert_array_equal(a.mean_us_per_rep, b.mean_us_per_rep)
    assert a.mean_compute_inflation == b.mean_compute_inflation
    if a.final_backlog_per_rep is None:
        assert b.final_backlog_per_rep is None
    else:
        np.testing.assert_array_equal(a.final_backlog_per_rep, b.final_backlog_per_rep)


# ---------------------------------------------------------------------------
# MetricsResult and the exporter
# ---------------------------------------------------------------------------


def _stacked(M, lead, n_servers=5, seed=0):
    rng = np.random.default_rng(seed)
    nq = len(M.QOS_ACC_EDGES) + 1
    ints = lambda *s: rng.integers(0, 9, lead + s).astype(np.int32)  # noqa: E731
    flts = lambda *s: rng.uniform(0, 2, lead + s).astype(np.float32)  # noqa: E731
    return M.MetricsFrame(
        n_arrivals=ints(), n_served=ints(), n_satisfied=ints(), n_shed=ints(),
        n_refused=ints(), tier_hist=ints(3), qos_sat=ints(nq), qos_count=ints(nq),
        util_gamma=flts(n_servers), util_eta=flts(n_servers), backlog_gamma=flts(n_servers),
        backlog_eta=flts(n_servers), us_sum=flts(),
    )


@pytest.mark.parametrize("lead", [(7,), (3, 7)], ids=["single", "fleet"])
def test_metrics_result_matches_reference(lead, tmp_path):
    t_ms = (np.arange(lead[-1]) + 1.0) * 3000.0
    ref = RO.MetricsResult.from_stacked(_stacked(RO, lead), t_ms, 4, 3000.0)
    # the port takes the same rows as torch tensors (the fleet's device leaves)
    rows = _stacked(PO, lead)
    got = PO.MetricsResult.from_stacked(
        PO.MetricsFrame(*(torch.from_numpy(x) for x in rows)), t_ms, 4, 3000.0)
    assert (got.fleet, got.n_rep, got.n_frames, got.n_servers) == (
        ref.fleet, ref.n_rep, ref.n_frames, ref.n_servers)
    assert got.aggregate() == ref.aggregate()
    for f in ("backlog_gamma", "us_sum", "n_served"):
        assert got.percentiles(f) == ref.percentiles(f)
        np.testing.assert_array_equal(got.series(f, rep=0), ref.series(f, rep=0))
    assert got.per_edge_rollup() == ref.per_edge_rollup()
    assert list(got.iter_rows()) == list(ref.iter_rows())
    n_got = got.to_jsonl(tmp_path / "p.jsonl")
    n_ref = ref.to_jsonl(tmp_path / "r.jsonl")
    assert n_got == n_ref == ref.n_rep * ref.n_frames
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "r.jsonl").read_text()
    # from_rows (simulate's per-decision rows) agrees with from_stacked
    one = _stacked(PO, (5,))
    rows_list = [PO.MetricsFrame(*(x[i] for x in one)) for i in range(5)]
    a = PO.MetricsResult.from_rows(rows_list, t_ms[:5], 4, 3000.0)
    b = PO.MetricsResult.from_stacked(one, t_ms[:5], 4, 3000.0)
    assert a.aggregate() == b.aggregate()


def test_async_jsonl_writer_round_trips(tmp_path):
    path = tmp_path / "w.jsonl"
    with PO.recording() as rec:
        with PO.AsyncJsonlWriter(path, batch=8) as w:
            for i in range(100):
                w.write({"i": i})
    assert w.n_written == 100
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["i"] for r in rows] == list(range(100))
    io = [e for e in rec.events() if e.get("cat") == "io"]
    assert io and all(e["name"] == "telemetry/jsonl_flush" for e in io)
    names = {e["tid"]: e["args"]["name"] for e in rec.to_chrome_trace()["traceEvents"]
             if e["ph"] == "M"}
    assert {names[e["tid"]] for e in io} == {"telemetry-writer"}
    # the writer's exception surfaces at close()
    bad = PO.AsyncJsonlWriter(tmp_path / "bad.jsonl")
    bad.write({"x": object()})
    with pytest.raises(TypeError):
        bad.close()


# ---------------------------------------------------------------------------
# inertness: metrics on/off leaves every result field as it was
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", VMAPPABLE)
@pytest.mark.parametrize("congestion", [False, True])
@pytest.mark.parametrize("impaired", [False, True])
def test_fleet_metrics_bitwise_inert(policy, congestion, impaired):
    _, pcfg = cfgs(congestion, impaired)
    off = port_fleet(pcfg, metrics=False, policy=policy, n_rep=2, seed=7)
    on = port_fleet(pcfg, policy=policy, n_rep=2, seed=7)
    assert_fleet_equal(off, on)
    assert off.metrics is None and on.metrics is not None
    assert_fleet_totals(on)


@pytest.mark.parametrize("congestion", [False, True])
def test_simulate_metrics_inert_and_rows_match_reference(congestion):
    rcfg, pcfg = cfgs(congestion)
    off = P.simulate(SPEC, pcfg, seed=5, device="cpu")
    on = P.simulate(SPEC, pcfg, seed=5, device="cpu", options=P.EngineOptions(metrics=True))
    assert off.as_dict() == on.as_dict() and off.metrics is None
    assert off.bandwidth_estimates == on.bandwidth_estimates
    assert off.resilience_stats == on.resilience_stats
    assert "metrics" not in on.as_dict()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = R.simulate(R.demo_cluster_spec(), rcfg, seed=5, metrics=True)
    assert_rows(ref.metrics, on.metrics, exact=FLOAT_FIELDS)
    m = on.metrics
    assert not m.fleet and np.all(np.diff(m.t_ms) > 0)
    agg = m.aggregate()
    for k, v in (("n_arrivals", on.n_requests), ("n_served", on.n_served),
                 ("n_satisfied", on.n_satisfied), ("n_local", on.n_local),
                 ("n_cloud", on.n_cloud), ("n_edge_offload", on.n_edge_offload)):
        assert agg[k] == v, k
    assert agg["n_shed"] == on.resilience_stats["n_shed"]
    assert agg["n_refused"] == on.resilience_stats["n_refused"]


def test_host_fleet_metrics_inert_and_rows_match_reference():
    # low rate: the exact ILP refuses frames above its variable budget
    rcfg, pcfg = cfgs(congestion=True, arrival_rate_per_s=1.0)
    off = port_fleet(pcfg, metrics=False, policy="ilp", n_rep=2, seed=1)
    on = port_fleet(pcfg, policy="ilp", n_rep=2, seed=1)
    assert_fleet_equal(off, on)
    assert_fleet_totals(on)
    ref = ref_fleet(rcfg, policy="ilp", n_rep=2, seed=1)
    assert_rows(ref.metrics, on.metrics, exact=FLOAT_FIELDS[:-1], close=("us_sum",))


# ---------------------------------------------------------------------------
# rows against the reference: the dense and hierarchical fleets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["gus", "random", "gus-adaptive", "happy_computation"])
@pytest.mark.parametrize("congestion,impaired", [(False, False), (True, False), (True, True)])
def test_dense_rows_match_reference(policy, congestion, impaired):
    rcfg, pcfg = cfgs(congestion, impaired)
    ref = ref_fleet(rcfg, policy=policy, n_rep=2, seed=7)
    got = port_fleet(pcfg, policy=policy, n_rep=2, seed=7)
    assert_rows(ref.metrics, got.metrics)
    if congestion and policy == "happy_computation":  # it over-commits
        assert got.metrics.data["backlog_gamma"].max() > 0.0
    assert_fleet_totals(got)


@pytest.mark.parametrize("rng_mode", ["paper-default", "vectorized"])
def test_windowed_dense_rows_match_materialized_and_reference(rng_mode):
    rcfg, pcfg = cfgs(congestion=True, impaired=True)
    ref = ref_fleet(rcfg, n_rep=3, seed=0, rng_mode=rng_mode)
    full = port_fleet(pcfg, n_rep=3, seed=0, rng_mode=rng_mode)
    windowed = port_fleet(pcfg, n_rep=3, seed=0, rng_mode=rng_mode, window=1, prefetch=2)
    for f in PO.MetricsFrame._fields:
        np.testing.assert_array_equal(full.metrics.data[f], windowed.metrics.data[f], err_msg=f)
    assert_rows(ref.metrics, windowed.metrics)


def test_streamed_windowed_dense_rows_match_reference():
    rcfg, pcfg = cfgs(congestion=False, impaired=True, horizon_ms=9000.0)
    kw = dict(n_rep=2, seed=1, scenario="sustained-overload", window=2)
    ref = ref_fleet(rcfg, **kw)
    got = port_fleet(pcfg, **kw)
    assert got.window == 2
    assert_rows(ref.metrics, got.metrics)
    assert_fleet_totals(got)


HIER_CLOSE = ("util_gamma", "backlog_gamma")


@pytest.mark.parametrize("streamed", [False, True], ids=["materialized", "streamed"])
@pytest.mark.parametrize("congestion,impaired", [(False, False), (False, True), (True, True)])
def test_hier_rows_match_reference(streamed, congestion, impaired):
    rcfg, pcfg = cfgs(congestion, impaired)
    kw = dict(scheduler="hierarchical", n_rep=2, seed=3, scenario="flash-crowd",
              streaming=streamed, window=2 if streamed else None)
    off = port_fleet(pcfg, metrics=False, **kw)
    got = port_fleet(pcfg, **kw)
    assert_fleet_equal(off, got)
    assert_fleet_totals(got)
    ref = ref_fleet(rcfg, **kw)
    exact = tuple(f for f in FLOAT_FIELDS if f not in HIER_CLOSE)
    assert_rows(ref.metrics, got.metrics, exact=exact, close=HIER_CLOSE)
