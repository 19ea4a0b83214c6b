"""The port's Monte-Carlo fleet against the JAX reference, on the CPU.

Same cluster, config and seed through ``repro.core.simulate_fleet`` and
``repro_torch.core.simulate_fleet(device="cpu")``.  Integer results
(requests, served, satisfied per replication, final backlogs) and the mean
compute inflation must be equal.  ``mean_us_per_rep`` is held to
``rtol=1e-5, atol=1e-6``: it comes from a float32 row mean whose summation
order PyTorch and XLA choose differently.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import impairments as PI  # noqa: E402

US_TOL = dict(rtol=1e-5, atol=1e-6)
BASE = dict(horizon_ms=15_000.0, arrival_rate_per_s=4.0, delay_req_ms=6000.0,
            acc_req_mean=50.0, acc_req_std=10.0)
#: congestion off; on at the defaults (GUS honours its budgets, so the
#: backlog stays zero); on with drain=0.5, where half of each frame's work
#: is carried over and feeds the next frame's budgets
CONGESTION = {"off": {}, "on": dict(enabled=True), "drain": dict(enabled=True, drain=0.5)}
PORTED_SCENARIOS = ("paper-default", "diurnal", "flash-crowd", "mobility",
                    "hetero-tiers", "outage", "flash-crowd-outage")


def configs(congestion="off", **kw):
    c = CONGESTION[congestion]
    kw = {**BASE, **kw}
    return (
        R.SimConfig(**kw, congestion=R.CongestionConfig(**c)),
        P.SimConfig(**kw, congestion=P.CongestionConfig(**c)),
    )


def assert_fleet_equal(ref, got, us_exact=False):
    assert got.n_rep == ref.n_rep and got.n_frames == ref.n_frames
    assert got.n_requests == ref.n_requests
    assert got.n_served == ref.n_served
    np.testing.assert_array_equal(got.satisfied_per_rep, ref.satisfied_per_rep)
    assert got.mean_compute_inflation == ref.mean_compute_inflation
    if ref.final_backlog_per_rep is None:
        assert got.final_backlog_per_rep is None
    else:
        np.testing.assert_array_equal(got.final_backlog_per_rep, ref.final_backlog_per_rep)
    if us_exact:
        np.testing.assert_array_equal(got.mean_us_per_rep, ref.mean_us_per_rep)
    else:
        np.testing.assert_allclose(got.mean_us_per_rep, ref.mean_us_per_rep, **US_TOL)


def fleets(scenario, rng_mode, congestion="off", n_rep=3, window=None, prefetch=1, **kw):
    spec = R.demo_cluster_spec()
    rcfg, pcfg = configs(congestion, **kw)
    ref = R.simulate_fleet(
        spec, rcfg, policy="gus", scenario=scenario, n_rep=n_rep, seed=0,
        options=R.EngineOptions(rng_mode=rng_mode),
    )
    got = P.simulate_fleet(
        spec, pcfg, scenario=scenario, n_rep=n_rep, seed=0,
        options=P.EngineOptions(rng_mode=rng_mode, window=window, prefetch=prefetch),
        device="cpu",
    )
    return ref, got


@pytest.mark.parametrize("congestion", ["off", "drain"])
@pytest.mark.parametrize("rng_mode", ["paper-default", "vectorized"])
@pytest.mark.parametrize("scenario", ["paper-default", "flash-crowd"])
def test_fleet_matches_reference(scenario, rng_mode, congestion):
    ref, got = fleets(scenario, rng_mode, congestion)
    assert_fleet_equal(ref, got)
    assert got.device == "cpu" and got.n_devices == 1
    if congestion == "drain":  # the carry really moved the budgets
        assert ref.final_backlog_per_rep.sum() > 0


def test_default_congestion_keeps_gus_backlog_at_zero():
    """At the default drain of 1.0 GUS never commits more than its budget,
    so the backlog stays exactly zero and the results equal congestion off."""
    ref, got = fleets("flash-crowd", "vectorized", "on")
    assert_fleet_equal(ref, got)
    assert not got.final_backlog_per_rep.any()
    _, off = fleets("flash-crowd", "vectorized", "off")
    np.testing.assert_array_equal(got.satisfied_per_rep, off.satisfied_per_rep)


@pytest.mark.parametrize("scenario", ["diurnal", "mobility", "hetero-tiers",
                                      "outage", "flash-crowd-outage"])
def test_fleet_other_scenarios_match_reference(scenario):
    ref, got = fleets(scenario, "vectorized", "drain", arrival_rate_per_s=6.0)
    assert_fleet_equal(ref, got)


def test_windowed_fleet_matches_reference():
    ref, got = fleets("flash-crowd", "vectorized", "drain", window=2)
    assert_fleet_equal(ref, got)
    assert got.window == 2


@pytest.mark.parametrize("window,prefetch", [(None, 0), (2, 0), (2, 1), (1, 2)])
def test_window_and_prefetch_equal_materialized_serial(window, prefetch):
    """Windowed and prefetched runs equal the materialized serial run
    exactly, mean US included (same device, same operations)."""
    spec = P.demo_cluster_spec()
    _, cfg = configs("drain")
    run = lambda **o: P.simulate_fleet(  # noqa: E731
        spec, cfg, scenario="flash-crowd", n_rep=3, seed=1, device="cpu",
        options=P.EngineOptions(rng_mode="vectorized", **o),
    )
    base = run(prefetch=0)
    got = run(window=window, prefetch=prefetch)
    assert_fleet_equal(base, got, us_exact=True)
    assert got.prefetch == prefetch
    assert set(got.timings) >= {"fleet/generate_traces", "fleet/dispatch", "total_s"}


@pytest.mark.parametrize("rng_mode", ["paper-default", "vectorized"])
@pytest.mark.parametrize("scenario", PORTED_SCENARIOS)
def test_arrival_traces_match_reference(scenario, rng_mode):
    """The same seed draws the reference's trace, field for field, and the
    same capacity stream."""
    rcfg, pcfg = configs(arrival_rate_per_s=5.0)
    ref = R.get_scenario(scenario).generate_arrivals(
        np.random.default_rng(4), 4, 3, rcfg, rng_mode=rng_mode
    )
    got = P.get_scenario(scenario).generate_arrivals(
        np.random.default_rng(4), 4, 3, pcfg, rng_mode=rng_mode
    )
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in ref]
    starts = np.arange(5) * pcfg.frame_ms
    ref_scale = R.get_scenario(scenario).capacity_scale_batch(starts, rcfg, 4, 5)
    got_scale = P.get_scenario(scenario).capacity_scale_batch(starts, pcfg, 4, 5)
    if ref_scale is None:
        assert got_scale is None
    else:
        np.testing.assert_array_equal(got_scale, ref_scale)


def test_scenario_registry_is_the_non_streaming_set():
    """The port registers the reference's whole registry: the non-streaming
    scenarios of the first slice plus the streaming ones."""
    streaming = {n for n in R.list_scenarios() if R.get_scenario(n).streaming}
    assert set(P.list_scenarios()) == set(R.list_scenarios())
    assert set(P.list_scenarios()) - streaming == set(PORTED_SCENARIOS)
    assert all(P.get_scenario(n).streaming for n in streaming)


def test_demo_cluster_spec_matches_reference():
    for kw in ({}, dict(n_edge=9, n_cloud=1, n_services=5, n_variants=10)):
        ref, got = R.demo_cluster_spec(**kw), P.demo_cluster_spec(**kw)
        for f in ("gamma_frame", "eta_frame", "proc_ms", "placed", "acc"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("case,item", [
    ("devices", "item 9"), ("metrics", "item 5"), ("impairments", "item 3"),
    ("admission", "item 3"), ("hier-admission", "item 3"),
    ("hier-impairments", "item 3"), ("hier-metrics", "item 5"), ("hier-devices", "item 9"),
])
def test_unported_options_raise(case, item):
    """What this slice does not run raises NotImplementedError naming its
    ROADMAP item, instead of running something else — on the dense and on
    the hierarchical layout."""
    spec = P.demo_cluster_spec()
    cfg = P.SimConfig(**BASE)
    hier = case.startswith("hier-")
    what = case.removeprefix("hier-")
    opts = dict(scheduler="hierarchical") if hier else {}
    if what == "devices":
        opts["devices"] = 2
    elif what == "metrics":
        opts["metrics"] = True
    elif what == "impairments":
        cfg = dataclasses.replace(cfg, impairments=PI.ImpairmentConfig(enabled=True))
    else:
        cfg = dataclasses.replace(cfg, admission=PI.AdmissionConfig(enabled=True))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 {item}"):
        P.simulate_fleet(spec, cfg, n_rep=2, options=P.EngineOptions(**opts), device="cpu")


def test_unknown_policy_and_backend_errors():
    spec = P.demo_cluster_spec()
    cfg = P.SimConfig(**BASE)
    with pytest.raises(KeyError, match="unknown policy 'no-such-policy'"):
        P.simulate_fleet(spec, cfg, policy="no-such-policy", n_rep=2, device="cpu")
    with pytest.raises(ValueError, match="does not take it"):
        P.simulate_fleet(spec, cfg, policy="random", n_rep=2, device="cpu",
                         options=P.EngineOptions(backend="torch"))
    with pytest.raises(ValueError, match="unknown GUS backend"):
        P.simulate_fleet(spec, cfg, n_rep=2, device="cpu",
                         options=P.EngineOptions(backend="pallas"))
