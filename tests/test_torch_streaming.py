"""The port's streaming arrival engine against the JAX reference, on the CPU.

* ``ArrivalStream`` (drained frame by frame), ``stream_trace`` and
  ``stream_trace_columns`` draw the reference's traces bit for bit on the
  three streaming scenarios in both rng modes; chunked draining equals the
  one-shot drain; ``max_frame_arrivals`` is equal.
* The dense fleet on the streaming scenarios, lazy (``window < T``: arrivals
  drawn a window at a time after the count-only pre-pass) and materialized,
  equals the JAX fleet: integer fields exact, ``mean_us_per_rep`` to the
  fleet tests' float32-row-mean tolerance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.streaming as RS  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.core.streaming as PS  # noqa: E402

US_TOL = dict(rtol=1e-5, atol=1e-6)
STREAMING = ("sustained-overload", "diurnal-week", "mega-city")
MODES = ("paper-default", "vectorized")
BASE = dict(horizon_ms=15_000.0, arrival_rate_per_s=4.0, delay_req_ms=6000.0,
            acc_req_mean=50.0, acc_req_std=10.0)


def scenarios(name):
    """The named scenario in both packages; mega-city's rate cut to ~100
    arrivals per frame on 4 edges."""
    r, p = R.get_scenario(name), P.get_scenario(name)
    if name == "mega-city":
        r = dataclasses.replace(r, rate_per_edge_per_s=8.0)
        p = dataclasses.replace(p, rate_per_edge_per_s=8.0)
    return r, p


def rows(reqs):
    return [dataclasses.astuple(r) for r in reqs]


def columns(c):
    return [c.arrival_ms, c.cover, c.service, c.A, c.C, c.size_bytes]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", STREAMING)
def test_stream_traces_match_reference(name, mode):
    rs, ps = scenarios(name)
    rcfg, pcfg = R.SimConfig(**BASE), P.SimConfig(**BASE)
    ref = RS.stream_trace(rs, 3, 4, 3, rcfg, rng_mode=mode)
    got = PS.stream_trace(ps, 3, 4, 3, pcfg, rng_mode=mode)
    assert len(ref) > 50 and rows(got) == rows(ref)
    # frame-by-frame draining (an uneven chunk) equals the one-shot drain
    stream = PS.ArrivalStream(ps, 3, 4, 3, pcfg, rng_mode=mode)
    chunked = []
    for t in np.arange(1, 12) * 1700.0:
        chunked += stream.take_until(t)
    assert stream.exhausted and rows(chunked) == rows(got)
    assert PS.max_frame_arrivals(ps, 3, 4, 3, pcfg, 5, rng_mode=mode) == RS.max_frame_arrivals(
        rs, 3, 4, 3, rcfg, 5, rng_mode=mode
    )
    if mode == "vectorized":
        ref_c = RS.stream_trace_columns(rs, 3, 4, 3, rcfg)
        got_c = PS.stream_trace_columns(ps, 3, 4, 3, pcfg)
        for g, r in zip(columns(got_c), columns(ref_c)):
            np.testing.assert_array_equal(g, r)
        assert rows(got_c.to_requests()) == rows(got)


def test_streaming_scenarios_match_reference_rates_and_qos():
    cfg_r, cfg_p = R.SimConfig(**BASE), P.SimConfig(**BASE)
    t = np.linspace(0.0, BASE["horizon_ms"], 41)
    for name in STREAMING:
        rs, ps = scenarios(name)
        assert ps.streaming and ps.rng_mode == rs.rng_mode
        for e in range(3):
            assert ps.rate_bound(e, cfg_p) == rs.rate_bound(e, cfg_r)
            np.testing.assert_array_equal(ps.rate_batch(e, t, cfg_p), rs.rate_batch(e, t, cfg_r))
            assert [ps.rate(e, x, cfg_p) for x in t] == [rs.rate(e, x, cfg_r) for x in t]
        qr = rs.draw_qos_batch(np.random.default_rng(1), cfg_r, 64)
        qp = ps.draw_qos_batch(np.random.default_rng(1), cfg_p, 64)
        for g, r in zip(qp, qr):
            np.testing.assert_array_equal(g, r)


def fleets(scenario, rng_mode, window, congestion=True, prefetch=1):
    c = dict(enabled=True, drain=0.5) if congestion else {}
    ref = R.simulate_fleet(
        R.demo_cluster_spec(), R.SimConfig(**BASE, congestion=R.CongestionConfig(**c)),
        policy="gus", scenario=scenario, n_rep=3, seed=0,
        options=R.EngineOptions(rng_mode=rng_mode, window=window),
    )
    got = P.simulate_fleet(
        P.demo_cluster_spec(), P.SimConfig(**BASE, congestion=P.CongestionConfig(**c)),
        scenario=scenario, n_rep=3, seed=0, device="cpu",
        options=P.EngineOptions(rng_mode=rng_mode, window=window, prefetch=prefetch),
    )
    return ref, got


@pytest.mark.parametrize("scenario,rng_mode,window", [
    ("sustained-overload", "vectorized", None),
    ("sustained-overload", "vectorized", 2),
    ("diurnal-week", "paper-default", 3),
])
def test_dense_streaming_fleet_matches_reference(scenario, rng_mode, window):
    ref, got = fleets(scenario, rng_mode, window)
    assert got.n_requests == ref.n_requests and got.n_served == ref.n_served
    np.testing.assert_array_equal(got.satisfied_per_rep, ref.satisfied_per_rep)
    np.testing.assert_array_equal(got.final_backlog_per_rep, ref.final_backlog_per_rep)
    assert got.mean_compute_inflation == ref.mean_compute_inflation
    np.testing.assert_allclose(got.mean_us_per_rep, ref.mean_us_per_rep, **US_TOL)
    assert ref.final_backlog_per_rep.sum() > 0


def test_lazy_stream_equals_materialized():
    """A stream drawn a window at a time (lazy) gives the materialized
    stream's results exactly, mean US included."""
    spec = P.demo_cluster_spec()
    cfg = P.SimConfig(**BASE, congestion=P.CongestionConfig(enabled=True, drain=0.5))
    run = lambda **o: P.simulate_fleet(  # noqa: E731
        spec, cfg, scenario="sustained-overload", n_rep=2, seed=5, device="cpu",
        options=P.EngineOptions(rng_mode="vectorized", **o),
    )
    base, got = run(prefetch=0), run(window=1, prefetch=2)
    assert (got.n_requests, got.n_served) == (base.n_requests, base.n_served)
    np.testing.assert_array_equal(got.satisfied_per_rep, base.satisfied_per_rep)
    np.testing.assert_array_equal(got.mean_us_per_rep, base.mean_us_per_rep)
    np.testing.assert_array_equal(got.final_backlog_per_rep, base.final_backlog_per_rep)
    # streaming=False on a streaming scenario materializes from the rep's own rng
    off = run(streaming=False)
    assert off.n_requests != base.n_requests
