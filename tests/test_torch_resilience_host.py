"""The port's fleet for the host policies (``ilp``, ``lp-bound``,
``gus-hier``: ``_simulate_fleet_host``) under the resilience layer, against
the JAX reference, on the CPU, held as
``tests/test_torch_resilience_fleet.py`` holds the dense fleet (integer
fields, backlogs and inflation exact, ``mean_us_per_rep`` to ``rtol=1e-5,
atol=1e-6``).  The reference schedules these frame by frame on the host,
compiling per frame shape, so the cases are few.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from test_torch_resilience_fleet import (  # noqa: E402
    CASES,
    assert_fleet_equal,
    fleets,
    full,
    protected,
    scenario_of,
)


@pytest.mark.parametrize("policy,case", [
    ("lp-bound", "links-protected"),
    ("lp-bound", "outages-cap0"),
    ("gus-hier", "composite-protected"),
    ("gus-hier", "outages-cap0"),
])
def test_host_policy_matches_reference(policy, case):
    ref, run = fleets(policy, scenario_of(case), **CASES[case])
    got = run()
    assert_fleet_equal(ref, got)
    assert got.window == got.n_frames  # every frame at once, as the reference's
    if case == "outages-cap0":
        assert got.n_served == 0


def test_ilp_matches_reference():
    """The exact oracle, on frames it can certify: links, outages and the
    protected admission, congestion at a half drain."""
    kw = dict(rate=1.0, impairments=full, admission=protected,
              congestion=lambda m: m.CongestionConfig(enabled=True, drain=0.5))
    ref, run = fleets("ilp", scenario_of("links"), **kw)
    assert_fleet_equal(ref, run())


@pytest.mark.parametrize("policy", ["lp-bound", "gus-hier"])
def test_host_loop_amplitude_zero_is_bitwise_inert(policy):
    zero = P.ImpairmentConfig(enabled=True, amplitude=0.0, seed=3,
                              link_profiles=(P.IntermittentLink(), P.SatelliteLink()))
    run = lambda **kw: P.simulate_fleet(  # noqa: E731
        P.demo_cluster_spec(), P.SimConfig(horizon_ms=9_000.0, arrival_rate_per_s=3.0, **kw),
        policy=policy, n_rep=2, seed=0, device="cpu")
    assert_fleet_equal(run(), run(impairments=zero, admission=P.AdmissionConfig(enabled=True)),
                       us_exact=True)
