"""The port's dense Monte-Carlo fleet under the resilience layer, against
the JAX reference, on the CPU (the host policies' loop is
``tests/test_torch_resilience_host.py``).

Same cluster, config and seed through ``repro.core.simulate_fleet`` and
``repro_torch.core.simulate_fleet(device="cpu")`` with impairments,
outages and admission control on, at ``tests/test_resilience.py``'s size
(``demo_cluster_spec()``, 2 replications).  As in
``tests/test_torch_fleet.py`` the integer fields, the final backlogs and
the mean inflation must be equal, and ``mean_us_per_rep`` is held to
``rtol=1e-5, atol=1e-6`` (a float32 row mean whose summation order PyTorch
and XLA choose differently).  The port's own windowed, prefetched,
streamed and vectorized runs must equal its serial run exactly, mean US
included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core.scenarios import FlashCrowdOutageScenario as RComposite  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core.scenarios import FlashCrowdOutageScenario as PComposite  # noqa: E402

US_TOL = dict(rtol=1e-5, atol=1e-6)
COMPOSITE = dict(burst_mult=3.0, burst_start_frac=0.2, burst_end_frac=0.4,
                 outage_start_frac=0.2, outage_end_frac=0.4)


def composite(mod):
    return (RComposite if mod is R else PComposite)(**COMPOSITE)


def full(mod):
    """Intermittent links and an outage stream on server 1."""
    return mod.ImpairmentConfig(enabled=True, link_profiles=(mod.IntermittentLink(),), seed=3,
                                outage_mtbf_frames=6.0, outage_mttr_frames=3.0,
                                outage_servers=(1,))


def links(mod):
    return mod.ImpairmentConfig(enabled=True, link_profiles=(mod.IntermittentLink(),
                                                              mod.SatelliteLink()), seed=3)


def protected(mod):
    return mod.AdmissionConfig(enabled=True, queue_cap_mult=1.0, shed=True)


def cfg(mod, rate=3.0, horizon_ms=12_000.0, **kw):
    """``kw`` values are callables of the package."""
    return mod.SimConfig(horizon_ms=horizon_ms, arrival_rate_per_s=rate, delay_req_ms=6000.0,
                         acc_req_mean=50.0, acc_req_std=10.0,
                         **{k: v(mod) for k, v in kw.items()})


#: rate 3 on the composite with congestion on, links and outages, and
#: protection: every mechanism at once
ACTIVE = dict(congestion=lambda m: m.CongestionConfig(enabled=True), impairments=full,
              admission=protected)


def fleets(policy="gus", scenario=composite, n_rep=2, ref_opts=None, **kw):
    ref = R.simulate_fleet(R.demo_cluster_spec(), cfg(R, **kw), policy=policy,
                           scenario=scenario(R), n_rep=n_rep, seed=0,
                           options=R.EngineOptions(**(ref_opts or {})))
    return ref, lambda **o: P.simulate_fleet(
        P.demo_cluster_spec(), cfg(P, **kw), policy=policy, scenario=scenario(P),
        n_rep=n_rep, seed=0, options=P.EngineOptions(**o), device="cpu")


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


# ---------------------------------------------------------------------------
# every policy, every mechanism
# ---------------------------------------------------------------------------

CASES = {
    # the composite with congestion on: the per-frame loop
    "composite-none": dict(rate=4.0, horizon_ms=18_000.0, congestion=ACTIVE["congestion"],
                           impairments=full),
    "composite-protected": dict(rate=4.0, horizon_ms=18_000.0, **ACTIVE),
    # congestion off: one call per window, admission at unit inflation
    "links-protected": dict(impairments=links, admission=protected),
    "outages-cap0": dict(impairments=full,
                         admission=lambda m: m.AdmissionConfig(enabled=True, queue_cap_mult=0.0)),
}


#: the policies that schedule on the host (tests/test_torch_resilience_host.py)
HOST = ("ilp", "lp-bound", "gus-hier")


def scenario_of(case):
    return composite if case.startswith("composite") else (lambda m: "paper-default")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("policy", [p for p in R.list_policies() if p not in HOST])
def test_every_policy_matches_reference(policy, case):
    ref, run = fleets(policy, scenario_of(case), **CASES[case])
    got = run(window=4)
    assert_fleet_equal(ref, got)
    if case == "outages-cap0":  # a zero cap refuses every assignment
        assert got.n_served == 0


# ---------------------------------------------------------------------------
# execution paths equal the serial run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["gus", "gus-adaptive"])
def test_windowed_prefetched_streamed_vectorized_equal_serial(policy):
    """``tests/test_resilience.py``'s parity checks on the port: windows,
    prefetch, a streamed trace and the vectorized draws equal the serial
    run exactly (the engine's values depend only on the frame)."""
    ref, run = fleets(policy, **ACTIVE)
    serial = run(prefetch=0)
    assert_fleet_equal(ref, serial)
    assert_fleet_equal(serial, run(window=4), us_exact=True)
    assert_fleet_equal(serial, run(window=4, prefetch=2), us_exact=True)
    assert_fleet_equal(run(streaming=True, window=9), run(streaming=True, window=4),
                       us_exact=True)
    vec = run(rng_mode="vectorized", prefetch=0)
    assert_fleet_equal(vec, run(rng_mode="vectorized", window=4), us_exact=True)
    ref_vec, _ = fleets(policy, ref_opts=dict(rng_mode="vectorized"), **ACTIVE)
    assert_fleet_equal(ref_vec, vec)


def test_streamed_fleet_matches_reference():
    ref, run = fleets(ref_opts=dict(streaming=True, window=4), **ACTIVE)
    assert_fleet_equal(ref, run(streaming=True, window=4))


# ---------------------------------------------------------------------------
# identities and behaviour
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["gus", "gus-adaptive", "random"])
def test_disabled_and_amplitude_zero_are_bitwise_inert(policy):
    zero = lambda m: m.ImpairmentConfig(  # noqa: E731
        enabled=True, amplitude=0.0, seed=3,
        link_profiles=(m.IntermittentLink(), m.SatelliteLink()))
    run = lambda **kw: P.simulate_fleet(  # noqa: E731
        P.demo_cluster_spec(), cfg(P, **kw), policy=policy, n_rep=2, seed=0,
        device="cpu", options=P.EngineOptions(window=2))
    base = run()
    off = run(impairments=lambda m: m.ImpairmentConfig(), admission=lambda m: m.AdmissionConfig())
    amp0 = run(impairments=zero, admission=lambda m: m.AdmissionConfig(enabled=True))
    assert_fleet_equal(base, off, us_exact=True)
    assert_fleet_equal(base, amp0, us_exact=True)


def test_impairment_weather_is_replication_prefix_stable():
    run = lambda n: P.simulate_fleet(  # noqa: E731
        P.demo_cluster_spec(), cfg(P, horizon_ms=9_000.0, impairments=full), n_rep=n, seed=0,
        device="cpu")
    one, three = run(1), run(3)
    assert one.satisfied_per_rep[0] == three.satisfied_per_rep[0]
    assert one.mean_us_per_rep[0] == three.mean_us_per_rep[0]


def test_protection_rescues_overcommitting_policy_and_leaves_gus_untouched():
    plain = dict(rate=4.0, horizon_ms=18_000.0, congestion=ACTIVE["congestion"],
                 impairments=full)
    prot = dict(plain, admission=protected)
    _, bare = fleets("happy_computation", **plain)
    _, guarded = fleets("happy_computation", **prot)
    assert guarded().satisfied_pct > bare().satisfied_pct
    _, g_bare = fleets("gus", **plain)
    _, g_prot = fleets("gus", **prot)
    assert_fleet_equal(g_bare(), g_prot(), us_exact=True)


def _counting(name):
    base = P.get_policy(name)
    calls = []

    def make(n_edge, n_servers):
        fn = base.bind(n_edge, n_servers)

        def schedule(*a):
            calls.append(a[0].A.shape[0])
            return fn(*a)

        return schedule

    return dataclasses.replace(base, name=f"{name}-counted", make=make), calls


@pytest.mark.parametrize("congestion", [False, True])
def test_one_call_per_window_while_frames_are_independent(congestion):
    """With congestion off the shed mask and the cap need no carry, so a
    stateless policy schedules each window in one call; congestion on
    takes one call per frame.  Either way the result is the reference's."""
    kw = dict(impairments=full, admission=protected)
    if congestion:
        kw["congestion"] = lambda m: m.CongestionConfig(enabled=True, drain=0.5)
    ref, _ = fleets("gus", lambda m: "paper-default", n_rep=3, **kw)
    pol, calls = _counting("gus")
    got = P.simulate_fleet(P.demo_cluster_spec(), cfg(P, **kw), policy=pol, n_rep=3, seed=0,
                           options=P.EngineOptions(window=3), device="cpu")
    assert_fleet_equal(ref, got)
    assert calls == ([3] * got.n_frames if congestion else [9, 3])
