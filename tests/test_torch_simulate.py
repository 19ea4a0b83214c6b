"""The port's sequential testbed ``simulate`` and its every-policy fleet
against the JAX reference, on the CPU.

Same cluster, config, scenario and seed through ``repro.core.simulate`` and
``repro_torch.core.simulate(device="cpu")``.  ``SimResult.as_dict()``,
``bandwidth_estimates`` and ``congestion_stats`` must be equal — exactly,
floats included: the port keeps the reference's host accounting in numpy
float64 op for op and casts to float32 where the reference's x32 arrays
do.  The fleet's ``FleetResult`` is held as in ``tests/test_torch_fleet.py``
(integer fields exact, ``mean_us_per_rep`` to ``rtol=1e-5, atol=1e-6``: a
float32 row mean whose summation order PyTorch and XLA choose
differently).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core.scenarios import get_scenario as r_get_scenario  # noqa: E402

import repro_torch.core as P  # noqa: E402

US_TOL = dict(rtol=1e-5, atol=1e-6)
BASE = dict(horizon_ms=12_000.0, arrival_rate_per_s=2.0, delay_req_ms=6000.0,
            acc_req_mean=50.0, acc_req_std=10.0)
DENSE = tuple(s for s in R.list_scenarios() if r_get_scenario(s).dense_sweep)
CONGESTION = {"off": {}, "drain": dict(enabled=True, drain=0.5)}


def spec():
    return R.demo_cluster_spec(n_edge=3, n_cloud=1)


def configs(congestion="off", **kw):
    c = CONGESTION[congestion]
    kw = {**BASE, **kw}
    return (R.SimConfig(**kw, congestion=R.CongestionConfig(**c)),
            P.SimConfig(**kw, congestion=P.CongestionConfig(**c)))


def both(policy="gus", scenario="paper-default", congestion="off", seed=0, n_requests=None,
         streaming=None, rng_mode=None, s=None, **kw):
    rc, pc = configs(congestion, **kw)
    s = spec() if s is None else s
    ref = R.simulate(s, rc, policy=policy, scenario=scenario, seed=seed, n_requests=n_requests,
                     options=R.EngineOptions(streaming=streaming, rng_mode=rng_mode))
    got = P.simulate(s, pc, policy=policy, scenario=scenario, seed=seed, n_requests=n_requests,
                     options=P.EngineOptions(streaming=streaming, rng_mode=rng_mode),
                     device="cpu")
    return ref, got


def assert_sim_equal(ref, got):
    assert got.as_dict() == ref.as_dict()
    assert got.bandwidth_estimates == ref.bandwidth_estimates
    assert got.congestion_stats == ref.congestion_stats
    for f in ("n_requests", "n_served", "n_satisfied", "n_local", "n_cloud",
              "n_edge_offload", "n_dropped"):
        assert getattr(got, f) == getattr(ref, f), f
    assert set(got.timings) == set(ref.timings)


@pytest.mark.parametrize("scenario", DENSE)
@pytest.mark.parametrize("policy", R.list_policies())
def test_every_policy_on_every_dense_scenario(policy, scenario):
    ref, got = both(policy, scenario)
    assert_sim_equal(ref, got)
    assert got.n_requests > 0


@pytest.mark.parametrize("policy", ["gus", "gus-adaptive", "happy_computation", "random",
                                    "gus-ordered", "ilp"])
@pytest.mark.parametrize("scenario", ["paper-default", "sustained-overload"])
def test_congestion_with_half_drain(policy, scenario):
    ref, got = both(policy, scenario, "drain")
    assert_sim_equal(ref, got)
    assert got.congestion_stats is not None


def test_congestion_inflates_where_the_budget_is_relaxed():
    """Happy-computation over-commits compute, so the inflation formulas
    run on loads over the budget (the float32 ``over ** power`` path)."""
    ref, got = both("happy_computation", "sustained-overload", "drain")
    assert_sim_equal(ref, got)
    assert got.congestion_stats["mean_compute_inflation"] > 1.0
    assert got.congestion_stats["final_backlog_gamma"] > 0.0


@pytest.mark.parametrize("n_requests", [1, 25, 60])
@pytest.mark.parametrize("streaming", [False, True])
def test_n_requests_and_streaming(streaming, n_requests):
    ref, got = both("gus", "flash-crowd", n_requests=n_requests, streaming=streaming)
    assert_sim_equal(ref, got)
    assert got.n_requests == n_requests


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("rng_mode", ["paper-default", "vectorized"])
@pytest.mark.parametrize("policy", ["gus", "random"])
def test_rng_modes(policy, rng_mode, streaming):
    ref, got = both(policy, "diurnal", rng_mode=rng_mode, streaming=streaming, seed=3)
    assert_sim_equal(ref, got)


@pytest.mark.parametrize("move_prob", [0.3, 1.0])
def test_mobility(move_prob):
    ref, got = both("gus-ordered", "paper-default", move_prob=move_prob, seed=2)
    assert_sim_equal(ref, got)


def _counting(policy_mod, name):
    """The named policy wrapped to count its decisions."""
    base = policy_mod.get_policy(name)
    calls = []

    def make(n_edge, n_servers):
        fn = base.bind(n_edge, n_servers)

        def schedule(*a):
            calls.append(1)
            return fn(*a)

        return schedule

    return dataclasses.replace(base, name=f"{name}-counted", make=make), calls


def test_queue_full_decisions_fire_early():
    """A 10x overload with a queue cap of 2: decisions fire many times per
    wall-clock frame (the queue-full rule), sharing the frame's budget."""
    rc, pc = configs(arrival_rate_per_s=10.0, queue_cap=2)
    rpol, rcalls = _counting(R, "gus")
    ppol, pcalls = _counting(P, "gus")
    ref = R.simulate(spec(), rc, policy=rpol, seed=0)
    got = P.simulate(spec(), pc, policy=ppol, seed=0, device="cpu")
    assert_sim_equal(ref, got)
    frames = int(np.ceil(rc.horizon_ms / rc.frame_ms)) + 10
    assert len(pcalls) == len(rcalls) > frames


def test_hierarchical_option_maps_to_gus_hier():
    rc, pc = configs()
    ref = R.simulate(spec(), rc, policy="gus", options=R.EngineOptions(scheduler="hierarchical"))
    got = P.simulate(spec(), pc, policy="gus", options=P.EngineOptions(scheduler="hierarchical"),
                     device="cpu")
    assert_sim_equal(ref, got)
    with pytest.raises(ValueError, match="does not compose"):
        P.simulate(spec(), pc, policy="random", device="cpu",
                   options=P.EngineOptions(scheduler="hierarchical"))
    with pytest.raises(ValueError, match="host-side"):
        P.simulate(spec(), pc, device="cpu",
                   options=P.EngineOptions(scheduler="hierarchical", backend="torch"))
    with pytest.raises(ValueError, match="does not take it"):
        P.simulate(spec(), pc, policy="random", device="cpu",
                   options=P.EngineOptions(backend="torch"))


def test_unported_options_raise():
    _, pc = configs()
    # fleet-only options are ignored, as in the reference
    got = P.simulate(spec(), pc, options=P.EngineOptions(devices=2, window=3), device="cpu")
    assert got.n_requests > 0


# ---------------------------------------------------------------------------
# every policy through the fleet
# ---------------------------------------------------------------------------

FLEET_BASE = dict(horizon_ms=15_000.0, arrival_rate_per_s=3.0, delay_req_ms=6000.0,
                  acc_req_mean=50.0, acc_req_std=10.0)


def assert_fleet_equal(ref, got):
    assert got.n_rep == ref.n_rep and got.n_frames == ref.n_frames
    assert got.n_requests == ref.n_requests
    assert got.n_served == ref.n_served
    np.testing.assert_array_equal(got.satisfied_per_rep, ref.satisfied_per_rep)
    assert got.mean_compute_inflation == ref.mean_compute_inflation
    if ref.final_backlog_per_rep is None:
        assert got.final_backlog_per_rep is None
    else:
        np.testing.assert_array_equal(got.final_backlog_per_rep, ref.final_backlog_per_rep)
    np.testing.assert_allclose(got.mean_us_per_rep, ref.mean_us_per_rep, **US_TOL)


@pytest.mark.parametrize("congestion", ["off", "drain"])
@pytest.mark.parametrize("policy", R.list_policies())
def test_fleet_every_policy(policy, congestion):
    c = CONGESTION[congestion]
    kw = dict(FLEET_BASE)
    scenario = "flash-crowd"
    s = R.demo_cluster_spec()
    if policy == "ilp":
        # the B&B refuses the crowd's frames in both packages ...
        rc = R.SimConfig(**kw, congestion=R.CongestionConfig(**c))
        pc = P.SimConfig(**kw, congestion=P.CongestionConfig(**c))
        with pytest.raises(ValueError, match="refuses"):
            R.simulate_fleet(s, rc, policy=policy, scenario=scenario, n_rep=1)
        with pytest.raises(ValueError, match="refuses"):
            P.simulate_fleet(s, pc, policy=policy, scenario=scenario, n_rep=1, device="cpu")
        # ... and schedules frames it can certify
        kw["arrival_rate_per_s"] = 1.0
        scenario = "paper-default"
    rc = R.SimConfig(**kw, congestion=R.CongestionConfig(**c))
    pc = P.SimConfig(**kw, congestion=P.CongestionConfig(**c))
    ref = R.simulate_fleet(s, rc, policy=policy, scenario=scenario, n_rep=3, seed=1)
    got = P.simulate_fleet(s, pc, policy=policy, scenario=scenario, n_rep=3, seed=1,
                           options=P.EngineOptions(window=2), device="cpu")
    assert_fleet_equal(ref, got)
    if P.get_policy(policy).vmappable:
        assert got.window == 2
    else:  # the host loop takes every frame at once, as the reference's
        assert got.window == got.n_frames


def test_fleet_random_keys_differ_by_replication_and_seed():
    """The keyed fleet draws one key per (replication, frame): replications
    differ, and a seed change moves the draws."""
    rc, pc = configs(horizon_ms=15_000.0, arrival_rate_per_s=4.0)
    s = R.demo_cluster_spec()
    for seed in (0, 5):
        ref = R.simulate_fleet(s, rc, policy="random", n_rep=4, seed=seed)
        got = P.simulate_fleet(s, pc, policy="random", n_rep=4, seed=seed, device="cpu")
        assert_fleet_equal(ref, got)
