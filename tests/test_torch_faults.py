"""Two faults of the port against the JAX reference, on the CPU.

F1, the host inflation's power.  The reference runs its sequential
testbed and its host-policy fleet loop op by op, and eager XLA's
``pow(x, 2.0)`` is the C library's ``powf``, which is not always the
correctly rounded square; its jitted fleets fold the power into a square.
The port takes ``powf`` (``eager=True``) on those host paths only.  The
case below is the trace where the square first differed: a
``happy_communication`` run at half drain, where the over-committing
policy drives ``over > 0``.

F2, the third positional ``scheduler`` of ``simulate`` and
``simulate_fleet``: a raw ``FlatInstance -> Assignment`` callable, or a
policy name or ``Policy``, with the reference's two refusals.  The
reference's fleet calls a raw callable inside its jitted scan, which
cannot trace the NumPy oracle ``gus_schedule_np``; there the port's
oracle is held against the reference's jitted ``gus_schedule``, which the
reference's own tests hold equal to it (``tests/test_scenarios.py``).

F5, the materialized fleet's arrivals.  The reference's replication source
draws a non-streamed trace with ``generate_arrivals`` and no ``rng_mode``,
which defers to the scenario's own mode; so an explicit
``rng_mode="paper-default"`` on a scenario whose mode is ``"vectorized"``
(``mega-city``) still draws the scenario's way.  The port passed the mode
on and drew another trace (1 058 requests against 1 026 at the settings
below).  Both fleets, with and without a window, at the tolerances of
``tests/test_torch_fleet.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core.queueing import libm_pow  # noqa: E402

US_TOL = dict(rtol=1e-5, atol=1e-6)
F1_CFG = dict(horizon_ms=12_000.0, arrival_rate_per_s=6.0, delay_req_ms=4000.0,
              acc_req_mean=55.0, acc_req_std=12.0)


def spec():
    return R.demo_cluster_spec(n_edge=2, n_cloud=1)


def configs(congestion=True, shed=False, **kw):
    kw = {**F1_CFG, **kw}
    cc = dict(enabled=True, drain=0.5) if congestion else {}
    ac = dict(enabled=True, shed=True) if shed else {}
    return (
        R.SimConfig(**kw, congestion=R.CongestionConfig(**cc),
                    admission=R.AdmissionConfig(**ac)),
        P.SimConfig(**kw, congestion=P.CongestionConfig(**cc),
                    admission=P.AdmissionConfig(**ac)),
    )


def assert_sim_equal(ref, got):
    assert got.as_dict() == ref.as_dict()
    assert got.bandwidth_estimates == ref.bandwidth_estimates
    assert got.congestion_stats == ref.congestion_stats
    assert got.resilience_stats == ref.resilience_stats


def assert_fleet_equal(ref, got):
    assert (got.n_rep, got.n_frames, got.n_requests, got.n_served) == (
        ref.n_rep, ref.n_frames, ref.n_requests, ref.n_served)
    np.testing.assert_array_equal(got.satisfied_per_rep, ref.satisfied_per_rep)
    assert got.mean_compute_inflation == ref.mean_compute_inflation
    if ref.final_backlog_per_rep is None:
        assert got.final_backlog_per_rep is None
    else:
        np.testing.assert_array_equal(got.final_backlog_per_rep, ref.final_backlog_per_rep)
    np.testing.assert_allclose(got.mean_us_per_rep, ref.mean_us_per_rep, **US_TOL)


# ---------------------------------------------------------------------- F1


@pytest.mark.parametrize("shed", [False, True], ids=["bare", "shed"])
@pytest.mark.parametrize("scenario", ["paper-default", "outage"])
def test_f1_happy_communication_at_half_drain(scenario, shed):
    rc, pc = configs(shed=shed)
    ref = R.simulate(spec(), rc, policy="happy_communication", scenario=scenario, seed=1)
    got = P.simulate(spec(), pc, policy="happy_communication", scenario=scenario, seed=1,
                     device="cpu")
    assert_sim_equal(ref, got)
    assert got.congestion_stats["max_inflation"] > 1.0  # the power was taken


def _random_loads(n, seed):
    rng = np.random.default_rng(seed)
    budget = rng.uniform(0.0, 4000.0, n).astype(np.float32)
    budget[: n // 50] = 0.0  # the clamp to _EPS
    load = (budget * rng.uniform(0.0, 6.0, n)).astype(np.float32)
    load[n // 50: n // 25] = rng.uniform(0.0, 50.0, n // 25 - n // 50)
    return load, budget


@pytest.mark.parametrize("power", [2.0, 1.5, 3.0])
def test_f1_host_inflation_is_the_reference_eager_bitwise(power):
    load, budget = _random_loads(100_000, seed=int(power * 10))
    kw = dict(enabled=True, power=power, max_inflation=1e30)
    rc, pc = R.CongestionConfig(**kw), P.CongestionConfig(**kw)
    lt, bt = torch.from_numpy(load), torch.from_numpy(budget)
    for rfn, pfn in ((R.compute_inflation, P.compute_inflation),
                     (R.comm_inflation, P.comm_inflation)):
        want = np.asarray(rfn(jnp.asarray(load), jnp.asarray(budget), rc))
        got = pfn(lt, bt, pc, eager=True).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    rp = R.predicted_inflation(jnp.asarray(load), jnp.asarray(load), jnp.asarray(budget),
                               jnp.asarray(budget), rc)
    pp = P.predicted_inflation(lt, lt, bt, bt, pc, eager=True)
    for w, g in zip(rp, pp):
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


def test_f1_libm_pow_differs_from_the_square_where_xla_does():
    """The eager reference is not the rounded square on every input, and
    :func:`libm_pow` follows it there."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 8.0, 100_000).astype(np.float32)
    want = np.asarray(jnp.asarray(x) ** 2.0)
    got = libm_pow(torch.from_numpy(x), 2.0).numpy()
    np.testing.assert_array_equal(got, want)
    square = (torch.from_numpy(x) ** 2.0).numpy()
    assert (square != want).any()
    assert libm_pow(torch.zeros(2, 3), 2.0).shape == (2, 3)


# ---------------------------------------------------------------------- F2


def _cpu_baselines():
    cloud = torch.arange(3) >= 2
    return {
        "gus_schedule_np": (P.gus_schedule_np, R.gus_schedule_np),
        "local_all": (lambda i: P.local_all(i, device="cpu"), lambda i: R.local_all(i)),
        "offload_all": (lambda i: P.offload_all(i, cloud, device="cpu"),
                        lambda i: R.offload_all(i, jnp.arange(3) >= 2)),
        "happy_communication": (lambda i: P.happy_communication(i, device="cpu"),
                                lambda i: R.happy_communication(i)),
    }


@pytest.mark.parametrize("shed", [False, True], ids=["bare", "shed"])
@pytest.mark.parametrize("congestion", [False, True], ids=["free", "drain"])
@pytest.mark.parametrize("name", ["gus_schedule_np", "local_all", "offload_all",
                                  "happy_communication"])
def test_f2_simulate_takes_a_raw_callable(name, congestion, shed):
    pfn, rfn = _cpu_baselines()[name]
    rc, pc = configs(congestion, shed)
    ref = R.simulate(spec(), rc, rfn, scenario="outage", seed=1)
    got = P.simulate(spec(), pc, pfn, scenario="outage", seed=1, device="cpu")
    assert_sim_equal(ref, got)
    assert got.n_requests > 0


def test_f2_simulate_hands_a_raw_callable_the_padded_frame():
    seen = {"ref": [], "port": []}

    def ref_cap(inst):
        seen["ref"].append(tuple(inst.acc.shape))
        return R.gus_schedule_np(inst)

    def port_cap(inst):
        assert inst.cover.device.type == "cpu" and inst.cover.dim() == 1
        seen["port"].append(tuple(inst.acc.shape))
        return P.gus_schedule_np(inst)

    rc, pc = configs()
    ref = R.simulate(spec(), rc, ref_cap, seed=1)
    got = P.simulate(spec(), pc, port_cap, seed=1, device="cpu")
    assert_sim_equal(ref, got)
    assert seen["port"] == seen["ref"] and seen["port"]
    assert all(n & (n - 1) == 0 for n, _, _ in seen["port"])  # power-of-two buckets


@pytest.mark.parametrize("name", ["local_all", "offload_all", "random"])
def test_f2_a_policy_passes_positionally(name):
    rc, pc = configs(congestion=False)
    ref = R.simulate(spec(), rc, name, seed=2)
    got = P.simulate(spec(), pc, P.get_policy(name), seed=2, device="cpu")
    assert_sim_equal(ref, got)
    fr = R.simulate_fleet(spec(), rc, name, n_rep=2, seed=2)
    fp = P.simulate_fleet(spec(), pc, name, n_rep=2, seed=2, device="cpu")
    assert_fleet_equal(fr, fp)


@pytest.mark.parametrize("congestion", [False, True], ids=["free", "drain"])
@pytest.mark.parametrize("name", ["gus_schedule_np", "local_all", "offload_all",
                                  "happy_communication"])
def test_f2_simulate_fleet_takes_a_raw_callable(name, congestion):
    pfn, rfn = _cpu_baselines()[name]
    if name == "gus_schedule_np":
        rfn = R.gus_schedule  # the reference's scan cannot trace the NumPy oracle
    rc, pc = configs(congestion)
    ref = R.simulate_fleet(spec(), rc, rfn, scenario="outage", n_rep=3, seed=1)
    got = P.simulate_fleet(spec(), pc, pfn, scenario="outage", n_rep=3, seed=1,
                           device="cpu")
    assert_fleet_equal(ref, got)


def test_f2_simulate_fleet_hands_a_raw_callable_padded_frames():
    seen = {"ref": set(), "port": []}

    def ref_cap(inst):
        seen["ref"].add(tuple(inst.acc.shape))
        return R.gus_schedule(inst)

    def port_cap(inst):
        seen["port"].append(tuple(inst.acc.shape))
        return P.gus_schedule_np(inst)

    rc, pc = configs()
    ref = R.simulate_fleet(spec(), rc, ref_cap, n_rep=2, seed=0)
    got = P.simulate_fleet(spec(), pc, port_cap, n_rep=2, seed=0, device="cpu")
    assert_fleet_equal(ref, got)
    assert len(seen["port"]) == got.n_rep * got.n_frames  # one call per (rep, frame)
    assert set(seen["port"]) == seen["ref"]


@pytest.mark.parametrize("entry", ["simulate", "simulate_fleet"])
def test_f2_refusals(entry):
    rc, pc = configs(congestion=False)
    for pkg, cfg, kw in ((R, rc, {}), (P, pc, {"device": "cpu"})):
        fn = getattr(pkg, entry)
        with pytest.raises(ValueError, match="scheduler= or policy="):
            fn(spec(), cfg, pkg.gus_schedule_np, policy="gus", **kw)
        backend = "xla" if pkg is R else "torch"
        with pytest.raises(ValueError, match="scheduler= or backend="):
            fn(spec(), cfg, pkg.gus_schedule_np,
               options=pkg.EngineOptions(backend=backend), **kw)
        with pytest.raises(ValueError, match="raw scheduler callable"):
            fn(spec(), cfg, pkg.gus_schedule_np,
               options=pkg.EngineOptions(scheduler="hierarchical"), **kw)


# ---------------------------------------------------------------------- F5

F5_CLUSTER = dict(n_edge=3, n_cloud=1, n_services=4, n_variants=6)


def f5_fleets(scheduler, window):
    kw = dict(scenario=None, n_rep=1, seed=0)
    ref_opts = dict(streaming=False, rng_mode="paper-default", window=window)
    out = []
    for pkg, policy, extra in ((R, "gus", {}), (P, "gus", {"device": "cpu"})):
        scn = dataclasses.replace(pkg.get_scenario("mega-city"), rate_per_edge_per_s=30.0)
        opts = pkg.EngineOptions(**ref_opts, **(
            {"scheduler": "hierarchical"} if scheduler == "hierarchical" else {}))
        if scheduler == "hierarchical":
            policy = "gus" if pkg is R else "gus-hier"
        out.append(pkg.simulate_fleet(
            pkg.demo_cluster_spec(**F5_CLUSTER), pkg.SimConfig(horizon_ms=9000.0),
            policy=policy, **{**kw, "scenario": scn}, options=opts, **extra))
    return out


@pytest.mark.parametrize("window", [None, 1], ids=["whole", "window1"])
@pytest.mark.parametrize("scheduler", ["dense", "hierarchical"])
def test_f5_materialized_fleet_defers_to_the_scenario_rng_mode(scheduler, window):
    ref, got = f5_fleets(scheduler, window)
    assert_fleet_equal(ref, got)
    assert got.n_requests == ref.n_requests == 1026
    if scheduler == "hierarchical":
        np.testing.assert_array_equal(got.mean_us_per_rep, ref.mean_us_per_rep)
