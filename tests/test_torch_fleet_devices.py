"""The fleet over several devices (``EngineOptions(devices=, rep_group=)``)
against the single-device port and the JAX reference, on the CPU.

torch has no virtual CPU devices, so the tests hand the fleet's one
device resolver (``core/simulator.py::_local_devices``) k copies of the CPU
device: every group, worker thread and class slab of a k-device run then
runs as it would on k cards.  The contract is the reference's
(``tests/test_fleet_sharding.py``): a run over several devices equals the
single-device run bit for bit, every ``FleetResult`` field, for every
vmappable policy, with congestion on and off, for any group width, windowed
and prefetched, and on the hierarchical layout; the single-device run
equals the reference's at ``tests/test_torch_fleet.py``'s tolerances; and
asking for more devices than exist raises, never falls back.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402

US_TOL = dict(rtol=1e-5, atol=1e-6)
BASE = dict(horizon_ms=12_000.0, arrival_rate_per_s=4.0, delay_req_ms=6000.0,
            acc_req_mean=50.0, acc_req_std=10.0)
CONGESTION = {"off": {}, "drain": dict(enabled=True, drain=0.5)}
VMAPPABLE = [p for p in P.list_policies()
             if P.get_policy(p).vmappable and P.get_policy(p).pad]
FIELDS = ("satisfied_per_rep", "mean_us_per_rep", "final_backlog_per_rep")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture
def cpu_devices(monkeypatch):
    """``use(k)``: the fleet sees k CPU devices."""
    def use(k: int) -> None:
        monkeypatch.setattr(S, "_local_devices", lambda dev: [dev] * k)

    return use


def port(congestion="off", devices=None, n_rep=7, policy="gus", **opts):
    cfg = P.SimConfig(**BASE, congestion=P.CongestionConfig(**CONGESTION[congestion]))
    return P.simulate_fleet(P.demo_cluster_spec(), cfg, policy=policy, n_rep=n_rep, seed=0,
                            options=P.EngineOptions(devices=devices, **opts), device="cpu")


def reference(congestion="off", n_rep=7, policy="gus", **opts):
    cfg = R.SimConfig(**BASE, congestion=R.CongestionConfig(**CONGESTION[congestion]))
    return R.simulate_fleet(R.demo_cluster_spec(), cfg, policy=policy, n_rep=n_rep, seed=0,
                            options=R.EngineOptions(**opts))


def assert_identical(a, b, msg=""):
    """Every result field bit for bit."""
    for f in ("n_rep", "n_frames", "n_requests", "n_served", "mean_compute_inflation"):
        assert getattr(a, f) == getattr(b, f), (f, msg)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, (f, msg)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{f} {msg}")


def assert_matches_reference(ref, got, us_exact=False, backlog_rtol=0.0):
    """The port's single-device run against the reference's: integers
    exact, ``mean_us_per_rep`` at the float32 summation-order tolerance
    (exact on the hierarchical layout), the congested hierarchical
    backlogs at ``backlog_rtol`` (ROADMAP.md §3)."""
    assert (got.n_requests, got.n_served) == (ref.n_requests, ref.n_served)
    np.testing.assert_array_equal(got.satisfied_per_rep, ref.satisfied_per_rep)
    if us_exact:
        np.testing.assert_array_equal(got.mean_us_per_rep, ref.mean_us_per_rep)
    else:
        np.testing.assert_allclose(got.mean_us_per_rep, ref.mean_us_per_rep, **US_TOL)
    if ref.final_backlog_per_rep is None:
        assert got.final_backlog_per_rep is None
    else:
        np.testing.assert_allclose(got.final_backlog_per_rep, ref.final_backlog_per_rep,
                                   rtol=backlog_rtol, atol=0)
        np.testing.assert_allclose(got.mean_compute_inflation, ref.mean_compute_inflation,
                                   rtol=backlog_rtol, atol=0)


@pytest.mark.parametrize("congestion", ["off", "drain"])
@pytest.mark.parametrize("policy", VMAPPABLE)
def test_every_policy_over_devices_equals_one_device(policy, congestion, cpu_devices):
    single = port(congestion, devices=1, policy=policy)
    assert single.n_devices == 1
    assert_matches_reference(reference(congestion, policy=policy), single)
    cpu_devices(3)
    got = port(congestion, devices=3, policy=policy)
    assert got.n_devices == 3
    assert_identical(single, got, f"{policy} {congestion}")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("congestion", ["off", "drain"])
def test_two_and_four_devices(k, congestion, cpu_devices):
    single = port(congestion, devices=1)
    cpu_devices(k)
    got = port(congestion, devices=k)
    assert got.n_devices == k
    assert_identical(single, got, f"{congestion} devices={k}")


@pytest.mark.parametrize("n_rep", [1, 5, 7])
@pytest.mark.parametrize("rep_group", [None, S.FLEET_REP_GROUP, 3, 40])
def test_group_widths_and_uneven_replication_counts(rep_group, n_rep, cpu_devices):
    """Any group width (the last group narrower where it does not divide
    n_rep, a width above n_rep clamped to it) gives the one-device run."""
    single = port("drain", devices=1, n_rep=n_rep)
    cpu_devices(3)
    got = port("drain", devices=3, n_rep=n_rep, rep_group=rep_group)
    assert got.n_devices == 3
    assert_identical(single, got, f"rep_group={rep_group} n_rep={n_rep}")


@pytest.mark.parametrize("window,prefetch", [(2, 0), (2, 2), (3, 1), (None, 2)])
@pytest.mark.parametrize("congestion", ["off", "drain"])
def test_windowed_and_prefetched_over_devices(window, prefetch, congestion, cpu_devices):
    single = port(congestion, devices=1, prefetch=0)
    cpu_devices(4)
    got = port(congestion, devices=4, window=window, prefetch=prefetch, rep_group=2)
    assert got.window == (window or got.n_frames)
    assert_identical(single, got, f"window={window} prefetch={prefetch}")


@pytest.mark.parametrize("congestion", ["off", "drain"])
def test_hierarchical_class_split_equals_one_device(congestion, cpu_devices):
    """The class slabs of the utility / feasibility tensors, one a device,
    give the one-device run; that run is the reference's."""
    kw = dict(scheduler="hierarchical", n_rep=4, window=3)
    single = port(congestion, devices=1, **kw)
    assert_matches_reference(reference(congestion, **kw), single, us_exact=True,
                             backlog_rtol=1e-5)
    for k in (2, 3, 4):
        cpu_devices(k)
        got = port(congestion, devices=k, **kw)
        assert got.n_devices == k
        assert_identical(single, got, f"hierarchical {congestion} devices={k}")


def test_class_tensors_split_into_slabs(cpu_devices):
    """More devices than classes leave the spare slabs empty; each slab's
    values are the whole grid's."""
    host = {k: torch.from_numpy(v) for k, v in _grid().items()}
    dev = torch.device("cpu")
    whole = S._hier_device_inputs(host, dev)
    for k in (2, 3, 7, 40):
        parts = S._hier_device_inputs(host, dev, [dev] * k)
        for a, b in zip(whole[1:3], parts[1:3]):
            assert torch.equal(a, b), k


def _grid():
    spec = P.demo_cluster_spec()
    cfg = P.SimConfig(**BASE)
    rng = np.random.default_rng(0)
    reqs = P.get_scenario("paper-default").generate_arrivals(
        rng, spec.n_edge, spec.proc_ms.shape[1], cfg)[:40]
    arrays = S._build_frame_batch([reqs], spec, cfg, [0.0],
                                  [(spec.gamma_frame, spec.eta_frame)], 64)
    arrays["count"] = np.ones((1, 64), np.int32)
    return arrays


def test_too_many_devices_raise_never_fall_back(cpu_devices):
    with pytest.raises(ValueError, match="local device"):
        port(devices=2)
    with pytest.raises(ValueError, match="local device"):
        port(devices=2, scheduler="hierarchical")
    with pytest.raises(ValueError, match="devices"):
        port(devices=0)
    cpu_devices(2)
    with pytest.raises(ValueError, match="local device"):
        port(devices=3)
    # a host-side policy drives one device
    with pytest.raises(ValueError, match="host"):
        port(devices=2, policy="gus-hier")
    assert port(devices=1, policy="gus-hier").n_devices == 1
    assert port(policy="gus-hier").n_devices == 1  # devices=None: the one device it drives


def test_default_takes_every_local_device_up_to_n_rep(cpu_devices):
    cpu_devices(4)
    assert port(n_rep=7).n_devices == 4
    assert port(n_rep=3).n_devices == 3
    assert port(n_rep=3, scheduler="hierarchical").n_devices == 3


def test_scenario_runner_devices(cpu_devices, capsys):
    from repro_torch.launch import run_scenario as cli

    argv = ["--fleet", "6", "--horizon-s", "9", "--device", "cpu", "--congestion"]
    _, one = cli.main(argv + ["--devices", "1"])
    cpu_devices(2)
    _, two = cli.main(argv + ["--devices", "2"])
    assert two.n_devices == 2 and "on 2 device(s)" in capsys.readouterr().out
    assert_identical(one, two)


_REF_SCRIPT = r"""
import json, sys
import numpy as np
import repro.core as R
out = {}
for congestion in ("off", "drain"):
    c = {"off": {}, "drain": dict(enabled=True, drain=0.5)}[congestion]
    cfg = R.SimConfig(**json.loads(sys.argv[1]), congestion=R.CongestionConfig(**c))
    fr = R.simulate_fleet(R.demo_cluster_spec(), cfg, policy="gus", n_rep=7, seed=0,
                          options=R.EngineOptions(devices=4))
    assert fr.n_devices == 4
    out[congestion] = {"n_requests": fr.n_requests, "n_served": fr.n_served,
                       "satisfied_per_rep": fr.satisfied_per_rep.tolist(),
                       "mean_us_per_rep": fr.mean_us_per_rep.tolist(),
                       "final_backlog_per_rep": None if fr.final_backlog_per_rep is None
                       else fr.final_backlog_per_rep.tolist()}
print(json.dumps(out))
"""


def test_four_devices_against_the_references_four_devices(cpu_devices):
    """The reference's ``simulate_fleet(devices=4)`` on four virtual XLA
    CPU devices (a subprocess: XLA fixes its device count at start) against
    the port's four-device run."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + [p for p in [os.environ.get("PYTHONPATH")]
                                                   if p]))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(BASE)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    cpu_devices(4)
    for congestion, r in ref.items():
        got = port(congestion, devices=4)
        assert got.n_devices == 4
        assert (got.n_requests, got.n_served) == (r["n_requests"], r["n_served"])
        np.testing.assert_array_equal(got.satisfied_per_rep, r["satisfied_per_rep"])
        np.testing.assert_allclose(got.mean_us_per_rep, r["mean_us_per_rep"], **US_TOL)
        if r["final_backlog_per_rep"] is None:
            assert got.final_backlog_per_rep is None
        else:
            np.testing.assert_array_equal(got.final_backlog_per_rep,
                                          np.asarray(r["final_backlog_per_rep"], np.float32))
