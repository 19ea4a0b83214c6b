"""The port's sequential testbed ``simulate`` under the resilience layer,
against the JAX reference, on the CPU.

Every registered policy runs under the five impairment regimes of the
reference's resilience figure (``benchmarks/paper_figures.py::
fig_resilience``: disconnect-reconnect, satellite, handoff, outage stream,
and the flash-crowd + outage composite with congestion on), bare here and
with the protected admission setting in
``tests/test_torch_resilience_protected.py``, at
``tests/test_resilience.py``'s size (``demo_cluster_spec()``, 12 s).
``SimResult.as_dict()``, ``resilience_stats``, the bandwidth estimates and
the congestion stats must be equal — exactly, floats included: the port keeps the reference's host
accounting (link arithmetic, queue caps) in numpy float64 op for op and
runs the shed test on the same float32 values.

Also here: the disabled and amplitude-0 identities (bitwise inert) and the
``impairment-reduced`` golden frame regenerated by the port's ``simulate``
with the fixture's recipe.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core.scenarios import FlashCrowdOutageScenario as RComposite  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core.scenarios import FlashCrowdOutageScenario as PComposite  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures"
COMPOSITE = dict(burst_mult=3.0, burst_start_frac=0.2, burst_end_frac=0.4,
                 outage_start_frac=0.2, outage_end_frac=0.4)


def regime(mod, name):
    """``(scenario, impairments, congestion, rate)`` of one of the
    reference's resilience regimes, built in package ``mod``."""
    if name == "disconnect-reconnect":
        imp = mod.ImpairmentConfig(enabled=True, link_profiles=(mod.IntermittentLink(),))
    elif name == "satellite":
        imp = mod.ImpairmentConfig(enabled=True, link_profiles=(mod.SatelliteLink(),))
    elif name == "handoff":
        imp = mod.ImpairmentConfig(
            enabled=True, link_profiles=(mod.HandoffLink(period_frames=4, period_jitter=1),))
    elif name == "outage-stream":
        imp = mod.ImpairmentConfig(enabled=True, outage_mtbf_frames=6.0, outage_mttr_frames=3.0,
                                   outage_servers=(1, 3))
    else:
        assert name == "flash-crowd-outage"
        imp = mod.ImpairmentConfig(enabled=True, link_profiles=(mod.IntermittentLink(),),
                                   outage_mtbf_frames=6.0, outage_mttr_frames=3.0,
                                   outage_servers=(1,))
        scn = (RComposite if mod is R else PComposite)(**COMPOSITE)
        return scn, imp, mod.CongestionConfig(enabled=True), 4.0
    return "paper-default", imp, mod.CongestionConfig(), 2.0


REGIMES = ("disconnect-reconnect", "satellite", "handoff", "outage-stream",
           "flash-crowd-outage")


def cfg(mod, rate=2.0, horizon_ms=12_000.0, **kw):
    return mod.SimConfig(horizon_ms=horizon_ms, arrival_rate_per_s=rate,
                         delay_req_ms=kw.pop("delay_req_ms", 6000.0), acc_req_mean=50.0,
                         acc_req_std=10.0, **kw)


def protected(mod):
    return mod.AdmissionConfig(enabled=True, queue_cap_mult=1.0, shed=True)


def both(policy="gus", scenario="paper-default", seed=0, **kw):
    """The same run through both packages; ``kw`` values are callables of
    the package."""
    ref = R.simulate(R.demo_cluster_spec(), cfg(R, **{k: v(R) for k, v in kw.items()}),
                     policy=policy, scenario=scenario if isinstance(scenario, str)
                     else scenario(R), seed=seed)
    got = P.simulate(P.demo_cluster_spec(), cfg(P, **{k: v(P) for k, v in kw.items()}),
                     policy=policy, scenario=scenario if isinstance(scenario, str)
                     else scenario(P), seed=seed, device="cpu")
    return ref, got


def assert_sim_equal(ref, got):
    assert got.as_dict() == ref.as_dict()
    assert got.resilience_stats == ref.resilience_stats
    assert got.bandwidth_estimates == ref.bandwidth_estimates
    assert got.congestion_stats == ref.congestion_stats
    for f in ("n_requests", "n_served", "n_satisfied", "n_local", "n_cloud",
              "n_edge_offload", "n_dropped"):
        assert getattr(got, f) == getattr(ref, f), f


def run_regime(policy, name, mechanism):
    out = []
    for mod in (R, P):
        scn, imp, cc, rate = regime(mod, name)
        c = cfg(mod, rate=rate, congestion=cc, impairments=imp,
                admission=protected(mod) if mechanism == "protected" else mod.AdmissionConfig())
        kw = {} if mod is R else dict(device="cpu")
        out.append(mod.simulate(mod.demo_cluster_spec(), c, policy=policy, scenario=scn, seed=0,
                                **kw))
    return out


@pytest.mark.parametrize("name", REGIMES)
@pytest.mark.parametrize("policy", R.list_policies())
def test_every_policy_under_every_regime(policy, name):
    """Bare: the impairments alone (the protected column is
    ``tests/test_torch_resilience_protected.py``)."""
    ref, got = run_regime(policy, name, "none")
    assert_sim_equal(ref, got)
    assert got.resilience_stats is not None
    assert got.resilience_stats["n_shed"] == got.resilience_stats["n_refused"] == 0.0


# ---------------------------------------------------------------------------
# identities
# ---------------------------------------------------------------------------


def test_disabled_and_default_admission_are_bitwise_inert():
    base = P.simulate(P.demo_cluster_spec(), cfg(P), device="cpu")
    off = P.simulate(P.demo_cluster_spec(), cfg(P, impairments=P.ImpairmentConfig(),
                                                admission=P.AdmissionConfig()), device="cpu")
    assert base.as_dict() == off.as_dict() and off.resilience_stats is None
    on = P.simulate(P.demo_cluster_spec(), cfg(P, admission=P.AdmissionConfig(enabled=True)),
                    device="cpu")
    assert base.as_dict() == on.as_dict()
    assert on.resilience_stats == {"n_shed": 0.0, "n_refused": 0.0,
                                   "frames_with_down_server": 0.0}


@pytest.mark.parametrize("policy", ["gus", "gus-adaptive", "random"])
def test_amplitude_zero_is_bitwise_inert(policy):
    zero = P.ImpairmentConfig(enabled=True, amplitude=0.0, seed=3,
                              link_profiles=(P.IntermittentLink(), P.SatelliteLink()))
    base = P.simulate(P.demo_cluster_spec(), cfg(P), policy=policy, device="cpu")
    amp0 = P.simulate(P.demo_cluster_spec(), cfg(P, impairments=zero), policy=policy,
                      device="cpu")
    assert base.as_dict() == amp0.as_dict()
    assert base.bandwidth_estimates == amp0.bandwidth_estimates
    assert amp0.resilience_stats is not None


def test_shed_without_congestion_is_noop_for_gus():
    ref, got = both(rate=lambda m: 6.0,
                    admission=lambda m: m.AdmissionConfig(enabled=True, shed=True))
    assert_sim_equal(ref, got)
    base = P.simulate(P.demo_cluster_spec(), cfg(P, rate=6.0), device="cpu")
    assert base.as_dict() == got.as_dict()


# ---------------------------------------------------------------------------
# the impairment-reduced golden frame, regenerated by the port's simulate
# ---------------------------------------------------------------------------


def test_impairment_reduced_golden_frame():
    """``tests/fixtures/make_golden_frames.py``'s recipe on the port: the
    first frame whose ``ctime`` differs from the amplitude-0 twin's, with
    identical requests, has every leaf of the stored fixture."""
    d = np.load(FIXTURES / "gus_golden_impairment-reduced.npz")
    gus = P.get_policy("gus")

    def run(amplitude):
        frames = []
        make = lambda n_edge, n_servers: lambda b: (  # noqa: E731
            frames.append(b), gus.bind(n_edge, n_servers)(b))[1]
        pol = P.Policy(name="gus-capture", description="gus, keeping its frames",
                       kind="greedy", make=make)
        imp = P.ImpairmentConfig(enabled=True, amplitude=amplitude, seed=3,
                                 link_profiles=(P.IntermittentLink(), P.SatelliteLink()))
        P.simulate(P.demo_cluster_spec(), cfg(P, rate=4.0, impairments=imp), policy=pol,
                   seed=0, device="cpu")
        return [{f.name: getattr(b, f.name)[0].numpy() for f in dataclasses.fields(b)}
                for b in frames]

    picked = None
    for f, g in zip(run(1.0), run(0.0)):
        if f["ctime"].shape != g["ctime"].shape:
            break
        same = all(np.array_equal(f[k], g[k]) for k in ("cover", "A", "C"))
        if same and not np.array_equal(f["ctime"], g["ctime"]):
            picked = (f, g)
            break
    assert picked is not None
    f, g = picked
    for leaf in ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail",
                 "gamma", "eta", "max_as", "max_cs"):
        np.testing.assert_array_equal(f[leaf], d[leaf], err_msg=leaf)
    np.testing.assert_array_equal(g["ctime"], d["ctime_unimpaired"])
