"""The port's sequential testbed ``simulate`` with admission control
against the JAX reference, on the CPU: the protected column of the
resilience matrix (every registered policy under the five regimes of
``tests/test_torch_resilience_simulate.py``, with per-server queue caps at
one frame budget and deadline shedding), and the reference's behavioural
checks, each run equal to the reference (``as_dict()``,
``resilience_stats``, bandwidth estimates and congestion stats, exactly).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from test_torch_resilience_simulate import (  # noqa: E402
    COMPOSITE,
    REGIMES,
    RComposite,
    PComposite,
    assert_sim_equal,
    both,
    cfg,
    run_regime,
)

#: resilience_stats of every run of the matrix, for the coverage check
SEEN = {}


@pytest.mark.parametrize("name", REGIMES)
@pytest.mark.parametrize("policy", R.list_policies())
def test_every_policy_under_every_regime_protected(policy, name):
    ref, got = run_regime(policy, name, "protected")
    assert_sim_equal(ref, got)
    SEEN[(policy, name)] = got.resilience_stats


def test_the_matrix_exercised_every_mechanism():
    """Across the protected column the outage stream took a server down,
    shedding dropped requests and the queue cap refused assignments (each
    run equal to the reference above)."""
    for key in [(p, n) for p in ("gus", "happy_computation") for n in REGIMES]:
        if key not in SEEN:
            SEEN[key] = run_regime(*key, "protected")[1].resilience_stats
    stats = list(SEEN.values())
    assert max(s["frames_with_down_server"] for s in stats) > 0
    assert max(s["n_shed"] for s in stats) > 0
    assert max(s["n_refused"] for s in stats) > 0


# ---------------------------------------------------------------------------
# behaviour, each run equal to the reference
# ---------------------------------------------------------------------------

FULL = lambda m: m.ImpairmentConfig(  # noqa: E731
    enabled=True, link_profiles=(m.IntermittentLink(),), seed=3, outage_mtbf_frames=6.0,
    outage_mttr_frames=3.0, outage_servers=(1,))


def test_impairments_reduce_satisfaction():
    imp = lambda m: m.ImpairmentConfig(  # noqa: E731
        enabled=True, link_profiles=(m.IntermittentLink(), m.SatelliteLink()), seed=3)
    tight = dict(horizon_ms=lambda m: 24_000.0, delay_req_ms=lambda m: 1500.0)
    ref, got = both(impairments=imp, **tight)
    assert_sim_equal(ref, got)
    base = P.simulate(P.demo_cluster_spec(), cfg(P, horizon_ms=24_000.0, delay_req_ms=1500.0),
                      device="cpu")
    assert got.satisfied_pct < base.satisfied_pct and got.n_requests == base.n_requests


def test_outage_stream_is_accounted():
    outages = lambda m: m.ImpairmentConfig(  # noqa: E731
        enabled=True, outage_mtbf_frames=6.0, outage_mttr_frames=3.0, outage_servers=(1,),
        seed=3)
    ref, got = both(horizon_ms=lambda m: 24_000.0, impairments=outages)
    assert_sim_equal(ref, got)
    assert got.resilience_stats["frames_with_down_server"] > 0
    base = P.simulate(P.demo_cluster_spec(), cfg(P, horizon_ms=24_000.0), device="cpu")
    assert got.satisfied_pct <= base.satisfied_pct


def test_backlog_conservation_closes_across_outages():
    ref, got = both(scenario=lambda m: (RComposite if m is R else PComposite)(**COMPOSITE),
                    rate=lambda m: 4.0, horizon_ms=lambda m: 18_000.0, impairments=FULL,
                    congestion=lambda m: m.CongestionConfig(enabled=True))
    assert_sim_equal(ref, got)
    s = got.congestion_stats
    for kind in ("gamma", "eta"):
        np.testing.assert_allclose(s[f"work_drained_{kind}"] + s[f"final_backlog_{kind}"],
                                   s[f"work_enqueued_{kind}"], rtol=1e-6)


@pytest.mark.parametrize("policy", ["gus-adaptive", "happy_computation", "gus-hier"])
def test_congested_protection_with_early_decisions(policy):
    """A queue cap of 2 fires decisions early inside the wall-clock frame
    (they share its link draw and budgets); congestion at a half drain
    builds the backlog the cap reads."""
    ref, got = both(policy, rate=lambda m: 6.0, queue_cap=lambda m: 2, impairments=FULL,
                    congestion=lambda m: m.CongestionConfig(enabled=True, drain=0.5),
                    admission=lambda m: m.AdmissionConfig(enabled=True, queue_cap_mult=0.5,
                                                          shed=True))
    assert_sim_equal(ref, got)


