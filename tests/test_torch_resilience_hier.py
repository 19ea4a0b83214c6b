"""The port's hierarchical class-aggregate fleet under the resilience layer,
against the JAX reference, on the CPU.

The cases of ``tests/test_hier_parity.py``'s fleet section: class-level
deadline shedding and queue caps on singleton classes (equal to the dense
fleet), impaired duplicate classes (per-member link draws at
deaggregation, equal to the dense fleet), every mechanism at once with
congestion on, ``mega-city`` with admission and impairments, and the
impaired duplicate-class run pinned by ``tests/fixtures/
hier_member_golden.npz``.  As in ``tests/test_torch_hier.py``,
``n_requests``, ``n_served``, ``satisfied_per_rep`` and
``mean_us_per_rep`` equal the reference's exactly (the member accounting
is the reference's numpy, op for op); with congestion on, the backlog and
the mean inflation follow the committed loads' fixed order and are held
to ``BACKLOG_RTOL``.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402

import repro_torch.core as P  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures"
#: the congested backlog and mean inflation vs the reference's XLA sums
#: (tests/test_torch_hier.py)
BACKLOG_RTOL = 1e-5
HIER = dict(scheduler="hierarchical")


def fleet_cfg(mod, **kw):
    """``tests/test_hier_parity.py``'s fleet config; ``kw`` values are
    callables of the package."""
    base = dict(horizon_ms=12_000.0, arrival_rate_per_s=4.0, delay_req_ms=6000.0,
                acc_req_mean=50.0, acc_req_std=10.0)
    base.update({k: v(mod) if callable(v) else v for k, v in kw.items()})
    return mod.SimConfig(**base)


def impaired(mod):
    return mod.ImpairmentConfig(enabled=True, seed=7,
                                link_profiles=(mod.IntermittentLink(), mod.BurstyLossLink()))


def runs(opts=None, **kw):
    """``(reference hier, port hier, port dense)`` of the same config on
    ``demo_cluster_spec()``, 2 replications; ``port(**options)`` runs the
    port with other options."""
    spec = R.demo_cluster_spec()
    ref = R.simulate_fleet(spec, fleet_cfg(R, **kw), policy="gus", n_rep=2, seed=0,
                           options=R.EngineOptions(**HIER, **(opts or {})))

    def port(**o):
        return P.simulate_fleet(spec, fleet_cfg(P, **kw), policy="gus", n_rep=2, seed=0,
                                device="cpu", options=P.EngineOptions(**o))

    return ref, port(**HIER, **(opts or {})), port


def assert_hier_equal(ref, got, congestion=False):
    assert got.n_requests == ref.n_requests and got.n_served == ref.n_served
    np.testing.assert_array_equal(got.satisfied_per_rep, ref.satisfied_per_rep)
    np.testing.assert_array_equal(got.mean_us_per_rep, ref.mean_us_per_rep)
    if congestion:
        np.testing.assert_allclose(got.final_backlog_per_rep, ref.final_backlog_per_rep,
                                   rtol=BACKLOG_RTOL, atol=0)
        np.testing.assert_allclose(got.mean_compute_inflation, ref.mean_compute_inflation,
                                   rtol=BACKLOG_RTOL)
    else:
        assert got.final_backlog_per_rep is None


def assert_matches_dense(dense, hier):
    assert hier.n_requests == dense.n_requests and hier.n_served == dense.n_served
    np.testing.assert_array_equal(hier.satisfied_per_rep, dense.satisfied_per_rep)
    np.testing.assert_allclose(hier.mean_us_per_rep, dense.mean_us_per_rep, rtol=1e-6)


def test_admission_shed_on_singletons():
    """A deadline below the frame makes early arrivals provably late: the
    class-level shed on singleton classes equals the dense shed."""
    kw = dict(delay_req_ms=2500.0, admission=lambda m: m.AdmissionConfig(enabled=True, shed=True))
    ref, got, port = runs(**kw)
    assert_hier_equal(ref, got)
    assert_matches_dense(port(), got)
    unshed = runs(delay_req_ms=2500.0)[1]
    assert_hier_equal(unshed, got)  # at unit inflation the shed places the same cells


def test_admission_queue_cap_zero_on_singletons():
    ref, got, port = runs(admission=lambda m: m.AdmissionConfig(enabled=True, queue_cap_mult=0.0))
    assert_hier_equal(ref, got)
    assert_matches_dense(port(), got)
    assert got.n_served == 0 and got.satisfied_pct == 0.0


def frame_snapped_dup(mod, dup=3):
    """``tests/test_hier_parity.py``'s ``_FrameSnappedDup`` scenario in
    package ``mod``: every arrival snapped to its frame start and repeated
    ``dup`` times, so the class means are lossless."""

    @dataclasses.dataclass(frozen=True)
    class FrameSnappedDup(mod.Scenario):
        name: str = "frame-snapped-dup"

        def generate_arrivals(self, rng, n_edge, n_services, cfg, rng_mode=None):
            base = super().generate_arrivals(rng, n_edge, n_services, cfg, rng_mode=rng_mode)
            out = []
            for r in base:
                snap = float(math.floor(r.arrival_ms / cfg.frame_ms) * cfg.frame_ms)
                out.extend(dataclasses.replace(r, arrival_ms=snap) for _ in range(dup))
            out.sort(key=lambda r: r.arrival_ms)
            for i, r in enumerate(out):
                r.rid = i
            return out

    return FrameSnappedDup()


def _ample_spec():
    s = R.demo_cluster_spec()
    return dataclasses.replace(s, gamma_frame=np.asarray(s.gamma_frame) * 200.0,
                               eta_frame=np.asarray(s.eta_frame) * 200.0)


def _dup_run(mod, impairments=True, **opts):
    """``tests/test_hier_parity.py::golden_run`` (the impaired duplicate-class
    hierarchical fleet) in package ``mod``."""
    cfg = mod.SimConfig(horizon_ms=12_000.0, arrival_rate_per_s=3.0, delay_req_ms=3300.0,
                        acc_req_std=0.0, req_size_lo=65_536.0, req_size_hi=65_536.0,
                        impairments=impaired(mod) if impairments else mod.ImpairmentConfig())
    kw = {} if mod is R else dict(device="cpu")
    return mod.simulate_fleet(_ample_spec(), cfg, policy="gus", scenario=frame_snapped_dup(mod),
                              n_rep=2, seed=0, options=mod.EngineOptions(**opts), **kw)


def test_member_golden_fixture():
    """The port's impaired duplicate-class run reproduces the committed
    fixture exactly, and the reference's run."""
    g = np.load(FIXTURES / "hier_member_golden.npz")
    got = _dup_run(P, **HIER)
    assert int(g["n_requests"]) == got.n_requests
    assert int(g["n_served"]) == got.n_served
    np.testing.assert_array_equal(g["satisfied_per_rep"], got.satisfied_per_rep)
    np.testing.assert_array_equal(g["mean_us_per_rep"], got.mean_us_per_rep)
    assert_hier_equal(_dup_run(R, **HIER), got)


@pytest.mark.parametrize("window,prefetch", [(None, 0), (1, 2)])
def test_duplicate_classes_impaired_match_dense(window, prefetch):
    """Per-member link draws at deaggregation reproduce the dense impaired
    fleet exactly on lossless duplicate classes, and the draws bite."""
    hier = _dup_run(P, **HIER, window=window, prefetch=prefetch)
    assert_matches_dense(_dup_run(P), hier)
    plain = _dup_run(P, impairments=False, **HIER)
    assert (not np.array_equal(plain.satisfied_per_rep, hier.satisfied_per_rep)
            or not np.allclose(plain.mean_us_per_rep, hier.mean_us_per_rep))


@pytest.mark.parametrize("drain,cap", [(1.0, math.inf), (0.5, 0.4)])
@pytest.mark.parametrize("window,prefetch", [(None, 0), (2, 2)])
def test_every_mechanism_with_congestion(window, prefetch, drain, cap):
    """Shedding against the congested estimate on the class grid, the cap
    on the carried backlog (0.4 budgets at a half drain: it refuses cells,
    and the committed loads are added again), links and outages."""
    kw = dict(delay_req_ms=4000.0, arrival_rate_per_s=6.0,
              admission=lambda m: m.AdmissionConfig(enabled=True, shed=True, queue_cap_mult=cap),
              impairments=lambda m: dataclasses.replace(
                  impaired(m), outage_mtbf_frames=6.0, outage_servers=(1,)),
              congestion=lambda m: m.CongestionConfig(enabled=True, drain=drain))
    ref, got, port = runs(opts=dict(window=window, prefetch=prefetch), **kw)
    assert_hier_equal(ref, got, congestion=True)
    if cap < math.inf:  # the cap really refused cells
        uncapped = runs(**dict(kw, admission=lambda m: m.AdmissionConfig(enabled=True, shed=True)))
        assert uncapped[1].n_served > got.n_served


def test_mega_city_with_admission_and_impairments():
    """The reference's city-scale composition (``benchmarks/fleet_scale.py``'s
    users sweep), cut to 60 req/s per edge."""
    scn = lambda m: dataclasses.replace(m.get_scenario("mega-city"),  # noqa: E731
                                        rate_per_edge_per_s=60.0)
    spec = R.demo_cluster_spec(n_edge=6, n_cloud=1, n_services=5, n_variants=10)
    kw = dict(horizon_ms=9_000.0, admission=lambda m: m.AdmissionConfig(enabled=True, shed=True),
              impairments=impaired)
    ref = R.simulate_fleet(spec, R.SimConfig(**{k: v(R) if callable(v) else v
                                                 for k, v in kw.items()}),
                           policy="gus", scenario=scn(R), n_rep=1, seed=0,
                           options=R.EngineOptions(**HIER, window=1))
    got = P.simulate_fleet(spec, P.SimConfig(**{k: v(P) if callable(v) else v
                                                 for k, v in kw.items()}),
                           policy="gus", scenario=scn(P), n_rep=1, seed=0, device="cpu",
                           options=P.EngineOptions(**HIER, window=1, prefetch=2))
    assert_hier_equal(ref, got)
    assert 0 < got.n_served < got.n_requests
