"""The port's resilience primitives against the JAX reference, on the CPU.

Case for case with ``tests/test_impairments.py``: the link profiles and
their traces, the outage chains, the resilience engine and the admission
primitives (``predicted_inflation``, ``admission_keep``,
``apply_queue_cap``).  The host part is numpy in both packages, so every
trace value, link frame and up vector must be equal bit for bit; the
admission primitives run on the same float32 inputs and must give equal
masks, assignments and inflation factors (exactly: elementwise float32
operations, one rounding each).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.impairments as RI  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.core.impairments as PI  # noqa: E402

#: (name, keyword arguments) of every profile, built in either package
PROFILES = [
    ("IdealLink", {}),
    ("IntermittentLink", {}),
    ("BurstyLossLink", {}),
    ("HandoffLink", {}),
    ("HandoffLink", dict(period_frames=4, period_jitter=1)),
    ("HandoffLink", dict(period_frames=6, period_jitter=2, gap_frames=3)),
    ("SatelliteLink", {}),
    ("ComposedLink", None),
]
TINY = R.GeneratorConfig(n_requests=8, n_edge=3, n_cloud=1, n_services=3, n_variants=2)
CC_P = P.CongestionConfig(enabled=True)


def profile(mod, name, kw):
    if kw is None:
        return mod.ComposedLink(parts=(mod.IntermittentLink(), mod.SatelliteLink()))
    return getattr(mod, name)(**kw)


def ids(p):
    return f"{p[0]}{'' if not p[1] else '-' + '-'.join(map(str, p[1].values()))}"


def port_inst(inst):
    """A reference ``FlatInstance`` as the port's, on the CPU."""
    return P.FlatInstance.from_numpy(
        {f.name: np.asarray(getattr(inst, f.name)) for f in dataclasses.fields(inst)}, "cpu"
    )


# ---------------------------------------------------------------------------
# profiles and traces: the same draws, value for value
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prof", PROFILES, ids=ids)
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_trace_values_match_reference(prof, seed):
    ref = R.LinkTrace(profile(R, *prof), seed=seed).values(0, 200)
    got = P.LinkTrace(profile(P, *prof), seed=seed).values(0, 200)
    for r, g in zip(ref, got):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("prof", PROFILES, ids=ids)
def test_trace_values_bounded(prof):
    bw, lat = P.LinkTrace(profile(P, *prof), seed=7).values(0, 200)
    assert np.isfinite(bw).all() and np.isfinite(lat).all()
    assert (bw >= PI.MIN_BW_SCALE).all() and (bw <= 1.0).all()
    assert (lat >= 0.0).all()


@pytest.mark.parametrize("prof", PROFILES, ids=ids)
def test_trace_chunked_equals_oneshot(prof):
    """The pull pattern never changes the sequence (scalar re-reads too)."""
    p = profile(P, *prof)
    bw_ref, lat_ref = P.LinkTrace(p, seed=11).values(0, 120)
    chunked = P.LinkTrace(p, seed=11)
    parts = [chunked.values(a, b) for a, b in ((0, 7), (7, 40), (40, 41), (41, 120))]
    np.testing.assert_array_equal(np.concatenate([b for b, _ in parts]), bw_ref)
    np.testing.assert_array_equal(np.concatenate([t for _, t in parts]), lat_ref)
    scalar = P.LinkTrace(p, seed=11)
    assert scalar.value(100) == (bw_ref[100], lat_ref[100])
    assert scalar.value(5) == (bw_ref[5], lat_ref[5])
    assert len(scalar) == 101


def test_profile_states_and_shapes():
    """Each profile's states, as ``tests/test_impairments.py`` pins them."""
    p = P.IntermittentLink()
    bw, lat = P.LinkTrace(p, seed=1).values(0, 200)
    up = bw == 1.0
    np.testing.assert_array_equal(lat[up], 0.0)
    np.testing.assert_array_equal(bw[~up], p.down_bw)
    np.testing.assert_array_equal(lat[~up], p.down_lat)
    assert (~up).any() and up.any()
    p = P.BurstyLossLink()
    bw, lat = P.LinkTrace(p, seed=1).values(0, 200)
    bad = bw < 1.0
    np.testing.assert_array_equal(bw[bad], p.bad_bw)
    np.testing.assert_array_equal(lat[bad], p.bad_lat)
    p = P.SatelliteLink()
    bw, lat = P.LinkTrace(p, seed=3).values(0, 200)
    np.testing.assert_array_equal(bw, p.bw)
    assert lat.std() > 0.0 and abs(lat.mean() - p.lat) < 5 * p.lat_jitter
    part = P.SatelliteLink(bw=0.8, lat=550.0, lat_jitter=0.0)
    bw, lat = P.LinkTrace(P.ComposedLink(parts=(part, part)), seed=0).values(0, 10)
    np.testing.assert_allclose(bw, 0.8 * 0.8)
    np.testing.assert_allclose(lat, 1100.0)
    bw, lat = P.LinkTrace(P.ComposedLink(parts=()), seed=0).values(0, 10)
    np.testing.assert_array_equal(bw, 1.0)
    np.testing.assert_array_equal(lat, 0.0)
    bw, lat = P.LinkTrace(P.IntermittentLink(), seed=0).values(5, 5)
    assert bw.size == 0 and lat.size == 0


@pytest.mark.parametrize("gap_frames", [1, 2, 3])
def test_handoff_gaps_are_well_formed(gap_frames):
    p = P.HandoffLink(period_frames=6, period_jitter=2, gap_frames=gap_frames)
    bw, lat = P.LinkTrace(p, seed=2).values(0, 400)
    gap = bw == p.gap_bw
    starts = np.flatnonzero(gap & ~np.r_[False, gap[:-1]])
    ends = np.flatnonzero(gap & ~np.r_[gap[1:], False]) + 1
    assert starts.size > 1
    np.testing.assert_array_equal((ends - starts)[:-1], gap_frames)
    connected = starts[1:] - ends[:-1]
    assert ((connected >= 4) & (connected <= 8)).all()
    np.testing.assert_array_equal(lat[gap], p.gap_lat)


@pytest.mark.parametrize("mtbf,mttr,seed", [(5.0, 2.0, 9), (1.0, 1.0, 0), (1e12, 3.0, 0),
                                            (4.0, 2.0, 1), (6.0, 3.0, 2_000_004)])
def test_outage_trace_matches_reference(mtbf, mttr, seed):
    ref = R.OutageTrace(mtbf, mttr, seed=seed)
    got = P.OutageTrace(mtbf, mttr, seed=seed)
    assert got.up(99) == ref.up(99)  # out of order, then in order
    assert [got.up(t) for t in range(100)] == [ref.up(t) for t in range(100)]
    if mtbf == 1.0:
        assert [got.up(t) for t in range(6)] == [False, True, False, True, False, True]
    if mtbf == 1e12:
        assert all(got.up(t) for t in range(100))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINES = {
    "links": dict(link_profiles=("IntermittentLink", "SatelliteLink"), seed=2),
    "half-amplitude": dict(link_profiles=("BurstyLossLink",), seed=5, amplitude=0.5),
    "amplitude-0": dict(link_profiles=("IntermittentLink", "SatelliteLink"), seed=3,
                        amplitude=0.0),
    "outages": dict(outage_mtbf_frames=6.0, outage_mttr_frames=3.0, outage_servers=(1, 3),
                    seed=0),
    "composite": dict(link_profiles=("IntermittentLink",), seed=0, outage_mtbf_frames=6.0,
                      outage_mttr_frames=3.0, outage_servers=(1,)),
    "out-of-range": dict(outage_mtbf_frames=1.0, outage_servers=(7, -1)),
    "ideal": dict(),
}


def engine(mod, kw, n_edge=3, n_servers=5):
    kw = dict(kw)
    kw["link_profiles"] = tuple(getattr(mod, n)() for n in kw.get("link_profiles", ()))
    return mod.ResilienceEngine(mod.ImpairmentConfig(enabled=True, **kw), n_edge, n_servers)


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_matches_reference(name):
    ref, got = engine(R, ENGINES[name]), engine(P, ENGINES[name])
    # the port pulls frames out of order; the reference in order
    for t in [17, 0, 3] + list(range(40)):
        for r, g in zip(ref.link_frame(t), got.link_frame(t)):
            assert g.dtype == np.float64 and g.shape == (5,)
            np.testing.assert_array_equal(g, r)
        up = got.server_up(t)
        assert up.dtype == np.float32
        np.testing.assert_array_equal(up, ref.server_up(t))
        rc, gc = ref.capacity_scale(t), got.capacity_scale(t)
        if rc is None:
            assert gc is None
        else:
            assert gc.dtype == np.float64
            np.testing.assert_array_equal(gc, rc)
    assert got.rcfg.has_outages == ref.rcfg.has_outages
    assert sorted(got._outages) == sorted(ref._outages)


def test_engine_properties():
    eng = engine(P, ENGINES["links"])
    for t in range(50):  # the cloud tier stays at identity
        scale, lat = eng.link_frame(t)
        np.testing.assert_array_equal(scale[3:], 1.0)
        np.testing.assert_array_equal(lat[3:], 0.0)
    for t in range(20):
        scale, lat = engine(P, ENGINES["amplitude-0"]).link_frame(t)
        np.testing.assert_array_equal(scale, 1.0)
        np.testing.assert_array_equal(lat, 0.0)
    assert [type(tr.profile) for tr in eng._traces] == [
        P.IntermittentLink, P.SatelliteLink, P.IntermittentLink]
    assert eng.capacity_scale(0) is None
    down = engine(P, dict(outage_mtbf_frames=1.0, outage_mttr_frames=1e12,
                          outage_servers=(1, 3)))
    np.testing.assert_array_equal(down.server_up(0), [1.0, 0.0, 1.0, 0.0, 1.0])
    assert engine(P, ENGINES["out-of-range"])._outages == {}


def test_config_defaults_match_reference():
    for cls in ("ImpairmentConfig", "AdmissionConfig"):
        ref = {f.name: f.default for f in dataclasses.fields(getattr(R, cls))}
        got = {f.name: f.default for f in dataclasses.fields(getattr(P, cls))}
        assert got == ref, cls
    assert math.isinf(P.AdmissionConfig().queue_cap_mult)
    assert not P.ImpairmentConfig().has_outages
    assert not P.ImpairmentConfig(outage_mtbf_frames=5.0).has_outages
    assert not P.ImpairmentConfig(outage_servers=(0,)).has_outages
    assert P.ImpairmentConfig(outage_mtbf_frames=5.0, outage_servers=(0,)).has_outages
    for name in ("LinkProfile", "IdealLink", "IntermittentLink", "BurstyLossLink",
                 "HandoffLink", "SatelliteLink", "ComposedLink", "LinkTrace", "OutageTrace",
                 "ImpairmentConfig", "AdmissionConfig", "ResilienceEngine",
                 "predicted_inflation", "admission_keep", "apply_queue_cap"):
        assert name in P.__all__ and getattr(P, name) is getattr(PI, name)
    assert PI.MIN_BW_SCALE == RI.MIN_BW_SCALE


# ---------------------------------------------------------------------------
# admission primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enabled", [False, True])
def test_predicted_inflation_matches_reference(enabled):
    rng = np.random.default_rng(0)
    g = rng.uniform(50.0, 150.0, 6).astype(np.float32)
    bg = rng.uniform(0.0, 400.0, 6).astype(np.float32)
    be = rng.uniform(0.0, 400.0, 6).astype(np.float32)
    ref = R.predicted_inflation(jnp.asarray(bg), jnp.asarray(be), jnp.asarray(g), jnp.asarray(g),
                                R.CongestionConfig(enabled=enabled))
    got = P.predicted_inflation(torch.from_numpy(bg), torch.from_numpy(be), torch.from_numpy(g),
                                torch.from_numpy(g), P.CongestionConfig(enabled=enabled))
    for r, x in zip(ref, got):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))
    if not enabled:
        assert (got[0] == 1.0).all() and (got[1] == 1.0).all()
    else:
        real = P.compute_inflation(torch.from_numpy(bg) + 100.0, torch.from_numpy(g), CC_P)
        assert (got[0] <= real).all()  # the pre-frame estimate is a lower bound


@pytest.mark.parametrize("seed", range(5))
def test_admission_keep_matches_reference(seed):
    M = TINY.n_edge + TINY.n_cloud
    inst = R.generate_instance(seed, TINY)
    rng = np.random.default_rng(seed)
    tq = rng.uniform(0.0, 500.0, TINY.n_requests).astype(np.float32)
    for phi in (np.ones(M, np.float32), (1.0 + rng.uniform(0.0, 2.0, M)).astype(np.float32)):
        ref = np.asarray(R.admission_keep(inst, jnp.asarray(tq), jnp.asarray(phi),
                                          jnp.asarray(phi)))
        got = P.admission_keep(port_inst(inst), torch.from_numpy(tq), torch.from_numpy(phi),
                               torch.from_numpy(phi))
        assert got.dtype == torch.bool and got.shape == (TINY.n_requests,)
        np.testing.assert_array_equal(got.numpy(), ref)
    # batched: a leading axis of frames gives each frame's mask
    pb = P.stack_instances([port_inst(R.generate_instance(s, TINY)) for s in (seed, seed + 9)])
    ones = torch.ones((2, M))
    keep = P.admission_keep(pb, torch.zeros((2, TINY.n_requests)), ones, ones)
    np.testing.assert_array_equal(keep.numpy(), P.hard_feasible(pb).flatten(-2).any(-1).numpy())


def test_admission_keep_sheds_only_hopeless_requests():
    inst = port_inst(R.generate_instance(3, TINY))
    served = P.gus_schedule(inst, device="cpu").j >= 0
    ones = torch.ones(TINY.n_edge + TINY.n_cloud)
    keep = P.admission_keep(inst, torch.zeros(TINY.n_requests), ones, ones)
    assert (keep | ~served).all()


def _cap_case(name):
    """``(inst, j, backlog_g, backlog_e, acfg kwargs)`` of the reference's
    queue-cap cases, as numpy."""
    M = TINY.n_edge + TINY.n_cloud
    inst = R.generate_instance(2 if name == "comm-side" else 0, TINY)
    j = np.array(R.gus_schedule(inst).j)
    zeros = np.zeros(M, np.float32)
    if name == "inf":
        return inst, j, np.array([1e9, 0.0, 5.0, 0.0], np.float32), zeros, {}
    if name == "inf-dead":
        inst = dataclasses.replace(inst, gamma=jnp.zeros_like(inst.gamma))
        return inst, np.zeros(TINY.n_requests, np.int32), zeros, zeros, {}
    if name == "over-backlog":
        bg = zeros.copy()
        target = int(j[j >= 0][0])
        bg[target] = 10.0 * float(np.asarray(inst.gamma)[target])
        return inst, j, bg, zeros, dict(queue_cap_mult=2.0)
    if name == "comm-side":
        cover = np.asarray(inst.cover)
        be = zeros.copy()
        be[int(cover[0])] = 10.0 * float(np.asarray(inst.eta)[int(cover[0])])
        off = np.full(TINY.n_requests, TINY.n_edge, np.int32)  # offloaded to the cloud
        return inst, np.where(np.arange(TINY.n_requests) % 2, cover, off).astype(np.int32), \
            zeros, be, dict(queue_cap_mult=1.0)
    if name == "finite-dead":
        inst = dataclasses.replace(inst, gamma=inst.gamma.at[0].set(0.0))
        return inst, np.zeros(TINY.n_requests, np.int32), zeros, zeros, dict(queue_cap_mult=3.0)
    assert name == "dropped"
    big = np.full(M, 1e9, np.float32)
    return inst, np.full(TINY.n_requests, -1, np.int32), big, big, dict(queue_cap_mult=0.5)


@pytest.mark.parametrize("name", ["inf", "inf-dead", "over-backlog", "comm-side",
                                  "finite-dead", "dropped"])
def test_apply_queue_cap_matches_reference(name):
    inst, j, bg, be, kw = _cap_case(name)
    ref = np.asarray(R.apply_queue_cap(jnp.asarray(j), inst, jnp.asarray(bg), jnp.asarray(be),
                                       R.AdmissionConfig(enabled=True, **kw)))
    got = P.apply_queue_cap(torch.from_numpy(j), port_inst(inst), torch.from_numpy(bg),
                            torch.from_numpy(be), P.AdmissionConfig(enabled=True, **kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if name in ("inf", "inf-dead"):  # inf * 0 is NaN, and nothing is refused
        np.testing.assert_array_equal(got.numpy(), j)
    if name == "finite-dead":
        assert (got == -1).all()
    if name == "comm-side":  # only offloaded requests of the over-cap edge go
        cover = np.asarray(inst.cover)
        refused = got.numpy() != j
        assert refused.any()
        assert (cover[refused] == cover[0]).all() and (j[refused] != cover[refused]).all()


def test_apply_queue_cap_batched_equals_per_frame():
    insts = [R.generate_instance(s, TINY) for s in range(3)]
    rng = np.random.default_rng(4)
    M = TINY.n_edge + TINY.n_cloud
    js = [np.array(R.gus_schedule(i).j) for i in insts]
    bg = rng.uniform(0.0, 8000.0, (3, M)).astype(np.float32)
    be = rng.uniform(0.0, 800.0, (3, M)).astype(np.float32)
    acfg = P.AdmissionConfig(enabled=True, queue_cap_mult=1.0)
    batch = P.stack_instances([port_inst(i) for i in insts])
    got = P.apply_queue_cap(torch.from_numpy(np.stack(js)), batch, torch.from_numpy(bg),
                            torch.from_numpy(be), acfg)
    for k, inst in enumerate(insts):
        one = P.apply_queue_cap(torch.from_numpy(js[k]), port_inst(inst),
                                torch.from_numpy(bg[k]), torch.from_numpy(be[k]), acfg)
        np.testing.assert_array_equal(got[k].numpy(), one.numpy())
