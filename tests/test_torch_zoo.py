"""The port's analytic profiles and model zoo against the JAX reference.

``variant_ladder``, ``accuracy_proxy``, ``step_costs`` and
``request_latency_ms`` for every configuration of the port's registry, and
``build_cluster_spec`` for the zoos of ``benchmarks/fig1_testbed.py`` and
``examples/schedule_cluster.py``, must equal the reference's exactly (the
same float64 Python arithmetic and numpy calls, so no tolerance); one
``simulate`` on the testbed spec must give the reference's ``as_dict()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.serving.profiles as RP  # noqa: E402
import repro.serving.zoo as RZ  # noqa: E402

import repro_torch.configs as PC  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.serving as PS  # noqa: E402

ARCHS = sorted(PC.REGISTRY)
SPEC_FIELDS = ("n_edge", "n_cloud", "gamma_frame", "eta_frame", "proc_ms", "placed", "acc",
               "bandwidth_true", "cloud_extra_delay")


def test_hardware_classes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in PS.HW_CLASSES.items()} == {
        k: dataclasses.asdict(v) for k, v in RP.HW_CLASSES.items()}
    assert set(PS.__all__) >= {"HardwareClass", "HW_CLASSES", "step_costs",
                               "request_latency_ms", "accuracy_proxy", "ServiceSpec",
                               "ModelZoo", "variant_ladder", "build_cluster_spec"}


@pytest.mark.parametrize("arch", ARCHS)
def test_profiles_and_ladder_match_reference(arch):
    ref_base, got_base = RC.get_config(arch), PC.get_config(arch)
    ref_ladder = RZ.variant_ladder(ref_base, 4)
    got_ladder = PS.variant_ladder(got_base, 4)
    assert [dataclasses.asdict(v) for v in got_ladder] == [
        dataclasses.asdict(v) for v in ref_ladder]
    for rv, gv in zip([ref_base] + ref_ladder, [got_base] + got_ladder):
        assert gv.n_params() == rv.n_params()
        assert PS.accuracy_proxy(gv.n_params()) == RP.accuracy_proxy(rv.n_params())
        for mode in ("prefill", "decode"):
            for batch, seq in ((1, 128), (8, 2048)):
                assert PS.step_costs(gv, batch, seq, mode) == RP.step_costs(rv, batch, seq, mode)
        for hw in PS.HW_CLASSES:
            for kw in ({}, dict(prompt_tokens=512, gen_tokens=64, batch=2, efficiency=0.3)):
                assert PS.request_latency_ms(gv, PS.HW_CLASSES[hw], **kw) == \
                    RP.request_latency_ms(rv, RP.HW_CLASSES[hw], **kw)


def fig1_zoo(cfgs, serving):
    """``benchmarks/fig1_testbed.py``'s zoo."""
    return serving.ModelZoo([
        serving.ServiceSpec("imgcls-a", [cfgs.SQUEEZE_LM, cfgs.MID_LM, cfgs.GOOGLE_LM]),
        serving.ServiceSpec("imgcls-b", [cfgs.SQUEEZE_LM, cfgs.MID_LM, cfgs.GOOGLE_LM]),
        serving.ServiceSpec("summarize",
                            serving.variant_ladder(cfgs.get_config("mamba2-130m"), 3)),
    ])


def fig1_spec(cfgs, serving, seed=0):
    """``benchmarks/fig1_testbed.py::make_testbed_spec``: two edges and one
    cloud, T^proc calibrated to the paper's testbed measurements."""
    spec = serving.build_cluster_spec(
        fig1_zoo(cfgs, serving), edge_classes=["edge-1", "edge-1"],
        cloud_classes=["cloud-256"], edge_variants=2, edge_service_frac=1.0, seed=seed)
    spec.proc_ms[: spec.n_edge] *= 1300.0 / max(spec.proc_ms[0][spec.placed[0]].max(), 1e-9)
    cl = spec.n_edge
    spec.proc_ms[cl:] *= 300.0 / max(spec.proc_ms[cl][spec.placed[cl]].max(), 1e-9)
    return spec


def schedule_cluster_spec(cfgs, serving):
    """``examples/schedule_cluster.py``'s cluster: every arch of the
    registry, 4 variants each."""
    zoo = serving.ModelZoo([serving.ServiceSpec(a, serving.variant_ladder(cfgs.get_config(a), 4))
                            for a in cfgs.ARCH_IDS])
    return serving.build_cluster_spec(
        zoo, edge_classes=["edge-1", "edge-4", "edge-4", "edge-8"],
        cloud_classes=["cloud-256"], edge_variants=3, edge_service_frac=0.7,
        prompt_tokens=512, gen_tokens=64, seed=0)


def assert_spec_equal(ref, got):
    assert type(got) is P.ClusterSpec
    for f in SPEC_FIELDS:
        r, g = getattr(ref, f), getattr(got, f)
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, f
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            assert g == r, f


@pytest.mark.parametrize("seed", [0, 3])
def test_testbed_spec_matches_reference(seed):
    assert_spec_equal(fig1_spec(RC, RZ, seed), fig1_spec(PC, PS, seed))


def test_schedule_cluster_spec_matches_reference():
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert_spec_equal(schedule_cluster_spec(RC, RZ), schedule_cluster_spec(PC, PS))


def test_measured_latencies_and_budgets_override():
    kw = dict(edge_classes=["edge-1", "edge-8"], cloud_classes=["cloud-256"],
              gamma_frame=np.array([100.0, 200.0, 300.0]), eta_frame=np.array([1.0, 2.0, 3.0]),
              measured_proc={(0, 0, 0): 12.5, (2, 1, 2): 7.0}, edge_service_frac=1.0, seed=5)
    ref = RZ.build_cluster_spec(fig1_zoo(RC, RZ), **kw)
    got = PS.build_cluster_spec(fig1_zoo(PC, PS), **kw)
    assert_spec_equal(ref, got)
    assert got.proc_ms[0, 0, 0] == np.float32(12.5)
    svc = PS.ServiceSpec("measured", [PC.SQUEEZE_LM], accuracy=[61.0])
    assert svc.accuracies() == RZ.ServiceSpec("measured", [RC.SQUEEZE_LM],
                                              accuracy=[61.0]).accuracies()


def test_simulate_on_the_fig1_spec():
    """The Fig. 1 testbed's cluster drives the port's sequential testbed to
    the reference's result."""
    cfg = dict(horizon_ms=30_000.0, arrival_rate_per_s=2.0, delay_req_ms=6000.0,
               acc_req_mean=50.0, acc_req_std=10.0)
    ref = R.simulate(fig1_spec(RC, RZ), R.SimConfig(**cfg), seed=0)
    got = P.simulate(fig1_spec(PC, PS), P.SimConfig(**cfg), seed=0, device="cpu")
    assert got.as_dict() == ref.as_dict()
    assert got.bandwidth_estimates == ref.bandwidth_estimates
    assert got.n_served > 0
