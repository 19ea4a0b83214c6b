"""The port's metric streams and profiler hooks on the card.

Every test here needs a CUDA device (and ``nvcc`` for the kernels); without
one they skip with that reason (the kernels have no CPU mode).  On a GPU
machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_telemetry_cuda.py

The card's metric rows must equal the CPU's (integers exactly, the dense
fleet's floats within ``rtol=1e-5, atol=1e-6``), metrics on must change no
result field and no launch count, and a ``torch.profiler`` trace of a
fleet window must hold the GUS kernel and the window's step annotation.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.kernels.gus import gus_assign  # noqa: E402
from repro_torch.kernels.hier import hier_cells  # noqa: E402
from repro_torch.obs import MetricsFrame, profile_trace  # noqa: E402
from repro_torch.obs.profiler import TRACE_FILE  # noqa: E402

pytestmark = pytest.mark.gpu

INTS = ("n_arrivals", "n_served", "n_satisfied", "n_shed", "n_refused", "tier_hist", "qos_sat",
        "qos_count")
SPEC = P.demo_cluster_spec()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GUS and class-allocator kernels run only on the card")
    return torch.device("cuda")


def cfg(congestion=False, impaired=False):
    imp = P.ImpairmentConfig()
    if impaired:
        imp = P.ImpairmentConfig(enabled=True, link_profiles=(P.IntermittentLink(),), seed=3,
                                 outage_mtbf_frames=6.0, outage_mttr_frames=3.0,
                                 outage_servers=(1,))
    return P.SimConfig(horizon_ms=9000.0, arrival_rate_per_s=4.0, delay_req_ms=3000.0,
                       acc_req_mean=50.0, acc_req_std=10.0,
                       congestion=P.CongestionConfig(enabled=congestion, drain=0.5),
                       admission=P.AdmissionConfig(enabled=True, shed=True, queue_cap_mult=2.0),
                       impairments=imp)


def fleet(c, device, metrics=True, **opts):
    return P.simulate_fleet(SPEC, c, n_rep=4, seed=7, device=device,
                            options=P.EngineOptions(metrics=metrics, **opts))


def assert_rows_equal(gpu, cpu, exact_floats=False):
    for f in MetricsFrame._fields:
        a, b = cpu.metrics.data[f], gpu.metrics.data[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in INTS or exact_floats:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("policy", ["gus", "random", "gus-adaptive"])
@pytest.mark.parametrize("congestion,impaired", [(False, False), (True, False), (True, True)])
def test_dense_rows_on_the_card_equal_the_cpu(cuda, policy, congestion, impaired):
    c = cfg(congestion, impaired)
    gus_assign.launches = 0
    off = P.simulate_fleet(SPEC, c, policy=policy, n_rep=4, seed=7, device=cuda)
    n_off = gus_assign.launches
    gus_assign.launches = 0
    on = P.simulate_fleet(SPEC, c, policy=policy, n_rep=4, seed=7, device=cuda,
                          options=P.EngineOptions(metrics=True))
    assert gus_assign.launches == n_off  # metrics change no launch count
    assert on.n_served == off.n_served
    np.testing.assert_array_equal(on.satisfied_per_rep, off.satisfied_per_rep)
    np.testing.assert_array_equal(on.mean_us_per_rep, off.mean_us_per_rep)
    cpu = P.simulate_fleet(SPEC, c, policy=policy, n_rep=4, seed=7, device="cpu",
                           options=P.EngineOptions(metrics=True))
    assert_rows_equal(on, cpu)
    agg = on.metrics.aggregate()
    assert agg["n_arrivals"] == on.n_requests and agg["n_served"] == on.n_served


def test_one_launch_per_window_with_metrics(cuda):
    gus_assign.launches = 0
    fr = fleet(cfg(), cuda, window=3)
    assert gus_assign.launches == -(-fr.n_frames // 3)


@pytest.mark.parametrize("congestion", [False, True])
def test_simulate_and_hier_rows_on_the_card_equal_the_cpu(cuda, congestion):
    c = cfg(congestion, impaired=True)
    opts = P.EngineOptions(metrics=True)
    g = P.simulate(SPEC, c, seed=5, device=cuda, options=opts)
    h = P.simulate(SPEC, c, seed=5, device="cpu", options=opts)
    assert_rows_equal(g, h, exact_floats=True)
    hopts = P.EngineOptions(metrics=True, scheduler="hierarchical", window=1, prefetch=2)
    hier_cells.launches = 0
    g = P.simulate_fleet(SPEC, c, n_rep=4, seed=3, scenario="flash-crowd", device=cuda,
                         options=hopts)
    assert hier_cells.launches == g.n_frames
    h = P.simulate_fleet(SPEC, c, n_rep=4, seed=3, scenario="flash-crowd", device="cpu",
                         options=hopts)
    assert_rows_equal(g, h, exact_floats=True)


def test_profiler_trace_holds_the_kernel_and_the_window(cuda, tmp_path):
    fleet(cfg(), cuda, metrics=False)  # build and load the kernel first
    with profile_trace(tmp_path, device=cuda):
        fleet(cfg(), cuda, metrics=False)
    obj = json.loads((tmp_path / TRACE_FILE).read_text())
    names = [e.get("name", "") for e in obj["traceEvents"]]
    kernels = [e for e in obj["traceEvents"]
               if e.get("cat") == "kernel" and "gus_assign" in e.get("name", "")]
    assert kernels, "no gus_assign kernel event in the profiler trace"
    assert any(n.startswith("fleet/window#") for n in names)
    assert any(n == "gus/cuda_kernel_batch" for n in names)
