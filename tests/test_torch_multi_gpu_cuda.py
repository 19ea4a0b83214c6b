"""The model kernels and the fleet on a second card, on a machine with two
or more.

Every test here needs two CUDA devices and ``nvcc``; with fewer they skip
with that reason.  On such a machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_multi_gpu_cuda.py

The dynamic shared-memory opt-in (``cudaFuncSetAttribute``) holds for a
kernel as loaded on the current device only, so a launcher that granted it
once per process would launch without it on the second card and fail.  The
three launchers that need more than 48 KB (``flash_attention_wgmma.cu``,
``ssd_scan_wgmma.cu``, ``decode_attention.cu``) grant it, and read the
limit, on every launch.  Each case launches on ``cuda:0``, then on
``cuda:1``, then on both from two threads at once, and holds every result
against the plain version at ``tests/test_torch_attention_cuda.py``'s and
``tests/test_torch_ssd_cuda.py``'s bf16 tolerance.  The fleet over two
cards equals the fleet on one, bit for bit.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref  # noqa: E402
from repro_torch.obs import counters  # noqa: E402

pytestmark = pytest.mark.gpu

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the kernels' per-device opt-in and the fleet "
                    "over several cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _randn(shape, dev, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32).to(dev, dtype)


def _cases(dev):
    """(name, kernel call, plain call) at yi-9b's and mamba2-130m's shapes,
    each above 48 KB of shared memory."""
    q = _randn((2, 32, 256, 128), dev, 1)
    k, v = _randn((2, 4, 256, 128), dev, 2), _randn((2, 4, 256, 128), dev, 3)
    qd = _randn((2, 4, 8, 128), dev, 4)
    kd, vd = _randn((2, 4, 1088, 128), dev, 5), _randn((2, 4, 1088, 128), dev, 6)
    valid = torch.ones((2, 1088), dtype=torch.bool, device=dev)
    x, dt = _randn((2, 24, 300, 64), dev, 7), _randn((2, 24, 300), dev, 8).abs() * 0.1
    A = -torch.rand(24, generator=torch.Generator().manual_seed(9)).to(dev)
    Bm, Cm = _randn((2, 1, 300, 128), dev, 10), _randn((2, 1, 300, 128), dev, 11)
    return [
        ("flash", lambda: flash_attention(q, k, v, causal=True, backend="cuda"),
         lambda: flash_attention_ref(q, k, v, causal=True)),
        ("decode", lambda: decode_attention(qd, kd, vd, valid, backend="cuda"),
         lambda: decode_attention_ref(qd, kd, vd, valid)),
        ("ssd", lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=128, backend="cuda"),
         lambda: ssd_scan_ref(x, dt, A, Bm, Cm, 128)),
    ]


def _check(dev):
    with torch.cuda.device(dev), torch.no_grad():
        for name, kern, plain in _cases(dev):
            got = kern()
            torch.cuda.synchronize(dev)
            torch.testing.assert_close(got.float(), plain().float(), **BF16_TOL,
                                       msg=lambda m, n=name, d=dev: f"{n} on {d}: {m}")


def test_model_kernels_on_the_second_card_after_the_first(two_cards):
    before = counters.snapshot()
    for dev in two_cards:
        _check(dev)
    assert [counters.launches(k, before)
            for k in ("flash_attention", "decode_attention", "ssd")] == [2, 2, 2]


def test_model_kernels_from_two_threads_on_two_cards(two_cards):
    errors = []

    def run(dev):
        try:
            for _ in range(3):
                _check(dev)
        except BaseException as e:  # reported below, with the device
            errors.append((dev, e))

    threads = [threading.Thread(target=run, args=(d,)) for d in two_cards]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


@pytest.mark.parametrize("scheduler", ["dense", "hierarchical"])
def test_fleet_over_two_cards_equals_one(two_cards, scheduler):
    spec = P.demo_cluster_spec()
    cfg = P.SimConfig(horizon_ms=12_000.0, arrival_rate_per_s=4.0, delay_req_ms=6000.0,
                      acc_req_mean=50.0, acc_req_std=10.0,
                      congestion=P.CongestionConfig(enabled=True, drain=0.5))

    def run(devices, rep_group=None):
        return P.simulate_fleet(spec, cfg, n_rep=9, seed=0, device="cuda:0",
                                options=P.EngineOptions(devices=devices, rep_group=rep_group,
                                                        scheduler=scheduler))

    one = run(1)
    for two in (run(2), run(2, rep_group=2)):
        assert two.n_devices == 2
        assert (two.n_requests, two.n_served) == (one.n_requests, one.n_served)
        for f in ("satisfied_per_rep", "mean_us_per_rep", "final_backlog_per_rep"):
            np.testing.assert_array_equal(getattr(two, f), getattr(one, f), err_msg=f)
        assert two.mean_compute_inflation == one.mean_compute_inflation
