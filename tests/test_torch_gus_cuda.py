"""The Hopper GUS kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gus_cuda.py

Integer assignments and the request-order load sums must be equal, with no
mismatch allowed.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.kernels.gus import gus_assign, gus_assign_ref  # noqa: E402

pytestmark = pytest.mark.gpu

FIXTURES = sorted((Path(__file__).parent / "fixtures").glob("gus_golden_*.npz"))
FIELDS = tuple(f.name for f in dataclasses.fields(P.FlatInstance))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GUS kernel runs only on the card")
    return torch.device("cuda")


def _args(batch):
    B = batch.A.shape[0]
    return tuple(
        getattr(batch, f).expand(B).contiguous() if f in ("max_as", "max_cs")
        else getattr(batch, f).contiguous()
        for f in FIELDS
    )


def _assert_kernel_equals_plain(batch):
    got = gus_assign(*_args(batch))
    want = gus_assign_ref(*_args(batch))
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("j", "l", "w", "c")):
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_golden_frames(cuda, path):
    d = np.load(path)
    one = P.FlatInstance.from_numpy(d, cuda)
    batch = P.FlatInstance(**{f: getattr(one, f)[None] for f in FIELDS})
    j, l, _, _ = _assert_kernel_equals_plain(batch)
    np.testing.assert_array_equal(j[0].cpu().numpy(), d["exp_j"])
    np.testing.assert_array_equal(l[0].cpu().numpy(), d["exp_l"])


@pytest.mark.parametrize("relax", [None, "compute", "comm"])
def test_paper_batch(cuda, relax):
    batch = P.generate_batch(0, 256, device=cuda)
    kw = {} if relax is None else {f"relax_{relax}": True}
    a = P.gus_schedule_batch(batch, backend="cuda", device=cuda, **kw)
    b = P.gus_schedule_batch(batch, backend="torch", device=cuda, **kw)
    assert torch.equal(a.j, b.j) and torch.equal(a.l, b.l)
    assert torch.equal(a.loads[0], b.loads[0]) and torch.equal(a.loads[1], b.loads[1])


def test_empty_frames_do_not_launch(cuda):
    batch = P.generate_batch(0, 3, device=cuda)
    empty = dataclasses.replace(batch, **{
        f: getattr(batch, f)[:, :0] for f in ("cover", "A", "C", "w_a", "w_c",
                                              "acc", "ctime", "v", "u", "avail")
    })
    n0 = gus_assign.launches
    j, l, w, c = gus_assign(*_args(empty))
    assert tuple(j.shape) == (3, 0) and gus_assign.launches == n0
    assert not w.any() and not c.any()


def test_launch_counter_and_input_checks(cuda):
    batch = P.generate_batch(1, 4, device=cuda)
    n0 = gus_assign.launches
    _assert_kernel_equals_plain(batch)
    assert gus_assign.launches == n0 + 1
    args = list(_args(batch))
    args[1] = args[1].double()
    with pytest.raises(TypeError):
        gus_assign(*args)
    args = list(_args(batch))
    args[5] = args[5].transpose(1, 2)
    with pytest.raises(ValueError):
        gus_assign(*args)


def test_congested_fleet_equals_cpu(cuda):
    spec = P.demo_cluster_spec(n_edge=9, n_cloud=1, n_services=5, n_variants=10)
    cfg = P.SimConfig(horizon_ms=15_000.0, arrival_rate_per_s=6.0, delay_req_ms=6000.0,
                      acc_req_std=10.0,
                      congestion=P.CongestionConfig(enabled=True, drain=0.5))
    run = lambda dev: P.simulate_fleet(  # noqa: E731
        spec, cfg, n_rep=8, options=P.EngineOptions(rng_mode="vectorized"), device=dev,
    )
    g, c = run(cuda), run("cpu")
    assert g.n_served == c.n_served
    np.testing.assert_array_equal(g.satisfied_per_rep, c.satisfied_per_rep)
    np.testing.assert_array_equal(g.final_backlog_per_rep, c.final_backlog_per_rep)
    np.testing.assert_allclose(g.mean_us_per_rep, c.mean_us_per_rep, rtol=1e-5, atol=1e-6)
