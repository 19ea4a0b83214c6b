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


def _random_batch(dev, B, N, M, L, seed, **kw):
    """B frames of random rows (numpy, from ``seed``): feasible cells with
    random utilities and costs, budgets that run out part way."""
    rng = np.random.default_rng(seed)
    f = {
        "cover": rng.integers(0, M, (B, N)).astype(np.int32),
        "A": rng.uniform(20, 60, (B, N)), "C": rng.uniform(500, 3000, (B, N)),
        "w_a": rng.uniform(0.5, 1.5, (B, N)), "w_c": rng.uniform(0.5, 1.5, (B, N)),
        "acc": rng.uniform(10, 100, (B, N, M, L)), "ctime": rng.uniform(100, 4000, (B, N, M, L)),
        "v": rng.uniform(0.5, 3, (B, N, M, L)), "u": rng.uniform(0, 2, (B, N, M, L)),
        "avail": rng.random((B, N, M, L)) < 0.7,
        "gamma": rng.uniform(0.2, 1.0, (B, M)) * N + 3, "eta": rng.uniform(0.1, 0.6, (B, M)) * N + 2,
        "max_as": np.full(B, 100.0), "max_cs": np.full(B, 4000.0),
    }
    f.update(kw)
    return tuple(
        torch.tensor(np.asarray(f[k]), dtype=torch.bool if k == "avail" else
                     torch.int32 if k == "cover" else torch.float32, device=dev)
        for k in FIELDS
    )


def _assert_args_equal(args):
    got = gus_assign(*args)
    want = gus_assign_ref(*args)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("j", "l", "w", "c")):
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("N", [1, 7, 257])
@pytest.mark.parametrize("M,L", [(10, 10), (3, 7), (40, 3)])
def test_ragged_shapes(cuda, N, M, L):
    """Request counts that are no multiple of the kernel's tile, rows of
    M * L = 21 cells, whose avail bytes start unaligned at every row, and
    M = 40 servers, whose budgets live in shared memory."""
    j, _, _, _ = _assert_args_equal(_random_batch(cuda, 9, N, M, L, seed=N * 100 + L))
    assert bool((j >= 0).any())


@pytest.mark.parametrize("M,L", [(16, 256), (256, 16)])
def test_row_at_the_width_limit(cuda, M, L):
    """A row of exactly MAX_CELLS cells launches (budgets in registers and in
    shared memory) and equals the plain version."""
    from repro_torch.kernels.gus import MAX_CELLS

    assert M * L == MAX_CELLS
    n0 = gus_assign.launches
    _assert_args_equal(_random_batch(cuda, 2, 5, M, L, seed=M))
    assert gus_assign.launches == n0 + 1


@pytest.mark.parametrize("M,L", [(17, 241), (1025, 1)])
def test_row_above_the_width_limit_raises_before_launch(cuda, M, L):
    from repro_torch.kernels.gus import MAX_CELLS, MAX_SERVERS

    assert M * L > MAX_CELLS or M > MAX_SERVERS
    args = _random_batch(cuda, 1, 2, M, L, seed=0)
    n0 = gus_assign.launches
    with pytest.raises(RuntimeError, match="wider than the kernel takes"):
        gus_assign(*args)
    assert gus_assign.launches == n0


def test_single_frame(cuda):
    """B = 1: the sequential simulator's launch shape."""
    batch = P.generate_batch(3, 1, device=cuda)
    _assert_kernel_equals_plain(batch)


def test_spent_budgets(cuda):
    """Every budget 0: nothing with a cost fits, every request is dropped
    (a free candidate, v = u = 0, would still fit)."""
    batch = P.generate_batch(4, 64, device=cuda)
    args = list(_args(batch))
    args[10], args[11] = torch.zeros_like(args[10]), torch.zeros_like(args[11])
    j, _, w, c = _assert_args_equal(tuple(args))
    assert bool((j == -1).all()) and not w.any() and not c.any()
