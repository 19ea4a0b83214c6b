"""The Hopper class-allocator kernel against its plain PyTorch version, on
the card.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_hier_cuda.py

``take``/``start`` and the fixed-order committed loads must be equal, with
no mismatch allowed.  The kernel stages a frame's classes in tiles of
``TILE`` (16 at the default grid's M * L); the class grids below include
counts that are not a multiple of it and counts below one tile.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core.aggregation import class_batch  # noqa: E402
from repro_torch.kernels.hier import hier_cells, hier_cells_ref  # noqa: E402

pytestmark = pytest.mark.gpu

#: few requests, few services: duplicate rows once tiled (the grid keeps M = L = 10)
SMALL = P.GeneratorConfig(n_requests=24, n_services=6)
#: classes per staged tile (csrc/hier_cells.cu's MAX_TILE at the default grid)
TILE = 16
#: frames of at most 5 requests: fewer classes than one tile
TINY = P.GeneratorConfig(n_requests=5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the class-allocator kernel runs only on the card")
    return torch.device("cuda")


def _assert_kernel_equals_plain(args, loads=True):
    got = hier_cells(*args, backend="cuda", loads=loads)
    want = hier_cells_ref(*args, loads=loads)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("take", "start", "w", "c_load")):
        assert torch.equal(g, w), name
    return got


def _tiled(inst, k):
    """Every request repeated k times (duplicate classes)."""
    rows = ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")
    return dataclasses.replace(
        inst, **{f: getattr(inst, f).repeat_interleave(k, 0) for f in rows}
    )


@pytest.mark.parametrize("frames,pad_to,tiles", [
    ("default", None, None), ("default", 128, None), ("default", 4352, None),
    ("default", 8 * TILE + 5, "ragged"),  # a ragged last tile
    ("tiny", None, "below-one"),          # C below one tile
    ("tiny", TILE + 3, "ragged"),         # one full tile and a ragged one
])
def test_generated_class_grids(cuda, frames, pad_to, tiles):
    if frames == "tiny":
        insts = [P.generate_instance(s, TINY, device="cpu") for s in range(6)]
    else:
        insts = [P.generate_instance(s, device="cpu") for s in range(12)]
        insts += [_tiled(P.generate_instance(s, SMALL, device="cpu"), 5) for s in range(4)]
    args = class_batch(insts, pad_to=pad_to, device=cuda)
    C = args[0].shape[1]
    assert {"ragged": C > TILE and C % TILE != 0, "below-one": C < TILE, None: True}[tiles]
    take, _, w, _ = _assert_kernel_equals_plain(args)
    assert take.sum() > 0 and w.sum() > 0
    assert bool((take.sum((2, 3)) <= args[5]).all())  # never over-allocates


def _degenerate(us, feas, v, u, cover, count, gamma, eta, dev):
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)[None]  # noqa: E731
    i32 = lambda x: torch.tensor(np.asarray(x, np.int32), device=dev)[None]  # noqa: E731
    return (f32(us), torch.tensor(np.asarray(feas, bool), device=dev)[None], f32(v), f32(u),
            i32(cover), i32(count), f32(gamma), f32(eta))


def _tile_rows(args, k):
    """A degenerate frame's classes repeated k times (budgets unchanged):
    the same walk over more classes, e.g. past one staged tile."""
    return tuple(a.repeat_interleave(k, 1) if i < 6 else a for i, a in enumerate(args))


@pytest.mark.parametrize("reps", [1, 7], ids=["below-one-tile", "ragged-tiles"])
def test_degenerate_frames(cuda, reps):
    """Ties, infeasible and zero-count rows, exact-capacity chunks; each
    frame as it is (C below one tile) and its classes repeated 7 times (C
    = 21 or 28: a full tile and a ragged one)."""
    if reps > 1:
        _assert_kernel_equals_plain(_tile_rows(_degenerate(
            np.ones((3, 4, 2)), np.ones((3, 4, 2), bool), np.ones((3, 4, 2)),
            np.ones((3, 4, 2)), np.zeros(3), np.full(3, 2), np.full(4, 9.0), np.full(4, 9.0),
            cuda), reps))
        feas = np.ones((4, 3, 2), bool)
        feas[1] = False
        _assert_kernel_equals_plain(_tile_rows(_degenerate(
            np.random.default_rng(0).uniform(0, 1, (4, 3, 2)), feas, np.ones((4, 3, 2)),
            np.ones((4, 3, 2)), np.zeros(4), [3, 3, 0, 3], np.full(3, 20.0), np.full(3, 20.0),
            cuda), reps))
        return
    C, M, L = 3, 4, 2
    take, start, _, _ = _assert_kernel_equals_plain(_degenerate(
        np.ones((C, M, L)), np.ones((C, M, L), bool), np.ones((C, M, L)),
        np.ones((C, M, L)), np.zeros(C), np.full(C, 2), np.full(M, 1e6), np.full(M, 1e6), cuda,
    ))
    assert bool((take[0, :, 0, 0] == 2).all()) and int(take.sum()) == 6  # ties: cell (0, 0)
    feas = np.ones((4, 3, 2), bool)
    feas[1] = False
    take, _, _, _ = _assert_kernel_equals_plain(_degenerate(
        np.random.default_rng(0).uniform(0, 1, (4, 3, 2)), feas, np.ones((4, 3, 2)),
        np.ones((4, 3, 2)), np.zeros(4), [3, 3, 0, 3], np.full(3, 1e6), np.full(3, 1e6), cuda,
    ))
    assert int(take[0, 1].sum()) == 0 and int(take[0, 2].sum()) == 0
    us = np.array([[[1.0], [0.5]]])
    take, _, _, _ = _assert_kernel_equals_plain(_degenerate(
        us, [[[True], [False]]], np.ones((1, 2, 1)), np.zeros((1, 2, 1)),
        [0], [3], [2.0, 0.0], [1e6, 1e6], cuda,
    ))
    assert int(take[0, 0, 0, 0]) == 2 and int(take.sum()) == 2  # gamma fits exactly 2
    take, _, _, _ = _assert_kernel_equals_plain(_degenerate(
        us, [[[False], [True]]], np.ones((1, 2, 1)), np.ones((1, 2, 1)),
        [0], [3], [1e6, 1e6], [2.5, 1e6], cuda,
    ))
    assert int(take[0, 0, 1, 0]) == 2 and int(take.sum()) == 2  # eta fits floor(2.5)


@pytest.mark.parametrize("M,L", [(21, 10), (40, 3)], ids=["budgets-in-registers", "M>32"])
def test_random_grids_with_binding_budgets(cuda, M, L):
    """Random grids whose budgets run out part way (the per-server summary
    test both passes and fails), with ties; M <= 32 keeps the budgets in lane
    registers, M > 32 in shared memory."""
    rng = np.random.default_rng(M)
    B, C = 3, 45
    us = rng.uniform(0, 1, (B, C, M, L)).astype(np.float32)
    us[rng.random((B, C, M, L)) < 0.2] = 0.5
    t = lambda a, dt=np.float32: torch.tensor(np.asarray(a, dt), device=cuda)  # noqa: E731
    args = (t(us), t(rng.random((B, C, M, L)) < 0.4, bool), t(rng.uniform(0.5, 3, (B, C, M, L))),
            t(rng.uniform(0, 2, (B, C, M, L))), t(rng.integers(0, M, (B, C)), np.int32),
            t(rng.integers(-1, 9, (B, C)), np.int32), t(rng.uniform(5, 40, (B, M))),
            t(rng.uniform(2, 20, (B, M))))
    take, _, _, _ = _assert_kernel_equals_plain(args)
    assert 0 < int(take.sum()) < int(args[5].clamp_min(0).sum())  # the budgets bind


def test_row_too_wide_for_shared_memory_raises(cuda):
    """A class row of M * L cells that leaves no room for one class per
    stage is refused at launch, with no launch counted."""
    B, C, M, L = 1, 2, 64, 80
    f = torch.zeros((B, C, M, L), device=cuda)
    i = torch.ones((B, C), dtype=torch.int32, device=cuda)
    n0 = hier_cells.launches
    with pytest.raises(RuntimeError, match="does not fit shared memory"):
        hier_cells(f, f > 0, f, f, i * 0, i, torch.ones((B, M), device=cuda),
                   torch.ones((B, M), device=cuda), backend="cuda")
    assert hier_cells.launches == n0


def test_launch_counter_and_input_checks(cuda):
    args = class_batch([P.generate_instance(s, device="cpu") for s in range(3)], device=cuda)
    n0 = hier_cells.launches
    _assert_kernel_equals_plain(args, loads=False)
    assert hier_cells.launches == n0 + 1
    hier_cells_ref(*args)
    hier_cells(*args, backend="torch")
    assert hier_cells.launches == n0 + 1
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        hier_cells(*bad, backend="cuda")
    bad = list(args)
    bad[2] = bad[2].transpose(2, 3)
    with pytest.raises(ValueError):
        hier_cells(*bad, backend="cuda")


@pytest.mark.parametrize("congestion", [{}, dict(enabled=True, drain=0.5)])
def test_hier_fleet_equals_cpu(cuda, congestion):
    spec = P.demo_cluster_spec(n_edge=6, n_cloud=1, n_services=5, n_variants=10)
    scn = dataclasses.replace(P.get_scenario("mega-city"), rate_per_edge_per_s=60.0)
    cfg = P.SimConfig(horizon_ms=9000.0, congestion=P.CongestionConfig(**congestion))
    run = lambda dev: P.simulate_fleet(  # noqa: E731
        spec, cfg, scenario=scn, n_rep=4, device=dev,
        options=P.EngineOptions(scheduler="hierarchical", window=1),
    )
    n0 = hier_cells.launches
    g = run(cuda)
    assert hier_cells.launches > n0
    c = run("cpu")
    assert (g.n_requests, g.n_served) == (c.n_requests, c.n_served)
    np.testing.assert_array_equal(g.satisfied_per_rep, c.satisfied_per_rep)
    np.testing.assert_array_equal(g.mean_us_per_rep, c.mean_us_per_rep)
    assert g.mean_compute_inflation == c.mean_compute_inflation
    if congestion:
        np.testing.assert_array_equal(g.final_backlog_per_rep, c.final_backlog_per_rep)
        assert g.final_backlog_per_rep.sum() > 0
