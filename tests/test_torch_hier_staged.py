"""The staged class allocator's walk, in plain form, against the reference
on the CPU.

``csrc/hier_cells.cu`` runs only on the card, and its walk differs in form
from the reference's: before a class's first step it tests a per-server
summary (the smallest v and the smallest u among the server's usable cells,
usable meaning feas && us > NEG) against the budgets and ends the class
when no server passes; and its argmax compares scores as ordered unsigned
keys (sign-flipped bits, -0 folded onto +0), taking the largest key and
then the lowest flat index that holds it.  :func:`staged_walk` is that walk
written out in numpy, float32 op for op.  It must equal ``hier_cells_ref``
(the port's plain version) and the reference's NumPy oracle
``hier_cells_np`` exactly, on generated frames and on adversarial ones:
equal scores, -0 against +0, a cell exactly at its budget, v = 0 or u = 0,
a feasible cell whose score is <= NEG, zero-count rows, all-infeasible
classes, and a re-pick of the same cell.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro.core.aggregation as RA  # noqa: E402

from repro_torch.kernels.hier import NEG, hier_cells_ref  # noqa: E402

f32 = np.float32
SMALL = R.GeneratorConfig(n_requests=24, n_edge=4, n_cloud=1, n_services=6, n_variants=4)


def score_keys(us):
    """Ordered uint32 keys of float32 scores: a > b iff key(a) > key(b), and
    -0 and +0 share a key."""
    bits = np.ascontiguousarray(us, np.float32).view(np.uint32).copy()
    bits[(bits << np.uint32(1)) == 0] = 0
    neg = (bits & np.uint32(0x80000000)) != 0
    return np.where(neg, ~bits, bits | np.uint32(0x80000000)).astype(np.uint32)


def staged_walk(us, feas, v, u, cover, count, gamma, eta):
    """One frame: (C, M, L) cells, (C,) cover/count, (M,) budgets -> int32
    (take, start), as the kernel walks it."""
    C, M, L = us.shape
    gamma, eta = gamma.astype(f32).copy(), eta.astype(f32).copy()
    take = np.zeros((C, M, L), np.int32)
    start = np.zeros((C, M, L), np.int32)
    servers = np.arange(M)[:, None]
    for c in range(C):
        if count[c] <= 0:
            continue
        s = int(cover[c])
        usable = feas[c] & (us[c] > f32(NEG))
        vmin = np.where(usable, v[c], np.inf).min(1)
        umin = np.where(usable, u[c], np.inf).min(1)
        if not ((vmin <= gamma) & ((np.arange(M) == s) | (umin <= eta[s]))).any():
            continue  # the summary test: nobody of this class can be placed
        keys = score_keys(us[c])
        rem, used = int(count[c]), 0
        while True:
            ok = usable & (v[c] <= gamma[:, None]) & ((servers == s) | (u[c] <= eta[s]))
            k = np.where(ok, keys, np.uint32(0)).reshape(-1)
            top = k.max()
            if top == 0:
                break
            flat = int(np.flatnonzero(k == top)[0])  # the lowest flat holding it
            j, l = divmod(flat, L)
            vv, uv = v[c, j, l], u[c, j, l]
            rem_f = f32(rem)
            cap_g = np.floor(f32(gamma[j] / vv)) if vv > 0 else rem_f
            cap_e = np.floor(f32(eta[s] / uv)) if (j != s and uv > 0) else rem_f
            t = int(min(rem_f, min(cap_g, cap_e)))
            if t < 1:
                break
            tf = f32(t)
            gamma[j] = f32(gamma[j] + f32(-f32(tf * vv)))
            if j != s:
                eta[s] = f32(eta[s] + f32(-f32(tf * uv)))
            if take[c, j, l] == 0:
                start[c, j, l] = used
            take[c, j, l] += t
            used += t
            rem -= t
            if rem <= 0:
                break
    return take, start


def class_args(inst, pad_to=None):
    """The reference's sorted (and zero-count padded) class grid of a frame."""
    agg = RA.aggregate_instance(inst)
    o = np.argsort(agg.first_idx, kind="stable")
    arrs = [agg.us[o], agg.feas[o], agg.v[o], agg.u[o],
            agg.cover[o].astype(np.int32), agg.count[o].astype(np.int32)]
    if pad_to is not None and pad_to > arrs[0].shape[0]:
        pad = pad_to - arrs[0].shape[0]
        arrs = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrs]
    return tuple(arrs) + (np.asarray(inst.gamma, np.float32), np.asarray(inst.eta, np.float32))


def frame(us, feas, v, u, cover, count, gamma, eta):
    return (np.asarray(us, f32), np.asarray(feas, bool), np.asarray(v, f32), np.asarray(u, f32),
            np.asarray(cover, np.int32), np.asarray(count, np.int32), np.asarray(gamma, f32),
            np.asarray(eta, f32))


def assert_walks_agree(args, label):
    take, start = staged_walk(*args)
    t_ref, s_ref = hier_cells_ref(*(torch.from_numpy(np.ascontiguousarray(a))[None]
                                    for a in args))
    t_np, s_np = RA.hier_cells_np(*args)
    for name, (t, s) in {"hier_cells_ref": (t_ref[0].numpy(), s_ref[0].numpy()),
                         "hier_cells_np": (np.asarray(t_np), np.asarray(s_np))}.items():
        np.testing.assert_array_equal(take, t, err_msg=f"{label}: take vs {name}")
        np.testing.assert_array_equal(start, s, err_msg=f"{label}: start vs {name}")
    return take, start


@pytest.mark.parametrize("seed,kind", [(0, "default"), (1, "default"), (2, "small x5"),
                                       (3, "small x5, padded")])
def test_generated_frames(seed, kind):
    if kind == "default":
        inst = R.generate_instance(seed, as_numpy=True)
        args = class_args(inst)
    else:
        inst = R.generate_instance(seed, SMALL, as_numpy=True)
        rows = ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")
        inst = dataclasses.replace(
            inst, **{f: np.repeat(np.asarray(getattr(inst, f)), 5, axis=0) for f in rows})
        args = class_args(inst, 37 if "padded" in kind else None)
    take, _ = assert_walks_agree(args, f"seed={seed} {kind}")
    assert take.sum() > 0


def test_random_tight_budgets():
    """Random grids whose budgets run out part way, so the summary test both
    passes and fails, over many classes and servers (M > 32 included)."""
    rng = np.random.default_rng(7)
    for C, M, L in ((40, 21, 10), (25, 40, 3), (30, 5, 7)):
        us = rng.uniform(0, 1, (C, M, L)).astype(f32)
        us[rng.random((C, M, L)) < 0.2] = 0.5  # equal scores
        args = frame(us, rng.random((C, M, L)) < 0.6, rng.uniform(0.5, 3, (C, M, L)),
                     rng.uniform(0, 2, (C, M, L)), rng.integers(0, M, C),
                     rng.integers(-1, 9, C), rng.uniform(2, 30, M), rng.uniform(1, 15, M))
        take, _ = assert_walks_agree(args, f"random C={C} M={M} L={L}")
        assert 0 < take.sum() < args[5].clip(0).sum()  # the budgets bind


def test_equal_scores_and_signed_zeros():
    C, M, L = 3, 4, 2
    us = np.ones((C, M, L), f32)
    us[1] = 0.0
    us[1, 0, 0] = -0.0  # equal to +0: the lowest flat, (0, 0), still wins
    take, start = assert_walks_agree(frame(
        us, np.ones((C, M, L), bool), np.ones((C, M, L)), np.ones((C, M, L)), np.zeros(C),
        np.full(C, 2), np.full(M, 1e6), np.full(M, 1e6)), "ties")
    assert np.all(take[:, 0, 0] == 2) and take.sum() == 6 and not start.any()


def test_cell_exactly_at_its_budget_and_free_costs():
    # v == gamma[j]: fits once; u == eta[s] on an offloaded cell: fits once
    take, _ = assert_walks_agree(frame(
        [[[1.0], [0.5]]], [[[True], [True]]], [[[2.0], [1.0]]], [[[0.0], [3.0]]],
        [0], [5], [2.0, 1.0], [3.0, 9.0]), "at budget")
    assert int(take[0, 0, 0]) == 1 and int(take[0, 1, 0]) == 1
    # v = 0 (compute-free) and u = 0 (uplink-free offload): the remainder bounds them
    take, _ = assert_walks_agree(frame(
        [[[1.0], [0.9]], [[0.2], [0.8]]], np.ones((2, 2, 1), bool),
        [[[0.0], [1.0]], [[1.0], [1.0]]], [[[0.0], [0.0]], [[0.0], [0.0]]],
        [0, 0], [4, 3], [0.0, 2.0], [0.0, 0.0]), "free costs")
    assert int(take[0, 0, 0]) == 4 and int(take[1, 1, 0]) == 2


def test_unusable_cells_zero_counts_and_infeasible_classes():
    C, M, L = 5, 3, 2
    rng = np.random.default_rng(0)
    us = rng.uniform(0, 1, (C, M, L)).astype(f32)
    us[0, 0, :] = NEG     # feasible but scored at the sentinel: never picked
    us[0, 1, 0] = -np.inf
    feas = np.ones((C, M, L), bool)
    feas[2] = False       # an all-infeasible class
    take, _ = assert_walks_agree(frame(
        us, feas, np.ones((C, M, L)), np.ones((C, M, L)), np.zeros(C), [3, 0, 3, -1, 3],
        np.full(M, 1e6), np.full(M, 1e6)), "unusable")
    assert take[0, 0].sum() == 0 and take[0, 1, 0] == 0
    assert take[1].sum() == 0 and take[2].sum() == 0 and take[3].sum() == 0


def test_repick_of_the_same_cell():
    """floor(gamma / v) undercounts here (float32): after the first chunk the
    cell still fits, so the next step picks it again and its take grows."""
    v, g = f32(1.335636019706726), f32(56122044.0)
    t1 = int(np.floor(f32(g / v)))
    assert f32(g + f32(-f32(f32(t1) * v))) >= v  # the float edge this test needs
    take, start = assert_walks_agree(frame(
        [[[1.0], [0.5]]], [[[True], [True]]], [[[v], [1.0]]], [[[0.0], [1.0]]],
        [0], [t1 + 10], [g, 0.0], [0.0, 0.0]), "re-pick")
    assert int(take[0, 0, 0]) > t1 and int(start[0, 0, 0]) == 0
