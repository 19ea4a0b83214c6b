"""The staged GUS kernel's walk, in plain form, against the reference on the
CPU.

``csrc/gus_assign.cu`` runs only on the card, and its walk differs in form
from the reference's.  Off the chain, its score warps fold each cell's
utility and static feasibility (avail, accuracy floor, deadline, us > NEG)
into one ordered uint32 key (sign-flipped bits, -0 folded onto +0, 0 where
the cell can never be picked) and mark each row that has a usable cell at
all.  On the chain, a row with none is dropped at once; otherwise lane i
tests its cells i, i + 32, .. against the budgets, keeps its largest key
(the first on ties), and two warp reductions take the largest key and then
the lowest flat index holding it; the commit adds -v and -u to the budgets
and v and u to the request-order loads.  :func:`staged_walk` is that walk
written out in numpy, float32 op for op.  It must equal ``gus_assign_ref``
(the port's plain version) and the reference's NumPy oracle
``gus_schedule_np`` and jitted ``gus_schedule`` exactly, assignments and
committed loads (``repro.core.queueing.committed_loads``), on generated
frames, the golden fixtures and adversarial frames: equal scores, -0
against +0, a cell exactly at its budget, v = 0 and u = 0, +inf budgets, a
feasible cell with us <= NEG, all-infeasible and padding rows, and request
counts and row widths that are not multiples of the kernel's tile, of 16 or
of 32.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import queueing as RQ  # noqa: E402

from repro_torch.kernels.gus import NEG, gus_assign_ref  # noqa: E402

f32 = np.float32
FIXTURES = sorted((Path(__file__).parent / "fixtures").glob("gus_golden_*.npz"))
FIELDS = tuple(f.name for f in dataclasses.fields(R.FlatInstance))


def score_keys(us):
    """Ordered uint32 keys of float32 scores: a > b iff key(a) > key(b), and
    -0 and +0 share a key."""
    bits = np.ascontiguousarray(us, np.float32).view(np.uint32).copy()
    bits[(bits << np.uint32(1)) == 0] = 0
    neg = (bits & np.uint32(0x80000000)) != 0
    return np.where(neg, ~bits, bits | np.uint32(0x80000000)).astype(np.uint32)


def staged_walk(fr):
    """One frame (a dict of the FlatInstance fields as numpy arrays) ->
    int32 (j, l) and float32 (w, c), as the kernel walks it."""
    acc, ctime, v, u = (np.asarray(fr[k], f32) for k in ("acc", "ctime", "v", "u"))
    N, M, L = acc.shape
    ML = M * L
    A, C = np.asarray(fr["A"], f32)[:, None, None], np.asarray(fr["C"], f32)[:, None, None]
    w_a, w_c = np.asarray(fr["w_a"], f32)[:, None, None], np.asarray(fr["w_c"], f32)[:, None, None]
    # off the chain: the keys and each row's "has a usable cell"
    with np.errstate(over="ignore"):  # an adversarial frame scores -inf
        acc_term = (acc - A) / f32(fr["max_as"])
        time_term = (C - ctime) / f32(fr["max_cs"])
        us = (w_a * acc_term + w_c * time_term).astype(f32)
    ok = np.asarray(fr["avail"], bool) & (acc >= A) & (ctime <= C) & (us > f32(NEG))
    keys = np.where(ok, score_keys(us), np.uint32(0)).reshape(N, ML)
    usable = ok.reshape(N, ML).any(1)
    v_f, u_f = v.reshape(N, ML), u.reshape(N, ML)
    # the chain: budgets and loads in float32, committed in request order
    gamma = np.array(fr["gamma"], f32)
    eta = np.array(fr["eta"], f32)
    w, c = np.zeros(M, f32), np.zeros(M, f32)
    out_j, out_l = np.full(N, -1, np.int32), np.full(N, -1, np.int32)
    lanes = np.arange(32)
    for i in range(N):
        if not usable[i]:
            continue
        s = int(fr["cover"][i])
        best = np.zeros(32, np.uint32)
        best_f = np.full(32, 0xFFFFFFFF, np.uint32)
        for q in range(-(-ML // 32)):  # lane i's cells i, i + 32, ..
            f = lanes + 32 * q
            inside = f < ML
            fc = np.where(inside, f, 0)
            j = fc // L
            fits = inside & (v_f[i, fc] <= gamma[j]) & ((j == s) | (u_f[i, fc] <= eta[s]))
            take = fits & (keys[i, fc] > best)
            best = np.where(take, keys[i, fc], best)
            best_f = np.where(take, f.astype(np.uint32), best_f)
        top = best.max()
        if top == 0:
            continue
        flat = int(best_f[best == top].min())
        jw, lw = divmod(flat, L)
        vv, uu = v[i, jw, lw], u[i, jw, lw]
        gamma[jw] = gamma[jw] + -vv
        w[jw] = w[jw] + vv
        if jw != s:
            eta[s] = eta[s] + -uu
            c[s] = c[s] + uu
        out_j[i], out_l[i] = jw, lw
    return out_j, out_l, w, c


def frame_of(inst_r):
    return {k: np.asarray(getattr(inst_r, k)) for k in FIELDS}


def reference(fr):
    return R.FlatInstance(**{k: jnp.asarray(x) for k, x in fr.items()})


def plain(fr):
    """The port's plain version on a batch of one."""
    t = {k: torch.from_numpy(np.array(x))[None] for k, x in fr.items()}
    for k in ("max_as", "max_cs"):
        t[k] = t[k].reshape(1)
    j, l, w, c = gus_assign_ref(*(t[k] for k in FIELDS))
    return j[0].numpy(), l[0].numpy(), w[0].numpy(), c[0].numpy()


def assert_bits(a, b, label):
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=label)


def assert_walk_agrees(fr, label, *, oracle=True, **relax):
    """The staged walk == the port's plain version, the reference's jitted
    GUS (and its committed loads) and, with ``oracle``, its NumPy oracle."""
    fr = dict(fr)
    if relax.get("relax_compute"):
        fr["gamma"] = np.full_like(fr["gamma"], np.inf)
    if relax.get("relax_comm"):
        fr["eta"] = np.full_like(fr["eta"], np.inf)
    j, l, w, c = staged_walk(fr)
    pj, pl, pw, pc = plain(fr)
    np.testing.assert_array_equal(j, pj, err_msg=f"{label}: j vs gus_assign_ref")
    np.testing.assert_array_equal(l, pl, err_msg=f"{label}: l vs gus_assign_ref")
    assert_bits(w, pw, f"{label}: w vs gus_assign_ref")
    assert_bits(c, pc, f"{label}: c vs gus_assign_ref")
    inst_r = reference(fr)
    ref = R.gus_schedule(inst_r, backend="xla")
    np.testing.assert_array_equal(j, np.asarray(ref.j), err_msg=f"{label}: j vs gus_schedule")
    np.testing.assert_array_equal(l, np.asarray(ref.l), err_msg=f"{label}: l vs gus_schedule")
    rw, rc = RQ.committed_loads(inst_r, ref.j, ref.l)
    assert_bits(w, rw, f"{label}: w vs committed_loads")
    assert_bits(c, rc, f"{label}: c vs committed_loads")
    if oracle:
        o = R.gus_schedule_np(inst_r)
        np.testing.assert_array_equal(j, np.asarray(o.j), err_msg=f"{label}: j vs gus_schedule_np")
        np.testing.assert_array_equal(l, np.asarray(o.l), err_msg=f"{label}: l vs gus_schedule_np")
    return j, l, w, c


# (seed, n_requests, n_edge, n_cloud, n_services, n_variants): M = n_edge +
# n_cloud servers, M*L cells a row
GENERATED = [
    (0, 100, 9, 1, 100, 10),   # the paper's frame: M*L = 100, 4 cells a lane
    (1, 37, 2, 1, 6, 7),       # M*L = 21, N = 37: neither a multiple of 16 nor 32
    (2, 1, 4, 1, 6, 4),        # N = 1
    (3, 33, 4, 1, 12, 13),     # M*L = 65: 3 cells a lane, the last lane-pass ragged
    (4, 17, 9, 1, 20, 15),     # M*L = 150: over 128, the kernel's generic cell loop
    (5, 23, 32, 1, 10, 1),     # M = 33: budgets in shared memory on the card
]


@pytest.mark.parametrize("case", GENERATED, ids=lambda c: f"seed{c[0]}-N{c[1]}-M{c[2] + c[3]}-L{c[5]}")
def test_generated_frames(case):
    seed, n, n_edge, n_cloud, n_services, n_variants = case
    cfg = R.GeneratorConfig(n_requests=n, n_edge=n_edge, n_cloud=n_cloud,
                            n_services=n_services, n_variants=n_variants)
    j, _, _, _ = assert_walk_agrees(frame_of(R.generate_instance(seed, cfg)), f"seed {seed}")
    assert (j >= 0).any()


@pytest.mark.parametrize("relax", ["relax_compute", "relax_comm"])
def test_relaxed_budgets(relax):
    """Happy-*: +inf budgets pass every cost, and inf + (-v) stays inf."""
    cfg = R.GeneratorConfig(n_requests=60, n_services=20)
    assert_walk_agrees(frame_of(R.generate_instance(6, cfg)), relax, oracle=False, **{relax: True})


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_golden_frames(path):
    d = np.load(path)
    j, l, _, _ = assert_walk_agrees({k: d[k] for k in FIELDS}, path.stem)
    np.testing.assert_array_equal(j, d["exp_j"])
    np.testing.assert_array_equal(l, d["exp_l"])


@pytest.mark.parametrize("n_real,n_pad", [(20, 37), (130, 256)])
def test_padding_rows(n_real, n_pad):
    """Padding rows (infeasible everywhere) between and after real rows are
    dropped without touching a budget."""
    cfg = R.GeneratorConfig(n_requests=n_real, n_services=30)
    inst_r = R.pad_instance(R.generate_instance(n_pad, cfg), n_pad)
    j, _, _, _ = assert_walk_agrees(frame_of(inst_r), f"padded {n_real}->{n_pad}")
    assert (j[n_real:] == -1).all()


def hand_frame(N, M, L, **kw):
    """A frame where every cell is feasible with utility 0.5 and costs 1,
    budgets are ample, and ``kw`` overrides any field."""
    fr = dict(
        cover=np.zeros(N, np.int32), A=np.full(N, 10.0, f32), C=np.full(N, 1000.0, f32),
        w_a=np.ones(N, f32), w_c=np.zeros(N, f32), acc=np.full((N, M, L), 60.0, f32),
        ctime=np.full((N, M, L), 100.0, f32), v=np.ones((N, M, L), f32),
        u=np.ones((N, M, L), f32), avail=np.ones((N, M, L), bool),
        gamma=np.full(M, 1e6, f32), eta=np.full(M, 1e6, f32),
        max_as=f32(100.0), max_cs=f32(1000.0),
    )
    fr.update({k: np.asarray(x, fr[k].dtype) for k, x in kw.items()})
    return fr


def test_equal_scores_take_the_lowest_flat():
    """Every cell ties: each request takes the lowest flat whose server still
    has compute, so the walk fills server 0, then 1, across lanes."""
    N, M, L = 40, 3, 11  # M*L = 33: the tie spans two lane passes
    j, l, _, _ = assert_walk_agrees(hand_frame(N, M, L, gamma=[2.0, 30.0, 100.0]), "ties")
    assert j.tolist() == [0] * 2 + [1] * 30 + [2] * 8 and (l == 0).all()


@pytest.mark.parametrize("first", ["-0", "+0"])
def test_signed_zero_scores_tie(first):
    """us = -0 and us = +0 are equal scores: the lower flat wins whichever
    sign it has.  With w_a = 1, w_c = -1 and ctime = C, a cell's us is
    (acc - A) / max_as + (-0): -0 where acc = -0 and A = +0, else +0."""
    zeros = [-0.0, 0.0] if first == "-0" else [0.0, -0.0]
    acc = np.array(zeros, f32).reshape(1, 2, 1)
    fr = hand_frame(1, 2, 1, A=[0.0], C=[100.0], w_a=[1.0], w_c=[-1.0], acc=acc,
                    ctime=np.full((1, 2, 1), 100.0))
    us = (fr["w_a"][0] * ((acc - fr["A"][0]) / fr["max_as"])
          + fr["w_c"][0] * ((fr["C"][0] - fr["ctime"]) / fr["max_cs"])).reshape(-1)
    assert np.signbit(us).tolist() == [first == "-0", first == "+0"] and (us == 0).all()
    j, _, _, _ = assert_walk_agrees(fr, f"signed zeros ({first} first)")
    assert j.tolist() == [0]


def test_cost_exactly_at_its_budget():
    """v == gamma[j] fits once; an offload with u == eta[s] fits once."""
    N, M, L = 3, 2, 1
    fr = hand_frame(N, M, L, acc=np.broadcast_to(np.array([70.0, 60.0])[None, :, None], (N, M, L)),
                    v=np.full((N, M, L), 2.0), u=np.full((N, M, L), 3.0),
                    gamma=[2.0, 2.0], eta=[3.0, 0.0])
    j, _, w, c = assert_walk_agrees(fr, "at budget")
    assert j.tolist() == [0, 1, -1]
    assert w.tolist() == [2.0, 2.0] and c.tolist() == [3.0, 0.0]


def test_free_costs_fit_spent_budgets():
    """v = 0 and u = 0 fit budgets of 0 (0 <= 0), and commit nothing."""
    N, M, L = 5, 3, 2
    v = np.ones((N, M, L), f32)
    v[:, 2, 1] = 0.0
    fr = hand_frame(N, M, L, v=v, u=np.zeros((N, M, L)), gamma=[0.0, 0.0, 0.0],
                    eta=[0.0, 0.0, 0.0])
    j, l, w, c = assert_walk_agrees(fr, "free costs")
    assert j.tolist() == [2] * N and l.tolist() == [1] * N and not w.any() and not c.any()


def test_infinite_budgets_in_a_frame():
    """+inf budgets inside a frame (not the relax flags): every cost fits."""
    N, M, L = 6, 2, 3
    fr = hand_frame(N, M, L, v=np.full((N, M, L), 1e30), u=np.full((N, M, L), 1e30),
                    gamma=[np.inf, 0.0], eta=[np.inf, 0.0],
                    acc=np.broadcast_to(np.array([50.0, 90.0])[None, :, None], (N, M, L)))
    j, l, _, _ = assert_walk_agrees(fr, "inf budgets")
    assert (j == 0).all() and (l == 0).all()


def test_feasible_cells_scored_at_or_below_neg_are_never_picked():
    """A feasible cell with us <= NEG (-1e30) is dropped, as the reference's
    score > NEG test drops it: us = NEG exactly (w_a = -1e30, acc_term = 1),
    -1e31 and -inf.  Only the cell above NEG is ever served; once its server
    is spent the request is dropped.  The NumPy oracle does not mask scores
    (it serves the first feasible cell in utility order whatever its score),
    so it is left out here."""
    N, M, L = 3, 4, 1
    acc = np.broadcast_to(np.array([110.0, 110.0, 110.0, 10.5])[None, :, None], (N, M, L))
    w_a = np.array([-1e30, -1e30, -1e30], f32)
    # row 0: cells 0-2 score NEG exactly, cell 3 -5e27 (served, spending
    # server 3); rows 1-2 (w_a = -1e31): cells 0 and 2 score -1e31, cell 1
    # -inf, cell 3 -5e28 but its server is spent
    fr = hand_frame(N, M, L, A=[10.0, 10.0, 10.0], w_a=w_a, acc=acc, gamma=[9, 9, 9, 1])
    fr["w_a"][1:] = [-1e31, -1e31]
    fr["acc"] = fr["acc"].copy()
    fr["acc"][1:, 1] = 1e38  # acc_term ~1e36: w_a * acc_term = -inf
    j, _, _, _ = assert_walk_agrees(fr, "us <= NEG", oracle=False)
    assert j.tolist() == [3, -1, -1]


def test_all_infeasible_rows_between_served_ones():
    cfg = R.GeneratorConfig(n_requests=29, n_services=15)
    fr = frame_of(R.generate_instance(8, cfg))
    fr["avail"] = np.array(fr["avail"])
    fr["avail"][3::4] = False
    j, _, _, _ = assert_walk_agrees(fr, "infeasible rows")
    assert (j[3::4] == -1).all() and (j >= 0).any()
