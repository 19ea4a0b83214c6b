"""The port's instances, US metric, GUS and congestion functions against the
JAX reference, on the CPU.

Inputs are made once with numpy (or by the reference's own generators) and
handed to both packages.  Integer assignments are held to exact equality
with the five golden fixtures, the reference's XLA backend and its Pallas
kernel run the way the reference's suite runs it on the CPU (interpret
mode).  ``us_tensor`` and the congestion functions are held bit for bit.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import queueing as RQ  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import queueing as PQ  # noqa: E402

FIXTURE_DIR = Path(__file__).parent / "fixtures"
GOLDEN_NAMES = ("paper-default", "flash-crowd", "sustained-overload-congested",
                "outage-masked", "impairment-reduced")
BUCKETS = (4, 8, 16, 32, 64, 128, 256)
FIELDS = tuple(f.name for f in dataclasses.fields(P.FlatInstance))
SMALL = dict(n_requests=24, n_edge=4, n_cloud=1, n_services=12, n_variants=4)


def leaves(inst) -> dict:
    """A reference instance's leaves as numpy arrays."""
    return {k: np.asarray(getattr(inst, k)) for k in FIELDS}


def port(inst) -> P.FlatInstance:
    return P.FlatInstance.from_numpy(leaves(inst), "cpu")


def ref_gen(seed, **kw):
    return R.generate_instance(seed, R.GeneratorConfig(**{**SMALL, **kw}))


def assert_same(got, j, l, label):
    np.testing.assert_array_equal(got.j.numpy(), np.asarray(j), err_msg=f"{label}: j")
    np.testing.assert_array_equal(got.l.numpy(), np.asarray(l), err_msg=f"{label}: l")


def assert_bits(a, b, label=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, label
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=label)


def every_way(inst_r, label, **relax):
    """The frame through the reference's XLA and Pallas backends and the
    port's oracle, plain loop and kernel wrapper (which takes the plain
    version on the CPU); all must agree exactly."""
    ref = R.gus_schedule(inst_r, backend="xla", **relax)
    pal = R.gus_schedule(inst_r, backend="pallas", **relax)
    np.testing.assert_array_equal(np.asarray(ref.j), np.asarray(pal.j), err_msg=label)
    np.testing.assert_array_equal(np.asarray(ref.l), np.asarray(pal.l), err_msg=label)
    inst = port(inst_r)
    for backend in P.GUS_BACKENDS:
        got = P.gus_schedule(inst, backend=backend, device="cpu", **relax)
        assert_same(got, ref.j, ref.l, f"{label}/{backend}")
    if not relax:
        assert_same(P.gus_schedule_np(inst), ref.j, ref.l, f"{label}/np")
    return ref


# ---------------------------------------------------------------------------
# instances and the US metric
# ---------------------------------------------------------------------------

def test_from_numpy_round_trips():
    d = leaves(ref_gen(3))
    inst = P.FlatInstance.from_numpy(d, "cpu")
    back = inst.numpy()
    for k in FIELDS:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


def test_generate_batch_matches_reference():
    cfg_kw = dict(SMALL, n_requests=10)
    ref = R.generate_batch(5, 3, R.GeneratorConfig(**cfg_kw))
    got = P.generate_batch(5, 3, P.GeneratorConfig(**cfg_kw), device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)


@pytest.mark.parametrize("source", ("generated",) + GOLDEN_NAMES)
def test_us_and_feasibility_bit_equal(source):
    """``us_tensor`` is bit-equal and ``hard_feasible`` equal to the reference."""
    if source == "generated":
        inst_r = R.generate_instance(7)
    else:
        d = np.load(FIXTURE_DIR / f"gus_golden_{source}.npz")
        inst_r = R.FlatInstance(**{k: jnp.asarray(d[k]) for k in FIELDS})
    inst = port(inst_r)
    assert_bits(P.us_tensor(inst).numpy(), R.us_tensor(inst_r), source)
    np.testing.assert_array_equal(
        P.hard_feasible(inst).numpy(), np.asarray(R.hard_feasible(inst_r))
    )


def test_pad_instance_matches_reference():
    inst_r = ref_gen(2, n_requests=5)
    got = P.pad_instance(port(inst_r), 16)
    want = R.pad_instance(inst_r, 16)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    with pytest.raises(ValueError):
        P.pad_instance(port(inst_r), 4)


def test_satisfied_mask_and_mean_us():
    """``satisfied_mask`` is exact; ``mean_us`` agrees to the stated
    tolerance: its row mean is a float32 reduction, and PyTorch and XLA sum
    in different orders (the last bits differ on most rows)."""
    batch_r = R.generate_batch(11, 6, R.GeneratorConfig(**SMALL))
    a = R.gus_schedule_batch(batch_r, backend="xla")
    batch = P.FlatInstance.from_numpy(leaves(batch_r), "cpu")
    j, l = torch.from_numpy(np.array(a.j)), torch.from_numpy(np.array(a.l))
    np.testing.assert_array_equal(
        P.satisfied_mask(batch, j, l).numpy(), np.asarray(R.satisfied_mask(batch_r, a.j, a.l))
    )
    np.testing.assert_allclose(
        P.mean_us(batch, j, l).numpy(), np.asarray(R.mean_us(batch_r, a.j, a.l)),
        rtol=1e-5, atol=1e-6,
    )


# ---------------------------------------------------------------------------
# GUS: golden fixtures, the live reference, buckets, degenerate frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_frame(name):
    d = np.load(FIXTURE_DIR / f"gus_golden_{name}.npz")
    inst = P.FlatInstance.from_numpy(d, "cpu")
    for backend in P.GUS_BACKENDS:
        assert_same(P.gus_schedule(inst, backend=backend, device="cpu"),
                    d["exp_j"], d["exp_l"], f"{name}/{backend}")
    assert_same(P.gus_schedule_np(inst), d["exp_j"], d["exp_l"], f"{name}/np")


@pytest.mark.parametrize("seed", range(3))
def test_random_frames_every_way(seed):
    every_way(ref_gen(seed), f"seed {seed}")


@pytest.mark.parametrize("bucket", BUCKETS)
def test_pad_bucket_every_way(bucket):
    """Every power-of-two bucket the fleet pads to, real rows filling just
    over half of it; padded rows drop on every path."""
    n_real = max(1, bucket // 2 + 1)
    inst_r = R.pad_instance(ref_gen(bucket, n_requests=n_real), bucket)
    ref = every_way(inst_r, f"bucket {bucket}")
    assert (np.asarray(ref.j)[n_real:] == -1).all()


def _frame(**arrays):
    return R.FlatInstance(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_empty_frame():
    inst_r = ref_gen(0)
    inst_r = dataclasses.replace(
        inst_r, **{k: getattr(inst_r, k)[:0] for k in
                   ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")}
    )
    ref = every_way(inst_r, "empty")
    assert np.asarray(ref.j).shape == (0,)


def test_all_infeasible_frame():
    inst_r = ref_gen(1)
    inst_r = dataclasses.replace(inst_r, avail=jnp.zeros_like(inst_r.avail))
    ref = every_way(inst_r, "all-infeasible")
    assert (np.asarray(ref.j) == -1).all()


def test_exact_capacity_fit():
    """``v == remaining gamma`` is feasible: two of three identical requests fit."""
    N, M, L = 3, 2, 1
    inst_r = _frame(
        cover=np.zeros(N, np.int32), A=np.full(N, 10.0, np.float32),
        C=np.full(N, 1000.0, np.float32), w_a=np.ones(N, np.float32),
        w_c=np.ones(N, np.float32), acc=np.full((N, M, L), 80.0, np.float32),
        ctime=np.broadcast_to(np.array([100.0, 200.0], np.float32)[None, :, None], (N, M, L)).copy(),
        v=np.ones((N, M, L), np.float32), u=np.zeros((N, M, L), np.float32),
        avail=np.ones((N, M, L), bool), gamma=np.array([2.0, 0.0], np.float32),
        eta=np.zeros(M, np.float32), max_as=np.float32(100.0), max_cs=np.float32(1000.0),
    )
    ref = every_way(inst_r, "exact-capacity")
    assert np.asarray(ref.j).tolist() == [0, 0, -1]


def test_duplicate_utility_ties():
    """Every candidate has the same utility: the lowest flat j*L+l wins."""
    N, M, L = 6, 3, 2
    inst_r = _frame(
        cover=np.zeros(N, np.int32), A=np.full(N, 10.0, np.float32),
        C=np.full(N, 1000.0, np.float32), w_a=np.ones(N, np.float32),
        w_c=np.ones(N, np.float32), acc=np.full((N, M, L), 50.0, np.float32),
        ctime=np.full((N, M, L), 100.0, np.float32), v=np.ones((N, M, L), np.float32),
        u=np.ones((N, M, L), np.float32), avail=np.ones((N, M, L), bool),
        gamma=np.full(M, 100.0, np.float32), eta=np.full(M, 100.0, np.float32),
        max_as=np.float32(100.0), max_cs=np.float32(1000.0),
    )
    ref = every_way(inst_r, "ties")
    assert (np.asarray(ref.j) == 0).all() and (np.asarray(ref.l) == 0).all()


@pytest.mark.parametrize("relax", ["compute", "comm"])
def test_relax_variants(relax):
    """Happy-* relaxations: +inf budgets, v <= inf, inf + (-v) = inf."""
    for seed in range(2):
        every_way(ref_gen(seed), f"relax_{relax}[{seed}]", **{f"relax_{relax}": True})


def test_batch_entry_points():
    """The batch entries agree with the reference's XLA and Pallas batch
    entries on a stacked, padded bucket, and with the single-frame entry."""
    insts = [R.pad_instance(ref_gen(s, n_requests=5 + s), 16) for s in range(4)]
    batch_r = R.stack_instances(insts)
    ref_x = R.gus_schedule_batch(batch_r, backend="xla")
    ref_p = R.gus_schedule_batch(batch_r, backend="pallas")
    np.testing.assert_array_equal(np.asarray(ref_x.j), np.asarray(ref_p.j))
    batch = P.FlatInstance.from_numpy(leaves(batch_r), "cpu")
    for backend in P.GUS_BACKENDS:
        got = P.gus_schedule_batch(batch, backend=backend, device="cpu")
        assert_same(got, ref_x.j, ref_x.l, f"batch/{backend}")
    stacked = P.stack_instances([port(i) for i in insts])
    assert_same(P.gus_schedule_batch(stacked, device="cpu"), ref_x.j, ref_x.l, "stacked")


# ---------------------------------------------------------------------------
# congestion functions and committed loads
# ---------------------------------------------------------------------------

def test_committed_loads_match_reference_and_gus():
    """The reference's scatter-add sums in request order; the port's
    ``committed_loads`` and the loads GUS returns are bit-equal to it."""
    batch_r = R.generate_batch(21, 4, R.GeneratorConfig(**SMALL))
    batch = P.FlatInstance.from_numpy(leaves(batch_r), "cpu")
    a = P.gus_schedule_batch(batch, device="cpu")
    w, c = PQ.committed_loads(batch, a.j, a.l)
    assert_bits(a.loads[0].numpy(), w.numpy(), "gus w")
    assert_bits(a.loads[1].numpy(), c.numpy(), "gus c")
    for b in range(4):
        frame_r = R.FlatInstance(**{k: getattr(batch_r, k)[b] for k in FIELDS})
        wr, cr = RQ.committed_loads(frame_r, jnp.asarray(a.j[b].numpy()), jnp.asarray(a.l[b].numpy()))
        assert_bits(w[b].numpy(), wr, f"w[{b}]")
        assert_bits(c[b].numpy(), cr, f"c[{b}]")
        frame = P.FlatInstance(**{k: getattr(batch, k)[b] for k in FIELDS})
        w1, c1 = PQ.committed_loads(frame, a.j[b], a.l[b])
        assert_bits(w1.numpy(), wr, f"unbatched w[{b}]")
        assert_bits(c1.numpy(), cr, f"unbatched c[{b}]")


def test_congestion_functions_bit_equal():
    rng = np.random.default_rng(0)
    R_, M, N, L = 5, 6, 8, 3
    budget = rng.uniform(0.0, 5000.0, (R_, M)).astype(np.float32)
    budget[0, 0] = 0.0  # a dead server
    backlog = rng.uniform(0.0, 6000.0, (R_, M)).astype(np.float32)
    load = rng.uniform(0.0, 9000.0, (R_, M)).astype(np.float32)
    ema = rng.uniform(0.0, 2.0, (R_, M)).astype(np.float32)
    t = torch.from_numpy
    for cfg in (dict(), dict(drain=0.5, ema_alpha=0.3, power=2.0, compute_slope=2.5)):
        rc, pc = RQ.CongestionConfig(enabled=True, **cfg), PQ.CongestionConfig(enabled=True, **cfg)
        assert_bits(PQ.effective_capacity(t(budget), t(backlog)).numpy(),
                    RQ.effective_capacity(budget, backlog))
        assert_bits(PQ.compute_inflation(t(load), t(budget), pc).numpy(),
                    RQ.compute_inflation(load, budget, rc))
        assert_bits(PQ.comm_inflation(t(load), t(budget), pc).numpy(),
                    RQ.comm_inflation(load, budget, rc))
        assert_bits(PQ.step_backlog(t(backlog), t(load), t(budget), pc).numpy(),
                    RQ.step_backlog(backlog, load, budget, rc))
        assert_bits(PQ.ema_update(t(ema), t(load), t(budget), pc).numpy(),
                    RQ.ema_update(ema, load, budget, rc))
    batch_r = R.generate_batch(3, R_, R.GeneratorConfig(**dict(SMALL, n_requests=N, n_edge=M - 1, n_variants=L)))
    batch = P.FlatInstance.from_numpy(leaves(batch_r), "cpu")
    tq = rng.uniform(0.0, 3000.0, (R_, N)).astype(np.float32)
    phi_c = rng.uniform(1.0, 3.0, (R_, M)).astype(np.float32)
    phi_e = rng.uniform(1.0, 3.0, (R_, M)).astype(np.float32)
    assert_bits(PQ.congested_ctime(batch, t(tq), t(phi_c), t(phi_e)).numpy(),
                RQ.congested_ctime(batch_r, tq, phi_c, phi_e))


def test_fleet_policy_carry_layout():
    ref = RQ.fleet_policy_carry(3, 4, seed=0, bandwidth_init=600.0)
    got = PQ.fleet_policy_carry(3, 4, bandwidth_init=600.0, device="cpu")
    for f in ("backlog_gamma", "backlog_eta", "ema_util", "bw_prev", "bw_cur", "link_bw", "server_up"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    assert tuple(got.key.shape) == np.asarray(ref.key).shape and got.key.dtype == torch.uint32
