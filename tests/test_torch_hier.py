"""The port's hierarchical class-aggregate path against the JAX reference,
on the CPU.

* Class building: ``class_keys``, ``aggregate_requests`` and
  ``aggregate_instance`` equal the reference; ``_pad_bucket_fine`` too.
* The class allocator: ``hier_cells_ref`` (the plain version the CPU path
  runs and the kernel is held against on the card) is bitwise equal to the
  reference's NumPy oracle ``hier_cells_np``, its XLA scan and its Pallas
  kernel in interpret mode (small buckets only), on the reference parity
  suite's cases: generated frames, duplicate classes, padding buckets,
  ties, infeasible and zero-count rows, exact-capacity chunks and the
  budget carry — one frame at a time and as one batch.
* Committed loads: the port sums them in a fixed order (``class_loads``).
  XLA's CPU reduction of the same sums is tree-blocked and uses fused
  multiply-adds, an order no simple loop reproduces; the measured
  difference is a few ulp, held here to ``LOAD_RTOL``.
* The hierarchical fleet on the CPU equals the JAX fleet: ``n_requests``,
  ``n_served``, ``satisfied_per_rep`` and ``mean_us_per_rep`` exactly (the
  per-member accounting is the reference's numpy, op for op); with
  congestion on, the carried backlog and the mean inflation follow the
  loads' order and are held to ``BACKLOG_RTOL``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.aggregation as RA  # noqa: E402
import repro.core.simulator as RSIM  # noqa: E402
from repro.core.impairments import AdmissionConfig  # noqa: E402
from repro.kernels.hier_pallas import hier_cells_pallas  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.core.aggregation as PA  # noqa: E402
import repro_torch.core.simulator as PSIM  # noqa: E402
import repro_torch.core.streaming as PS  # noqa: E402
from repro_torch.kernels.hier import class_loads, hier_cells, hier_cells_ref  # noqa: E402

#: committed loads vs XLA's CPU reduction: measured at most 2 ulp
LOAD_RTOL = 1e-6
#: carried backlog and mean inflation of the congested fleet vs JAX, which
#: inherit the loads' last bits over a few frames
BACKLOG_RTOL = 1e-5
SMALL = R.GeneratorConfig(n_requests=24, n_edge=4, n_cloud=1, n_services=6, n_variants=4)
BUCKETS = (4, 8, 16, 32, 64, 128)
#: buckets small enough for the Pallas kernel in interpret mode
PALLAS_BUCKETS = (4, 16)


# ---------------------------------------------------------------------------
# class building
# ---------------------------------------------------------------------------

def mega_city_frame(seed=0, rate=200.0, n_edge=6):
    """One frame's columns of a seeded mega-city stream (~3600 requests)."""
    cfg = P.SimConfig(horizon_ms=3000.0)
    scn = dataclasses.replace(P.get_scenario("mega-city"), rate_per_edge_per_s=rate)
    cols = PS.stream_trace_columns(scn, seed, n_edge, 5, cfg)
    tq = cfg.frame_ms - cols.arrival_ms
    return cols.cover, cols.service, cols.A, cols.C, cols.size_bytes, tq


@pytest.mark.parametrize("seed", [0, 1])
def test_class_keys_and_aggregation_match_reference(seed):
    cols = mega_city_frame(seed)
    np.testing.assert_array_equal(PA.class_keys(*cols), RA.class_keys(*cols))
    quant = dict(size_bin_bytes=5000.0, tq_bin_ms=300.0)
    for qp, qr in ((None, None), (PA.QuantizationConfig(**quant), RA.QuantizationConfig(**quant))):
        got = PA.aggregate_requests(*cols, qp)
        ref = RA.aggregate_requests(*cols, qr)
        for g, r in zip(got[:4], ref[:4]):
            np.testing.assert_array_equal(g, r)
        assert got[4].keys() == ref[4].keys()
        for k in ref[4]:
            np.testing.assert_array_equal(got[4][k], ref[4][k], err_msg=k)
        assert 0 < len(got[0]) < len(cols[0])  # discrete tiers really collapse
    assert all(len(x) == 0 for x in PA.aggregate_requests(*(c[:0] for c in cols))[:3])


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 3)])
def test_aggregate_instance_and_deaggregate_match_reference(seed, k):
    ref_inst = tile(R.generate_instance(seed, SMALL, as_numpy=True), k)
    got_inst = P.FlatInstance.from_numpy(
        {f: np.asarray(getattr(ref_inst, f)) for f in FIELDS}, "cpu"
    )
    ref, got = RA.aggregate_instance(ref_inst), PA.aggregate_instance(got_inst)
    for f in ("count", "first_idx", "members", "offsets", "cover", "us", "feas", "v", "u"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    chunks = RA.hier_assign(ref, np.asarray(ref_inst.gamma), np.asarray(ref_inst.eta))
    n = ref.members.shape[0]
    for g, r in zip(PA.deaggregate(got, chunks, n), RA.deaggregate(ref, chunks, n)):
        np.testing.assert_array_equal(g, r)


def test_pad_bucket_fine_matches_reference():
    for n in list(range(0, 130)) + list(range(4000, 40_000, 97)):
        assert PSIM._pad_bucket_fine(n) == RSIM._pad_bucket_fine(n), n


# ---------------------------------------------------------------------------
# the class allocator
# ---------------------------------------------------------------------------

FIELDS = ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail",
          "gamma", "eta", "max_as", "max_cs")


def tile(inst, k):
    rep = lambda x: np.repeat(np.asarray(x), k, axis=0)  # noqa: E731
    rows = ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")
    return dataclasses.replace(inst, **{f: rep(getattr(inst, f)) for f in rows})


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


def degenerate(us, feas, v, u, cover, count, gamma, eta):
    return (np.asarray(us, np.float32), np.asarray(feas, bool), np.asarray(v, np.float32),
            np.asarray(u, np.float32), np.asarray(cover, np.int32),
            np.asarray(count, np.int32), np.asarray(gamma, np.float32),
            np.asarray(eta, np.float32))


def port_cells(args):
    """``hier_cells_ref`` on one frame (a batch of one), as numpy."""
    t = [torch.from_numpy(np.ascontiguousarray(a))[None] for a in args]
    take, start = hier_cells_ref(*t)
    return take[0].numpy(), start[0].numpy()


def assert_parity(args, pallas=False, label=""):
    """The port's plain allocator equals the oracle, XLA (and, for small
    buckets, Pallas in interpret mode) bit for bit; returns its cells."""
    take, start = port_cells(args)
    refs = {"np": RA.hier_cells_np(*args), "xla": RA.hier_cells(*args, backend="xla")}
    if pallas:
        t, s = hier_cells_pallas(*(jnp.asarray(a)[None] for a in args), interpret=True)
        refs["pallas"] = (t[0], s[0])
    for name, (t, s) in refs.items():
        np.testing.assert_array_equal(take, np.asarray(t), err_msg=f"{label} take vs {name}")
        np.testing.assert_array_equal(start, np.asarray(s), err_msg=f"{label} start vs {name}")
    return take, start


@pytest.mark.parametrize("seed", range(6))
def test_generated_frames(seed):
    args = class_args(R.generate_instance(seed, as_numpy=True))
    take, _ = assert_parity(args, label=f"seed={seed}")
    assert take.sum() > 0 and np.all(take.sum(axis=(1, 2)) <= args[5])


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 5), (2, 5)])
def test_duplicate_class_frames(seed, k):
    assert_parity(class_args(tile(R.generate_instance(seed, SMALL, as_numpy=True), k)),
                  pallas=seed == 0, label=f"dup seed={seed} k={k}")


@pytest.mark.parametrize("bucket", BUCKETS)
def test_padding_buckets(bucket):
    cfg = dataclasses.replace(SMALL, n_requests=max(2, (3 * bucket) // 4))
    inst = R.generate_instance(1, cfg, as_numpy=True)
    bare = assert_parity(class_args(inst), label=f"bucket={bucket} bare")
    padded = assert_parity(class_args(inst, bucket), pallas=bucket in PALLAS_BUCKETS,
                           label=f"bucket={bucket} padded")
    n_c = bare[0].shape[0]
    np.testing.assert_array_equal(padded[0][:n_c], bare[0])
    assert padded[0][n_c:].sum() == 0 and padded[1][n_c:].sum() == 0


def test_tie_frames_pick_first_flat_cell():
    C, M, L = 3, 4, 2
    take, start = assert_parity(degenerate(
        np.ones((C, M, L)), np.ones((C, M, L), bool), np.ones((C, M, L)), np.ones((C, M, L)),
        np.zeros(C), np.full(C, 2), np.full(M, 1e6), np.full(M, 1e6),
    ), pallas=True, label="ties")
    assert np.all(take[:, 0, 0] == 2) and take.sum() == 6 and not start.any()


def test_all_infeasible_and_zero_count_rows():
    C, M, L = 4, 3, 2
    feas = np.ones((C, M, L), bool)
    feas[1] = False
    take, _ = assert_parity(degenerate(
        np.random.default_rng(0).uniform(0, 1, (C, M, L)), feas, np.ones((C, M, L)),
        np.ones((C, M, L)), np.zeros(C), [3, 3, 0, 3], np.full(M, 1e6), np.full(M, 1e6),
    ), pallas=True, label="infeasible/zero-count")
    assert take[1].sum() == 0 and take[2].sum() == 0 and take[0].sum() == take[3].sum() == 3


def test_exact_capacity_chunk_edges():
    us = np.array([[[1.0], [0.5]]])
    take, _ = assert_parity(degenerate(
        us, [[[True], [False]]], np.ones((1, 2, 1)), np.zeros((1, 2, 1)),
        [0], [3], [2.0, 0.0], [1e6, 1e6],
    ), pallas=True, label="gamma-bound")
    assert int(take[0, 0, 0]) == 2 and take.sum() == 2
    take, _ = assert_parity(degenerate(
        us, [[[False], [True]]], np.ones((1, 2, 1)), np.ones((1, 2, 1)),
        [0], [3], [1e6, 1e6], [2.5, 1e6],
    ), pallas=True, label="eta-bound")
    assert int(take[0, 1, 0]) == 2 and take.sum() == 2


def test_budget_carries_across_classes():
    M, L = 2, 1
    take, _ = assert_parity(degenerate(
        np.tile(np.array([[[1.0], [0.4]]]), (2, 1, 1)), np.ones((2, M, L), bool),
        np.ones((2, M, L)), np.zeros((2, M, L)), [0, 0], [3, 2], [3.0, 1e6], [1e6, 1e6],
    ), pallas=True, label="carry")
    assert int(take[0, 0, 0]) == 3 and int(take[1, 0, 0]) == 0 and int(take[1, 1, 0]) == 2


def test_batched_frames_equal_one_frame_at_a_time():
    """Frames that finish a class early take no-op steps while the others
    go on: the batch equals the oracle frame by frame, and the CPU wrapper
    takes the plain version for either backend without counting."""
    insts = [R.generate_instance(s, as_numpy=True) for s in range(5)]
    insts += [tile(R.generate_instance(s, SMALL, as_numpy=True), 4) for s in range(2)]
    insts = [dataclasses.replace(i, **pad_to_grid(i)) for i in insts]
    per_frame = [class_args(i, 160) for i in insts]
    batch = [torch.from_numpy(np.stack([a[n] for a in per_frame])) for n in range(8)]
    n0 = hier_cells.launches
    for backend in ("torch", "cuda"):
        take, start, w, c_load = hier_cells(*batch, backend=backend, loads=True)
        for b, args in enumerate(per_frame):
            t, s = RA.hier_cells_np(*args)
            np.testing.assert_array_equal(take[b].numpy(), t)
            np.testing.assert_array_equal(start[b].numpy(), s)
        w2, c2 = class_loads(take, batch[2], batch[3], batch[4])
        assert torch.equal(w, w2) and torch.equal(c_load, c2)
    assert hier_cells.launches == n0


def pad_to_grid(inst, M=10, L=10):
    """SMALL frames widened to the default (M, L) grid with dead cells, so
    they stack with the default frames."""
    if np.asarray(inst.v).shape[1:] == (M, L):
        return {}
    N, m, l = np.asarray(inst.v).shape
    out = {}
    for f, fill in (("acc", 0.0), ("ctime", 1e9), ("v", 0.0), ("u", 0.0), ("avail", False)):
        x = np.asarray(getattr(inst, f))
        big = np.full((N, M, L), fill, x.dtype)
        big[:, :m, :l] = x
        out[f] = big
    out["gamma"] = np.concatenate([np.asarray(inst.gamma), np.zeros(M - m, np.float32)])
    out["eta"] = np.concatenate([np.asarray(inst.eta), np.zeros(M - m, np.float32)])
    return out


# ---------------------------------------------------------------------------
# committed loads
# ---------------------------------------------------------------------------

def random_allocation(rng, B, C, M, L):
    take = ((rng.random((B, C, M, L)) < min(0.5, 20.0 / C))
            * rng.integers(1, 50, (B, C, M, L))).astype(np.int32)
    v = rng.uniform(100, 1500, (B, C, M, L)).astype(np.float32)
    u = rng.uniform(10, 120, (B, C, M, L)).astype(np.float32)
    cover = rng.integers(0, M - 1, (B, C)).astype(np.int32)
    u[np.arange(M)[None, None, :] == cover[:, :, None]] = 0.0  # local cells are free
    return take, v, u, cover


def sequential_loads(take, v, u, cover):
    """The port's order written as plain scalar loops."""
    B, C, M, L = take.shape
    w = np.zeros((B, M), np.float32)
    cl = np.zeros((B, M), np.float32)
    for b in range(B):
        for c in range(C):
            sc = np.float32(0.0)
            for j in range(M):
                for l in range(L):
                    if take[b, c, j, l]:
                        t = np.float32(take[b, c, j, l])
                        w[b, j] = np.float32(w[b, j] + np.float32(t * v[b, c, j, l]))
                        sc = np.float32(sc + np.float32(t * u[b, c, j, l]))
            cl[b, cover[b, c]] = np.float32(cl[b, cover[b, c]] + sc)
    return w, cl


def xla_loads(take, v, u, cover):
    """``w``/``c_load`` as the reference's hierarchical runner computes them
    (its jitted step, fed a given take through a stand-in allocator)."""
    B, C, M, L = take.shape

    def given_take(us, feas, v, u, cover, count, gamma, eta):
        return us.astype(jnp.int32), jnp.zeros(us.shape, jnp.int32)

    run = RSIM._hier_runner_impl(
        given_take, R.CongestionConfig(enabled=True, drain=0.5), AdmissionConfig()
    )
    z = lambda *s: np.zeros((B, 1) + s, np.float32)  # noqa: E731
    inst = R.FlatInstance(
        cover=cover[:, None], A=z(C), C=z(C), w_a=z(C), w_c=z(C), acc=z(C, M, L),
        ctime=z(C, M, L), v=v[:, None], u=u[:, None], avail=np.zeros((B, 1, C, M, L), bool),
        gamma=np.full((B, 1, M), 1e9, np.float32), eta=np.full((B, 1, M), 1e9, np.float32),
        max_as=z(), max_cs=z(),
    )
    carry = (np.zeros((B, M), np.float32), np.zeros((B, M), np.float32))
    _, outs = run(carry, inst, take[:, None].astype(np.float32),
                  np.zeros((B, 1, C, M, L), bool), z(C), np.zeros((B, 1, C), np.int32))
    return np.asarray(outs[4])[:, 0], np.asarray(outs[5])[:, 0]


@pytest.mark.parametrize("C,M,L", [(24, 7, 10), (300, 21, 10)])
def test_committed_load_order(C, M, L):
    take, v, u, cover = random_allocation(np.random.default_rng(C), 3, C, M, L)
    w, cl = class_loads(*(torch.from_numpy(x) for x in (take, v, u, cover)))
    w_seq, cl_seq = sequential_loads(take, v, u, cover)
    np.testing.assert_array_equal(w.numpy(), w_seq)
    np.testing.assert_array_equal(cl.numpy(), cl_seq)
    w_x, cl_x = xla_loads(take, v, u, cover)
    np.testing.assert_allclose(w.numpy(), w_x, rtol=LOAD_RTOL, atol=0)
    np.testing.assert_allclose(cl.numpy(), cl_x, rtol=LOAD_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the hierarchical fleet
# ---------------------------------------------------------------------------

def hier_fleets(scenario, options, congestion, rate=40.0, n_edge=4, horizon_ms=9000.0):
    c = dict(enabled=True, drain=0.5) if congestion else {}
    kw = dict(n_edge=n_edge, n_cloud=1, n_services=5, n_variants=10)
    scn_r, scn_p = R.get_scenario(scenario), P.get_scenario(scenario)
    if scenario == "mega-city":
        scn_r = dataclasses.replace(scn_r, rate_per_edge_per_s=rate)
        scn_p = dataclasses.replace(scn_p, rate_per_edge_per_s=rate)
    base = dict(horizon_ms=horizon_ms)
    if scenario == "paper-default":
        base.update(arrival_rate_per_s=40.0, delay_req_ms=6000.0, acc_req_std=10.0)
    ref = R.simulate_fleet(
        R.demo_cluster_spec(**kw), R.SimConfig(**base, congestion=R.CongestionConfig(**c)),
        policy="gus", scenario=scn_r, n_rep=2, seed=0,
        options=R.EngineOptions(scheduler="hierarchical", **options),
    )
    got = P.simulate_fleet(
        P.demo_cluster_spec(**kw), P.SimConfig(**base, congestion=P.CongestionConfig(**c)),
        policy="gus-hier", scenario=scn_p, n_rep=2, seed=0, device="cpu",
        options=P.EngineOptions(scheduler="hierarchical", **options),
    )
    return ref, got


def assert_hier_equal(ref, got, congestion):
    assert (got.n_rep, got.n_frames, got.window) == (ref.n_rep, ref.n_frames, ref.window)
    assert got.n_requests == ref.n_requests and got.n_served == ref.n_served
    np.testing.assert_array_equal(got.satisfied_per_rep, ref.satisfied_per_rep)
    np.testing.assert_array_equal(got.mean_us_per_rep, ref.mean_us_per_rep)
    if congestion:
        assert ref.final_backlog_per_rep.sum() > 0  # the carry fed back
        np.testing.assert_allclose(got.final_backlog_per_rep, ref.final_backlog_per_rep,
                                   rtol=BACKLOG_RTOL, atol=0)
        np.testing.assert_allclose(got.mean_compute_inflation, ref.mean_compute_inflation,
                                   rtol=BACKLOG_RTOL)
    else:
        assert got.final_backlog_per_rep is None and got.mean_compute_inflation == 1.0


@pytest.mark.parametrize("congestion", [False, True], ids=["off", "drain"])
@pytest.mark.parametrize("scenario,options", [
    ("mega-city", dict(window=1, prefetch=2)),               # streamed lazily
    ("mega-city", dict(window=None, prefetch=0)),            # one-shot stream
    ("paper-default", dict(window=2, prefetch=2, rng_mode="paper-default")),
], ids=["mega-lazy", "mega-materialized", "paper-default"])
def test_hier_fleet_matches_reference(scenario, options, congestion):
    ref, got = hier_fleets(scenario, options, congestion)
    assert_hier_equal(ref, got, congestion)
    assert 0 < got.n_served < got.n_requests
    assert {"fleet/hier_build", "fleet/hier_aggregate", "fleet/hier_post",
            "fleet/dispatch", "total_s"} <= set(got.timings)


def test_hier_fleet_composition_errors():
    spec, cfg = P.demo_cluster_spec(), P.SimConfig(horizon_ms=6000.0)
    hier = P.EngineOptions(scheduler="hierarchical")
    with pytest.raises(ValueError, match="does not compose"):
        P.simulate_fleet(spec, cfg, policy="random", n_rep=1, options=hier, device="cpu")
    with pytest.raises(ValueError, match="unknown GUS backend"):
        P.simulate_fleet(spec, cfg, n_rep=1, device="cpu",
                         options=P.EngineOptions(scheduler="hierarchical", backend="xla"))
    for backend in ("torch", "cuda"):  # the CPU takes the plain allocator either way
        fr = P.simulate_fleet(spec, cfg, n_rep=1, device="cpu",
                              options=P.EngineOptions(scheduler="hierarchical", backend=backend))
        assert fr.n_requests > 0
