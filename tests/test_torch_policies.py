"""The port's policy registry, baselines, ordered/adaptive GUS and ILP/LP
oracles against the JAX reference, on the CPU.

The same frames (the golden fixtures and ``generate_batch`` instances,
padded and unpadded) go through each reference policy and its port.
Integer assignments are held to exact equality; the oracles' float bounds
are numpy float64 in both packages and held exactly too.  The port's
GUS-cored policies run their plain path here (the kernel wrapper takes it
on CPU tensors).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import aggregation as RA  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import aggregation as PA  # noqa: E402
from repro_torch.core import prng  # noqa: E402

FIXTURES = sorted((Path(__file__).parent / "fixtures").glob("gus_golden_*.npz"))
FIELDS = tuple(f.name for f in dataclasses.fields(P.FlatInstance))
SMALL = dict(n_requests=24, n_edge=4, n_cloud=1, n_services=12, n_variants=4)
TINY = dict(n_requests=7, n_edge=2, n_cloud=1, n_services=4, n_variants=3)
GUS_CORED = ("gus", "gus-ordered", "random", "offload_all", "local_all",
             "happy_computation", "happy_communication")
PRIORITIES = ("1", "0.5", "3", "random")


def leaves(inst) -> dict:
    return {k: np.asarray(getattr(inst, k)) for k in FIELDS}


def port(inst) -> P.FlatInstance:
    return P.FlatInstance.from_numpy(leaves(inst), "cpu")


def ref_from(arrays) -> "R.FlatInstance":
    return R.FlatInstance(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def frames():
    """(label, reference instance): the golden frames and generated ones."""
    out = [(p.stem, ref_from(np.load(p))) for p in FIXTURES]
    for seed in (0, 1, 2):
        out.append((f"gen{seed}", R.generate_instance(seed, R.GeneratorConfig(**SMALL))))
    return out


FRAMES = frames()
FRAME_IDS = [label for label, _ in FRAMES]


def assert_same(got_j, got_l, ref, label=""):
    np.testing.assert_array_equal(np.asarray(got_j), np.asarray(ref.j), err_msg=f"{label}: j")
    np.testing.assert_array_equal(np.asarray(got_l), np.asarray(ref.l), err_msg=f"{label}: l")


def n_edge_of(inst) -> int:
    M = inst.acc.shape[-2]
    return M - 1


def test_registry_matches_the_reference():
    assert P.list_policies() == R.list_policies()
    for name in R.list_policies():
        r, p = R.get_policy(name), P.get_policy(name)
        for field in ("needs_key", "vmappable", "pad", "max_requests", "kind", "stateful"):
            assert getattr(p, field) == getattr(r, field), (name, field)
    assert P.ILP_DEFAULT_MAX_REQUESTS == 24 and P.ILP_DEFAULT_NODE_LIMIT == 200_000
    with pytest.raises(KeyError, match="unknown policy"):
        P.get_policy("no-such-policy")


def _run_both(name, inst_r, key=None):
    """One frame through the reference policy and the port's (a batch of
    one for the batched policies)."""
    M = inst_r.acc.shape[-2]
    rfn = R.get_policy(name).bind(M - 1, M)
    pfn = P.get_policy(name).bind(M - 1, M)
    inst = port(inst_r)
    if name == "random":
        ref = rfn(inst_r, jnp.asarray(key))
        got = pfn(stack1(inst), np.asarray(key)[None])
    elif P.get_policy(name).vmappable:
        ref = rfn(inst_r)
        got = pfn(stack1(inst))
    else:
        ref = rfn(inst_r)
        got = pfn(inst)
        return got.j, got.l, ref
    return got.j[0], got.l[0], ref


def stack1(inst):
    return P.FlatInstance(**{f: getattr(inst, f)[None] for f in FIELDS})


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
@pytest.mark.parametrize("name", GUS_CORED)
def test_gus_cored_policy_matches_reference(name, frame, pad):
    label, inst_r = frame
    if pad:
        inst_r = R.pad_instance(inst_r, R.simulator._pad_bucket(inst_r.A.shape[0] + 1))
    key = jax.random.split(jax.random.PRNGKey(11), 2)[1]
    j, l, ref = _run_both(name, inst_r, key)
    assert_same(j, l, ref, f"{name}/{label}")


@pytest.mark.parametrize("name", ["gus-hier", "lp-bound"])
@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
def test_host_policy_matches_reference(name, frame):
    label, inst_r = frame
    j, l, ref = _run_both(name, inst_r)
    assert_same(j, l, ref, f"{name}/{label}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ilp_matches_solve_bnb(seed):
    inst_r = R.generate_instance(seed, R.GeneratorConfig(**TINY))
    inst = port(inst_r)
    ref_a, ref_v = R.solve_bnb(inst_r)
    got_a, got_v = P.solve_bnb(inst)
    assert got_v == ref_v
    assert_same(got_a.j, got_a.l, ref_a)
    j, l, ref = _run_both("ilp", inst_r)
    assert_same(j, l, ref, "ilp policy")
    assert_same(j, l, ref_a, "ilp policy vs solve_bnb")
    if seed == 0:
        ex_r, ex_v = R.solve_exhaustive(R.generate_instance(0, R.GeneratorConfig(
            **{**TINY, "n_requests": 3})))
        ex, v = P.solve_exhaustive(port(R.generate_instance(0, R.GeneratorConfig(
            **{**TINY, "n_requests": 3}))))
        assert v == ex_v
        assert_same(ex.j, ex.l, ex_r)


def test_ilp_refuses_oversized_frames():
    inst = port(R.generate_instance(0, R.GeneratorConfig(**SMALL)))
    fn = P.get_policy("ilp").bind(4, 5)
    with pytest.raises(ValueError, match="refuses a 24-request frame"):
        P.make_ilp_policy(max_requests=23).bind(4, 5)(inst)
    empty = dataclasses.replace(inst, **{
        f: getattr(inst, f)[:0] for f in ("cover", "A", "C", "w_a", "w_c", "acc", "ctime",
                                          "v", "u", "avail")})
    a = fn(empty)
    assert a.j.shape == (0,) and a.j.dtype == torch.int32


@pytest.mark.parametrize("frame", FRAMES[-3:], ids=FRAME_IDS[-3:])
def test_lagrangian_bound_matches_reference(frame):
    _, inst_r = frame
    inst = port(inst_r)
    assert P.lagrangian_bound(inst, n_iter=40) == R.lagrangian_bound(inst_r, n_iter=40)
    rb, rlam, rmu = R.lagrangian_dual(inst_r, n_iter=25)
    pb, plam, pmu = P.lagrangian_dual(inst, n_iter=25)
    assert pb == rb
    np.testing.assert_array_equal(plam, rlam)
    np.testing.assert_array_equal(pmu, rmu)
    ref = R.price_directed_greedy(inst_r, rlam, rmu)
    got = P.price_directed_greedy(inst, plam, pmu)
    assert_same(got.j, got.l, ref)


@pytest.mark.parametrize("kind", PRIORITIES)
@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
def test_ordered_with_priority(frame, kind):
    label, inst_r = frame
    N = inst_r.A.shape[0]
    if kind == "random":
        prio = np.random.default_rng(3).uniform(0.05, 4.0, N).astype(np.float32)
    else:
        prio = np.full(N, float(kind), np.float32)
    ref = R.gus_schedule_ordered(inst_r, jnp.asarray(prio))
    got = P.gus_schedule_ordered(port(inst_r), torch.from_numpy(prio), device="cpu")
    assert_same(got.j, got.l, ref, f"{label}/{kind}")
    # a batch of frames, each with its own priorities, in one call
    batch = P.stack_instances([port(inst_r)] * 2)
    prios = np.stack([prio, prio[::-1].copy()])
    got_b = P.gus_schedule_ordered(batch, torch.from_numpy(prios), device="cpu")
    assert_same(got_b.j[0], got_b.l[0], ref)
    ref1 = R.gus_schedule_ordered(inst_r, jnp.asarray(prios[1]))
    assert_same(got_b.j[1], got_b.l[1], ref1)


def test_best_us_per_request():
    for _, inst_r in FRAMES:
        got = P.best_us_per_request(port(inst_r)).numpy()
        np.testing.assert_array_equal(got, np.asarray(R.best_us_per_request(inst_r)))


def _carry_pair(M, seed):
    """A non-trivial carry: EMA over 1 on some servers, one server down."""
    rng = np.random.default_rng(seed)
    ema = rng.uniform(0.0, 2.5, M).astype(np.float32)
    up = np.ones(M, np.float32)
    up[rng.integers(0, M)] = 0.0
    ref = dataclasses.replace(R.init_policy_carry(M), ema_util=jnp.asarray(ema),
                              server_up=jnp.asarray(up))
    got = P.fleet_policy_carry(1, M, device="cpu")
    got = dataclasses.replace(got, ema_util=torch.from_numpy(ema)[None],
                              server_up=torch.from_numpy(up)[None])
    return ref, got, ema, up


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
def test_adaptive_with_a_carry(frame, seed):
    label, inst_r = frame
    M = inst_r.acc.shape[-2]
    rc, pc, ema, up = _carry_pair(M, seed)
    assert (ema > 1.0).any()
    ref, _ = R.get_policy("gus-adaptive").bind(M - 1, M)(inst_r, rc)
    got, _ = P.get_policy("gus-adaptive").bind(M - 1, M)(stack1(port(inst_r)), pc)
    assert_same(got.j[0], got.l[0], ref, label)
    down = int(np.flatnonzero(up == 0)[0])
    assert not bool((got.j == down).any())


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_random_with_keys_from_a_seed(seed):
    """A batch of frames, each with the key of its (replication, frame)
    slot, against the reference's ``random_assignment`` frame by frame."""
    insts = [R.generate_instance(s, R.GeneratorConfig(**SMALL)) for s in range(4)]
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    batch = P.stack_instances([port(i) for i in insts])
    got = P.get_policy("random").bind(4, 5)(batch, prng.split(prng.PRNGKey(seed), 4))
    for b, (inst_r, k) in enumerate(zip(insts, keys)):
        ref = R.random_assignment(inst_r, k)
        assert_same(got.j[b], got.l[b], ref, f"frame {b}")
        one = P.random_assignment(port(inst_r), np.asarray(k), device="cpu")
        assert_same(one.j, one.l, ref, f"unbatched {b}")


def test_baseline_functions_match_reference():
    inst_r = R.generate_instance(5, R.GeneratorConfig(**SMALL))
    inst = port(inst_r)
    cloud = np.arange(5) >= 4
    pairs = [
        (R.offload_all(inst_r, jnp.asarray(cloud)), P.offload_all(inst, cloud, device="cpu")),
        (R.local_all(inst_r), P.local_all(inst, device="cpu")),
        (R.happy_computation(inst_r), P.happy_computation(inst, device="cpu")),
        (R.happy_communication(inst_r), P.happy_communication(inst, device="cpu")),
    ]
    for ref, got in pairs:
        assert_same(got.j, got.l, ref)
    assert sorted(P.BASELINES) == sorted(R.BASELINES)


@pytest.mark.parametrize("decimals", [None, 0, -2])
@pytest.mark.parametrize("seed", [0, 4])
def test_aggregate_instance_decimals(seed, decimals):
    cfg = R.GeneratorConfig(**{**SMALL, "n_requests": 16})
    inst_r = R.generate_instance(seed, cfg)
    rep = {f: (jnp.repeat(getattr(inst_r, f), 3, axis=0) if f in P.extensions.ROW_FIELDS
               else getattr(inst_r, f)) for f in FIELDS}
    inst_r = R.FlatInstance(**rep)
    ref = RA.aggregate_instance(inst_r, decimals=decimals)
    got = PA.aggregate_instance(port(inst_r), decimals=decimals)
    for f in ("count", "first_idx", "members", "offsets", "cover", "us", "feas", "v", "u"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
def test_hier_assign_matches_reference(frame, exact):
    label, inst_r = frame
    rep = {f: (jnp.repeat(getattr(inst_r, f), 2, axis=0) if f in P.extensions.ROW_FIELDS
               else getattr(inst_r, f)) for f in FIELDS}
    inst_r = R.FlatInstance(**rep)
    agg_r = RA.aggregate_instance(inst_r)
    agg = PA.aggregate_instance(port(inst_r))
    g, e = np.asarray(inst_r.gamma), np.asarray(inst_r.eta)
    np.testing.assert_array_equal(PA.hier_assign(agg, g, e, exact=exact),
                                  RA.hier_assign(agg_r, g, e, exact=exact), err_msg=label)
    got = P.hier_schedule_np(port(inst_r))
    assert_same(got.j, got.l, RA.hier_schedule_np(inst_r), label)
    got = P.make_gus_hier(decimals=0)(port(inst_r))
    assert_same(got.j, got.l, RA.make_gus_hier(decimals=0)(inst_r), label)
