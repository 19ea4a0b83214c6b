"""Every GUS-cored policy on the Hopper GUS kernel against its plain
PyTorch version, on the card.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_policies_cuda.py

The scaled entry (``gus_assign_launch_scaled``, priority weights) and the
frames the policies hand the kernel (masked ``avail``, permuted rows,
shaded budgets) must give integer assignments and load sums equal to the
plain version's, with no mismatch allowed; the sequential testbed and the
keyed fleet on the card must equal the same calls on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.gus import gus_assign, gus_assign_ref  # noqa: E402

pytestmark = pytest.mark.gpu

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


def _prio(kind, shape, dev):
    if kind == "random":
        g = np.random.default_rng(7).uniform(0.05, 4.0, shape).astype(np.float32)
        return torch.from_numpy(g).to(dev)
    return torch.full(shape, float(kind), dtype=torch.float32, device=dev)


def _frames(dev, n, M, L, seed=0, B=4):
    cfg = P.GeneratorConfig(n_requests=n, n_edge=max(M - 1, 1), n_cloud=1, n_variants=L)
    return P.generate_batch(seed, B, cfg, device=dev)


@pytest.mark.parametrize("kind", ["1", "0.5", "3", "random"])
@pytest.mark.parametrize("shape", [(7, 10, 10), (257, 10, 10), (33, 40, 5), (40, 7, 3), (1, 2, 1)],
                         ids=lambda s: "NxMxL=" + "x".join(map(str, s)))
def test_scaled_entry_equals_plain(cuda, kind, shape):
    n, M, L = shape
    batch = _frames(cuda, n, M, L)
    B = batch.A.shape[0]
    prio = _prio(kind, (B, n), cuda)
    n0 = gus_assign.launches
    got = gus_assign(*_args(batch), prio)
    want = gus_assign_ref(*_args(batch), prio)
    torch.cuda.synchronize()
    assert gus_assign.launches == n0 + 1
    for g, w, name in zip(got, want, ("j", "l", "w", "c")):
        assert torch.equal(g, w), name


def test_unit_priority_equals_the_plain_entry(cuda):
    batch = P.generate_batch(3, 64, device=cuda)
    ones = torch.ones(batch.A.shape, dtype=torch.float32, device=cuda)
    a = gus_assign(*_args(batch), ones)
    b = gus_assign(*_args(batch))
    for g, w in zip(a, b):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["gus-ordered", "random", "offload_all", "local_all",
                                  "happy_computation", "happy_communication"])
def test_policy_kernel_equals_plain(cuda, name, monkeypatch):
    batch = P.generate_batch(1, 128, device=cuda)
    B, N, M, _ = batch.acc.shape
    fn = P.get_policy(name).bind(M - 1, M)
    keys = prng.split(prng.PRNGKey(5), B)
    call = (lambda: fn(batch, keys)) if name == "random" else (lambda: fn(batch))
    n0 = gus_assign.launches
    got = call()
    assert gus_assign.launches == n0 + 1
    monkeypatch.setenv("REPRO_TORCH_GUS_BACKEND", "torch")
    want = call()
    assert torch.equal(got.j, want.j) and torch.equal(got.l, want.l)


@pytest.mark.parametrize("kind", ["0.5", "random"])
def test_ordered_with_priority_on_the_card(cuda, kind, monkeypatch):
    batch = P.generate_batch(2, 64, device=cuda)
    prio = _prio(kind, batch.A.shape, cuda)
    n0 = gus_assign.launches
    got = P.gus_schedule_ordered(batch, prio, device=cuda)
    assert gus_assign.launches == n0 + 1
    monkeypatch.setenv("REPRO_TORCH_GUS_BACKEND", "torch")
    want = P.gus_schedule_ordered(batch, prio, device=cuda)
    assert torch.equal(got.j, want.j) and torch.equal(got.l, want.l)


def test_adaptive_with_a_carry_on_the_card(cuda, monkeypatch):
    batch = P.generate_batch(4, 32, device=cuda)
    B, N, M, _ = batch.acc.shape
    carry = P.fleet_policy_carry(B, M, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(0)
    carry = dataclasses.replace(
        carry,
        ema_util=(torch.rand((B, M), generator=g) * 2.0).to(cuda),
        server_up=(torch.arange(M) != 2).float().expand(B, M).contiguous().to(cuda),
    )
    fn = P.get_policy("gus-adaptive").bind(M - 1, M)
    got, _ = fn(batch, carry)
    monkeypatch.setenv("REPRO_TORCH_GUS_BACKEND", "torch")
    want, _ = fn(batch, carry)
    assert torch.equal(got.j, want.j) and torch.equal(got.l, want.l)
    assert not bool((got.j == 2).any())


@pytest.mark.parametrize("policy", ["gus", "gus-ordered", "random", "gus-adaptive",
                                    "offload_all", "ilp"])
def test_simulate_on_the_card_equals_the_cpu(cuda, policy):
    spec = P.demo_cluster_spec(n_edge=3, n_cloud=1)
    cfg = P.SimConfig(horizon_ms=15_000.0, delay_req_ms=6000.0, acc_req_std=10.0,
                      congestion=P.CongestionConfig(enabled=True, drain=0.5))
    n0 = gus_assign.launches
    g = P.simulate(spec, cfg, policy=policy, scenario="flash-crowd", device=cuda)
    launched = gus_assign.launches - n0
    c = P.simulate(spec, cfg, policy=policy, scenario="flash-crowd", device="cpu")
    assert g.as_dict() == c.as_dict()
    assert g.bandwidth_estimates == c.bandwidth_estimates
    assert (launched > 0) == (policy != "ilp")


@pytest.mark.parametrize("policy", ["random", "gus-ordered", "gus-adaptive"])
def test_keyed_and_ordered_fleet_on_the_card_equals_the_cpu(cuda, policy):
    spec = P.demo_cluster_spec()
    cfg = P.SimConfig(horizon_ms=15_000.0, arrival_rate_per_s=4.0, delay_req_ms=6000.0,
                      acc_req_std=10.0, congestion=P.CongestionConfig(enabled=True, drain=0.5))
    g = P.simulate_fleet(spec, cfg, policy=policy, n_rep=8, device=cuda)
    c = P.simulate_fleet(spec, cfg, policy=policy, n_rep=8, device="cpu")
    assert g.n_requests == c.n_requests and g.n_served == c.n_served
    np.testing.assert_array_equal(g.satisfied_per_rep, c.satisfied_per_rep)
    np.testing.assert_array_equal(g.final_backlog_per_rep, c.final_backlog_per_rep)
    np.testing.assert_allclose(g.mean_us_per_rep, c.mean_us_per_rep, rtol=1e-5, atol=1e-6)
