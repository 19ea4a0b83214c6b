"""The port's serve -> schedule loop (``repro_torch.launch.serve_edge``, the
port of ``examples/serve_edge.py``) on the CPU.

A few-step run trains the three zoo variants, measures them and schedules
with the three raw callables.  Latencies are measured, so they cannot equal
the reference's: the cluster the port built from its measurements goes
into both packages' ``simulate``, and every ``SimResult`` field must be
equal for ``gus_schedule_np``, ``local_all`` and ``offload_all``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402

from repro_torch.launch import serve_edge  # noqa: E402

STEPS = 40


@pytest.fixture(scope="module")
def run():
    return serve_edge.main(STEPS, device="cpu")


def _reference(spec, cfg):
    rspec = R.ClusterSpec(
        n_edge=spec.n_edge, n_cloud=spec.n_cloud, gamma_frame=spec.gamma_frame,
        eta_frame=spec.eta_frame, proc_ms=spec.proc_ms, placed=spec.placed, acc=spec.acc,
    )
    rcfg = R.SimConfig(
        horizon_ms=cfg.horizon_ms, arrival_rate_per_s=cfg.arrival_rate_per_s,
        delay_req_ms=cfg.delay_req_ms, acc_req_mean=cfg.acc_req_mean,
        frame_ms=cfg.frame_ms, queue_cap=cfg.queue_cap,
    )
    return rspec, rcfg


REFERENCE = {  # the example's callables (examples/serve_edge.py:126-130)
    "GUS": R.gus_schedule_np,
    "local-all": lambda i: R.local_all(i),
    "offload-all": lambda i: R.offload_all(i, jnp.arange(3) >= 2),
}


def _same_as_reference(got, spec, cfg, name):
    rspec, rcfg = _reference(spec, cfg)
    want = R.simulate(rspec, rcfg, REFERENCE[name], seed=1)
    assert got.as_dict() == want.as_dict()
    assert got.bandwidth_estimates == want.bandwidth_estimates
    for f in ("n_requests", "n_served", "n_satisfied", "n_local", "n_cloud",
              "n_edge_offload", "n_dropped"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_requests > 0


@pytest.mark.parametrize("name", list(REFERENCE))
def test_the_measured_table_schedules_as_in_the_reference(run, name):
    _same_as_reference(run["results"][name], run["spec"], run["simcfg"], name)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_the_unscaled_table_schedules_as_in_the_reference(run, name):
    """The example's own cluster, from the measured times as they are."""
    _same_as_reference(run["results_measured"][name], run["spec_measured"],
                       run["simcfg_measured"], name)


def test_the_example_claims_and_the_cluster(run):
    variants, spec, cfg = run["variants"], run["spec"], run["simcfg"]
    assert [v["arch"] for v in variants] == ["squeeze-lm", "mid-lm", "google-lm"]
    assert max(v["acc"] for v in variants) > 30.0
    assert run["results"]["GUS"].as_dict()["satisfied_pct"] >= 50.0
    for v in variants:
        assert np.isfinite(v["loss1"]) and v["loss1"] < v["loss0"]
        assert v["total_ms"] > 0 and v["flash_launches"] == v["decode_launches"] == 0  # CPU
    # the measured ladder, placed at the paper's testbed scale
    measured = np.array([v["total_ms"] for v in variants])
    edge = measured * (serve_edge.PAPER_EDGE_MS / measured[0])
    np.testing.assert_allclose(spec.proc_ms[0, 0], edge.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(spec.proc_ms[2, 0], (edge * 300 / 1300).astype(np.float32),
                               rtol=1e-6)
    assert spec.placed[:2, :, 2].sum() == 0 and spec.placed[2].all()
    assert cfg.delay_req_ms == pytest.approx(4.0 * edge.max())
    assert cfg.acc_req_mean == pytest.approx(min(v["acc"] for v in variants) - 1.0)
    # the example's own cluster: the measured times unscaled
    spec_m, cfg_m = run["spec_measured"], run["simcfg_measured"]
    np.testing.assert_array_equal(spec_m.proc_ms[0, 0], measured.astype(np.float32))
    np.testing.assert_allclose(spec_m.proc_ms[2, 0],
                               (measured * 300 / 1300).astype(np.float32), rtol=1e-6)
    assert cfg_m.delay_req_ms == pytest.approx(4.0 * measured.max())


def test_a_trained_model_serves_under_no_grad():
    """Parameters that require a gradient (as a train step's leaves do)
    still generate: the engine runs under ``torch.no_grad()``."""
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_batch

    model, params, _, _ = serve_edge.train_variant(serve_edge.SQUEEZE_LM, 2, device="cpu")
    params = {k: v for k, v in params.items()}
    params["embed"] = params["embed"].detach().requires_grad_(True)
    eng = ServingEngine(model, params, device="cpu")
    batch = make_batch(model.cfg, 1, 8, np.random.default_rng(0), serve_edge.SOURCE,
                       device="cpu")
    r = eng.generate(batch, max_new_tokens=3)
    assert r.tokens.shape == (1, 3)
    assert 0.0 <= eng.eval_next_token_accuracy(batch) <= 1.0
