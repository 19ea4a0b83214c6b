"""Boundaries of the PyTorch/CUDA port, checked on the CPU.

* No module of ``repro_torch`` and not ``chip_smoke.py`` imports ``jax`` or
  anything of the JAX package ``repro`` (an AST scan, and a fresh
  interpreter that imports the whole port and finds no ``jax`` loaded).
* Entry points run on the card unless asked for the CPU: without a CUDA
  device, calling them without ``device=`` raises instead of running here.
* No fallback: a kernel build that fails raises, and the kernel wrapper
  refuses tensors that are on neither the CPU nor a CUDA device.
* The option precedence is explicit > environment > scenario > default.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import options as PO  # noqa: E402
from repro_torch.kernels import build as PB  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.gus import gus_assign  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.training import make_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = {m for m in _imported_roots(path) if m in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch").with_suffix("").parts)
        for p in PORT_FILES[:-1]
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")


def test_entry_points_without_device_raise_instead_of_running_on_cpu(no_cuda):
    inst = P.generate_instance(0, device="cpu")
    batch = P.stack_instances([inst, inst])
    calls = [
        lambda: P.generate_instance(0),
        lambda: P.generate_batch(0, 2),
        lambda: P.gus_schedule(inst),
        lambda: P.gus_schedule_batch(batch),
        lambda: P.simulate_fleet(P.demo_cluster_spec(), P.SimConfig(horizon_ms=3000.0), n_rep=1),
        lambda: P.simulate(P.demo_cluster_spec(), P.SimConfig(horizon_ms=3000.0)),
        lambda: P.simulate(P.demo_cluster_spec(), P.SimConfig(horizon_ms=3000.0), policy="ilp"),
        lambda: P.gus_schedule_ordered(inst),
        lambda: P.random_assignment(inst, np.zeros(2, np.uint32)),
        lambda: P.offload_all(batch, np.arange(10) >= 9),
        lambda: P.local_all(inst),
        lambda: P.happy_computation(batch),
        lambda: P.happy_communication(inst),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("helper", ["class_batch", "fleet_policy_carry", "init_policy_carry"])
def test_input_helpers_without_device_raise(no_cuda, helper):
    """The exported input builders resolve ``device=None`` to the card, as
    every entry point does; ``device="cpu"`` still builds on the CPU."""
    from repro_torch.core.aggregation import class_batch
    from repro_torch.core.queueing import fleet_policy_carry, init_policy_carry

    call = {
        "class_batch": lambda **kw: class_batch([P.generate_instance(0, device="cpu")], **kw),
        "fleet_policy_carry": lambda **kw: fleet_policy_carry(2, 3, **kw),
        "init_policy_carry": lambda **kw: init_policy_carry(3, **kw),
    }[helper]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    assert all(t.device.type == "cpu" for t in (out if helper == "class_batch" else (out.key,)))


def test_serving_entry_points_without_device_raise(no_cuda):
    cfg = get_config("squeeze-lm")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tree = {k: (v.numpy() if torch.is_tensor(v) else {n: t.numpy() for n, t in v.items()})
            for k, v in params.items() if k != "layers"}
    tree["layers"] = {
        blk: {n: np.stack([lp[blk][n].numpy() for lp in params["layers"]]) for n in p}
        for blk, p in params["layers"][0].items()
    }
    calls = [
        lambda: model.init(0),
        lambda: model.init_cache(1, 8),
        lambda: ServingEngine(model, params),
        lambda: serve("squeeze-lm"),
        lambda: make_batch(cfg, 1, 4, np.random.default_rng(0)),
        lambda: params_from_reference(cfg, tree),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert params_from_reference(cfg, tree, device="cpu")["layers"][1]["mlp"]["w_up"].shape == (
        cfg.d_model, cfg.d_ff)


def test_chip_smoke_fails_without_cuda(no_cuda, tmp_path):
    """Without a card it exits non-zero and prints no result; alone in a
    directory (no repository beside it) it fails as well."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(PB, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(PB, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        PB.build_libraries(["gus_assign"])
    assert not list(tmp_path.glob("*.so"))


def test_kernel_wrapper_refuses_other_devices():
    """On a tensor that is neither on the CPU nor on a CUDA device the
    wrapper raises; it never computes some other way."""
    B, N, M, L = 1, 2, 3, 2
    f = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    args = (torch.zeros((B, N), dtype=torch.int32, device="meta"), f(B, N), f(B, N),
            f(B, N), f(B, N), f(B, N, M, L), f(B, N, M, L), f(B, N, M, L), f(B, N, M, L),
            torch.zeros((B, N, M, L), dtype=torch.bool, device="meta"),
            f(B, M), f(B, M), f(B), f(B))
    n0 = gus_assign.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gus_assign(*args)
    assert gus_assign.launches == n0


def test_attention_wrappers_refuse_other_devices():
    q = torch.zeros((1, 4, 8, 16), device="meta")
    k = torch.zeros((1, 2, 8, 16), device="meta")
    valid = torch.ones((1, 8), dtype=torch.bool, device="meta")
    counts = counters.snapshot()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q, k, k, backend="cuda")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        decode_attention(q[:, :, 0].unflatten(1, (2, 2)), k, k, valid, backend="cuda")
    assert counters.delta(counts) == {}


def test_attention_backend_precedence(monkeypatch):
    monkeypatch.delenv(PO.ENV_MODEL_BACKEND, raising=False)
    assert PO.resolve_backend(None, torch.device("cuda"), var=PO.ENV_MODEL_BACKEND) == "cuda"
    monkeypatch.setenv(PO.ENV_MODEL_BACKEND, "torch")
    assert PO.resolve_backend(None, torch.device("cuda"), var=PO.ENV_MODEL_BACKEND) == "torch"
    assert PO.resolve_backend("cuda", torch.device("cuda"), var=PO.ENV_MODEL_BACKEND) == "cuda"
    assert PO.resolve_backend(None, torch.device("cuda")) == "cuda"  # GUS's own variable
    monkeypatch.setenv(PO.ENV_MODEL_BACKEND, "triton")
    with pytest.raises(ValueError, match="REPRO_TORCH_MODEL_BACKEND"):
        PO.resolve_backend(None, torch.device("cpu"), var=PO.ENV_MODEL_BACKEND)


def test_cpu_wrapper_takes_the_plain_version_without_counting():
    inst = P.generate_instance(1, device="cpu")
    n0 = gus_assign.launches
    a = P.gus_schedule(inst, backend="cuda", device="cpu")
    b = P.gus_schedule(inst, backend="torch", device="cpu")
    assert torch.equal(a.j, b.j) and torch.equal(a.l, b.l)
    assert gus_assign.launches == n0


def test_backend_precedence(monkeypatch):
    monkeypatch.delenv(PO.ENV_BACKEND, raising=False)
    assert PO.resolve_backend(None, torch.device("cpu")) == "torch"
    assert PO.resolve_backend(None, torch.device("cuda")) == "cuda"
    monkeypatch.setenv(PO.ENV_BACKEND, "cuda")
    assert PO.resolve_backend(None, torch.device("cpu")) == "cuda"
    assert PO.resolve_backend("torch", torch.device("cpu")) == "torch"
    monkeypatch.setenv(PO.ENV_BACKEND, "xla")
    with pytest.raises(ValueError, match="REPRO_TORCH_GUS_BACKEND"):
        PO.resolve_backend(None, torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown GUS backend"):
        PO.resolve_backend("pallas")


def test_options_precedence():
    fc = P.get_scenario("flash-crowd")
    assert PO.resolve_options(None, fc, env={}).rng_mode == "paper-default"
    env = {PO.ENV_RNG_MODE: "vectorized"}
    assert PO.resolve_options(None, fc, env=env).rng_mode == "vectorized"
    explicit = P.EngineOptions(rng_mode="paper-default")
    assert PO.resolve_options(explicit, fc, env=env).rng_mode == "paper-default"
    opts = PO.resolve_options(P.EngineOptions(prefetch=-3), fc, env={})
    assert opts.prefetch == 0 and opts.scheduler == "dense" and opts.streaming is False
    assert PO.resolve_options(opts, fc, env={}) == opts
    with pytest.raises(ValueError):
        PO.resolve_options(P.EngineOptions(window=0), fc, env={})
    with pytest.raises(ValueError):
        PO.resolve_options(None, fc, env={PO.ENV_SCHEDULER: "sparse"})


def test_generate_instance_is_seed_deterministic():
    a, b = P.generate_instance(3, device="cpu"), P.generate_instance(3, device="cpu")
    for k, v in a.numpy().items():
        np.testing.assert_array_equal(v, b.numpy()[k], err_msg=k)
