"""The port's dry-run machinery (``launch/specs.py``, ``launch/dryrun.py``,
``launch/perf.py``, ``roofline.py``) on the CPU.

The input specifications and model FLOPs equal the reference's for every
(architecture x shape).  ``python -m repro_torch.launch.dryrun`` runs a
reduced config on a fake 16x16 mesh in a process of its own (no device,
no allocation) and reports rank 0's FLOPs, not the global op's: a pure
data-parallel product counts its global FLOPs / 256.  The roofline
arithmetic is ``tests/test_roofline.py``'s on the H100's rates.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as ref_config  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.roofline import H100, RooflineReport, roofline_terms  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=os.pathsep.join([SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
TIMEOUT_S = 600


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_shape_config_and_flops_equal_the_references(arch):
    assert list(specs.SHAPES) == list(ref_specs.SHAPES)
    for name, shape in specs.SHAPES.items():
        rshape = ref_specs.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (rshape.seq_len, rshape.global_batch, rshape.kind)
        cfg = specs.shape_config(get_config(arch), shape)
        rcfg = ref_specs.shape_config(ref_config(arch), rshape)
        assert (cfg.sliding_window, cfg.remat) == (rcfg.sliding_window, rcfg.remat)
        got, want = specs.input_specs(cfg, shape), ref_specs.input_specs(rcfg, rshape)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), (arch, name, k)
        assert specs.model_flops(cfg, shape) == ref_specs.model_flops(rcfg, rshape)


def test_dryrun_of_a_reduced_config_on_a_fake_16x16_mesh(tmp_path):
    out = tmp_path / "dr"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-9b", "--shape",
         "decode_32k", "--reduce", "--out", str(out)],
        env=ENV, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: 1 ok, 0 failed" in proc.stdout
    rep = RooflineReport.load(str(out / "yi-9b__decode_32k__16x16.json"))
    assert rep.n_devices == 256 and rep.mesh == "16x16" and rep.hw == H100.name
    assert rep.flops_per_device > 0 and rep.bytes_per_device > 0
    # heads on `model`: the attention output's product is a partial sum, reduced
    assert rep.coll_breakdown["all-reduce"] > 0
    assert any("all_reduce" in k for k in rep.comm_counts)
    assert rep.bottleneck in ("compute", "memory", "collective")
    assert not rep.loop_corrected and rep.raw_flops_per_device == rep.flops_per_device


_DP_SCRIPT = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
import repro_torch.roofline as R
from repro_torch.launch.dryrun import check_local_counts, init_fake_group, run_counted
from repro_torch.launch.mesh import make_production_mesh
init_fake_group(256)
mesh = make_production_mesh(device_type="cpu")
B, K, N = 256 * 8, 512, 1024
with FakeTensorMode():
    # a planted fault first: a counter that also counts DTensor's shape
    # inference on the global tensors; the dry-run's self-check must refuse it
    real = R.DeviceCounter._wrap_propagator
    R.DeviceCounter._wrap_propagator = lambda self: None
    try:
        check_local_counts(mesh)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    R.DeviceCounter._wrap_propagator = real
    x = distribute_tensor(torch.empty(B, K), mesh, [Shard(0), Shard(0)])
    w = distribute_tensor(torch.empty(K, N), mesh, [Replicate(), Replicate()])
    _, counts = run_counted(lambda a, b: a @ b, (x, w))
print(json.dumps({"counts": counts, "global": 2 * B * K * N, "refused": refused}))
"""


@pytest.fixture(scope="module")
def dp_run():
    proc = subprocess.run([sys.executable, "-c", _DP_SCRIPT], env=ENV, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_per_device_flops_of_a_data_parallel_product(dp_run):
    """FLOPs are rank 0's local work (a count above DTensor would be the
    global product's), and a pure data-parallel product moves no
    collective."""
    res = dp_run
    assert res["counts"]["flops"] == res["global"] / 256
    assert res["counts"]["coll"] == 0 and not res["counts"]["comm_counts"]
    assert res["counts"]["bytes"] > 0


def test_dryrun_self_check_refuses_global_counts(dp_run):
    """With DTensor's shape inference counted (the patch of
    ``DeviceCounter._wrap_propagator`` taken out), ``check_local_counts``
    sees more than rank 0's share and raises."""
    assert dp_run["refused"] is not None and "not of the local ops" in dp_run["refused"]


def test_device_counter_patches_the_shape_inference(monkeypatch):
    """Entering the counter wraps at least one of DTensor's shape-inference
    methods and leaving it restores them; where none exists (another torch)
    it refuses to start instead of counting the global ops."""
    from torch.distributed.tensor import DTensor

    from repro_torch import roofline

    prop = DTensor._op_dispatcher.sharding_propagator
    names = roofline._PROPAGATOR_METHODS
    assert any(hasattr(prop, n) for n in names)
    own = {n: vars(prop).get(n) for n in names}
    with roofline.DeviceCounter() as c:
        assert c._patched
        for _, name, _ in c._patched:
            assert vars(prop).get(name) is not None and vars(prop)[name] is not own[name]
    assert {n: vars(prop).get(n) for n in names} == own
    monkeypatch.setattr(roofline, "_PROPAGATOR_METHODS", ("_no_such_method",))
    with pytest.raises(RuntimeError, match="shape-inference"):
        roofline.DeviceCounter().__enter__()


def test_perf_variants_run(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--arch", "yi-9b", "--shape",
         "decode_32k", "--variant", "baseline", "--variant", "kvseq_localtopk", "--reduce",
         "--out", str(tmp_path)],
        env=ENV, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    base = RooflineReport.load(str(tmp_path / "yi-9b__decode_32k__baseline.json"))
    kvseq = RooflineReport.load(str(tmp_path / "yi-9b__decode_32k__kvseq_localtopk.json"))
    # the plain route gathers a sequence-sharded cache: more collective bytes
    assert kvseq.coll_bytes_per_device > base.coll_bytes_per_device


def test_roofline_terms_bottleneck():
    rep = roofline_terms(
        arch="x", shape="s", mesh_name="16x16", n_devices=256,
        counts={"flops": 1e15, "bytes": 1e9, "coll": 640.0,
                "coll_breakdown": {"all-reduce": 512, "all-gather": 128}},
        model_flops_total=2.56e17,
    )
    assert rep.compute_s == 1e15 / H100.peak_flops
    assert rep.memory_s == 1e9 / H100.hbm_bw
    assert rep.collective_s == 640.0 / H100.link_bw
    assert rep.bottleneck == "compute"
    assert rep.useful_ratio == (2.56e17 / 256) / 1e15
    assert not rep.loop_corrected


def test_roofline_corrected_counts():
    rep = roofline_terms(
        arch="x", shape="s", mesh_name="16x16", n_devices=256,
        counts={"flops": 1e12, "bytes": 1e8, "coll": 0.0, "coll_breakdown": {}},
        model_flops_total=2.56e17,
        corrected_counts={"flops": 4e13, "bytes": 4e9, "coll": 123.0,
                          "coll_breakdown": {"all-gather": 123}},
    )
    assert rep.loop_corrected
    assert rep.flops_per_device == 4e13
    assert rep.raw_flops_per_device == 1e12
    assert rep.coll_bytes_per_device == 123.0
    assert rep.bottleneck == "compute"


def test_h100_spec_is_the_data_sheets():
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw) == (989e12, 3.35e12, 450e9)
    assert "H100" in H100.name and "700 W" in H100.name
