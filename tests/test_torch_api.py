"""The port's public names and signatures against the reference's.

Every name that a reference subpackage exports is on the port's
counterpart, or stands in :data:`DIFFERENCES` below with the reason: a
deliberate difference of the port, or an item still to port, by its
``ROADMAP.md`` §1 number.  A name that the port gains must leave this
list, and a name that the reference gains must be ported or listed.

Every signature of the reference's public surface is the port's too:
parameter names, order, kinds and defaults, compared by
``inspect.signature``.  The surface is every ``__all__`` callable of
:data:`SUBPACKAGES`, every public method of an exported class, and every
public function defined in a reference module whose counterpart in the
port defines it too (``models.layers.attn_decl``, which ``models``
does not export).  Each deliberate difference stands in
:data:`SIGNATURE_DIFFERENCES` with its reason; a keyword the port adds
comes after the reference's parameters, which keep their names, order,
kinds and defaults.  Behaviour tests of the restored parameters follow.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import json
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SUBPACKAGES = [
    "core", "obs", "serving", "models", "training", "configs", "kernels.ops", "launch",
    "sharding", "roofline",
]

DIFFERENCES = {
    "core": {
        # the GUS and class-allocator backend dispatch lives with the kernels,
        # with the port's backends ("torch" | "cuda" for "xla" | "pallas"):
        # kernels/gus.py (gus_assign, gus_assign_ref) and
        # core/options.py::resolve_backend for the first two ...
        "resolve_gus_backend",
        "gus_backend_fn",
        # ... and kernels/hier.py (hier_cells, hier_cells_ref) for the
        # allocator; the port has no numpy allocator (the plain PyTorch
        # version on the CPU is the reference path)
        "hier_cells",
        "hier_cells_np",
        "hier_backend_fn",
        # not a name: with rep_group=None the port cuts the fleet's
        # replications into one group a device (ceil(n_rep / devices)), the
        # reference into groups of FLEET_REP_GROUP = 8 (one compiled program
        # for XLA); rep_group=8 gives the reference's layout, and the
        # results do not depend on the width
    },
    "models": {
        # the reference stacks the layer leaves (init_from_decl(..., stack=));
        # the port keeps one dict per layer (layers.init_tree) and converts
        # in models/carry.py
        "init_from_decl",
    },
    "kernels.ops": {
        "on_tpu",             # TPU only: the port's route follows the tensors' device
    },
    "sharding": {
        # a jax NamedSharding; the port's counterpart gives the DTensor
        # placements of the same layout (sharding.placements_for)
        "named_sharding_for",
    },
    "roofline": {
        # the TPU v5e's rates; the port's spec is the H100's (roofline.H100)
        "V5E",
    },
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_reference_name_is_ported_or_listed(sub):
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    listed = DIFFERENCES.get(sub, set())
    missing = [n for n in ref.__all__ if not hasattr(port, n) and n not in listed]
    assert not missing, f"repro_torch.{sub} lacks {missing}"
    stale = sorted(n for n in listed if hasattr(port, n) or n not in ref.__all__)
    assert not stale, f"listed as differences but ported or not exported: {stale}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_the_port_exports_what_it_lists(sub):
    port = importlib.import_module(f"repro_torch.{sub}")
    assert all(hasattr(port, n) for n in port.__all__)


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

#: the packages whose signatures are compared, each with every module under it
SIGNATURE_PACKAGES = ["core", "obs", "serving", "models", "training", "configs", "kernels",
                      "launch", "sharding", "roofline"]


def added(*names, why):
    """A difference that adds the parameters ``names`` after the
    reference's, which keep their names, order, kinds and defaults."""
    return ("added", names, why)


def other(why):
    """Another difference, with its reason."""
    return ("other", (), why)


DEVICE = ("the device the entry point runs on: the port's entry points default to CUDA "
          "and the tests pass the CPU")

EAGER = ("F1: the host paths take libm's powf, as the reference's eager XLA does, where the "
         "jitted fleets square (core/queueing.py::libm_pow)")
KERNEL_WRAPPER = ("the kernel module's wrapper: the Pallas tile sizes and interpret mode are "
                  "not taken (the Hopper kernel fixes its own tiles; CPU tensors take the plain "
                  "version), backend= picks the route and out= takes an output view; the model "
                  "layout's kernels.ops function keeps the tile sizes, taken and not read")
DEPRECATED = ("the deprecated per-call engine keywords (streaming=, rng_mode=, backend=, ...) "
              "are not ported: EngineOptions takes them, and tools/lint_engine_api.py bars "
              "them from user code; device= follows options= (") + DEVICE + ")"

#: each deliberate difference of a signature, by the qualified name the
#: comparison gives it, with its reason
SIGNATURE_DIFFERENCES = {
    # core
    "core.Assignment.__init__": added(
        "loads", why="the committed (compute, comm) loads the scheduler summed for the "
        "assignment, in request order, which the congested paths read"),
    "core.FleetResult.__init__": added("device", why="the device the fleet ran on"),
    "core.comm_inflation": added("eager", why=EAGER),
    "core.compute_inflation": added("eager", why=EAGER),
    "core.predicted_inflation": added("eager", why=EAGER),
    "core.fleet_policy_carry": added("device", why=DEVICE),
    "core.generate_batch": added("device", why=DEVICE),
    "core.generate_instance": added("device", why=DEVICE),
    "core.gus_schedule": added("device", why=DEVICE),
    "core.gus_schedule_batch": added(
        "prio", "device", why="prio: gus-ordered's per-row priority weights, which the "
        "kernel's scaled entry multiplies into each row's utility; device: " + DEVICE),
    "core.gus_schedule_ordered": added("device", why=DEVICE),
    "core.happy_communication": added("device", why=DEVICE),
    "core.happy_computation": added("device", why=DEVICE),
    "core.init_policy_carry": added("device", why=DEVICE),
    "core.local_all": added("device", why=DEVICE),
    "core.offload_all": added("device", why=DEVICE),
    "core.random_assignment": added("device", why=DEVICE),
    "core.queueing.frame_metrics": added(
        "loads", why="the committed loads the scheduler already summed for this assignment, "
        "so the metric rows do not sum them again"),
    "core.resolve_backend": other(
        "resolves every kernel's backend on a device: device= second (the port's callers "
        "pass it by position) and var= naming the environment variable read; the "
        "reference's resolves the GUS backend alone, env= second"),
    "core.simulate": other(DEPRECATED),
    "core.simulate_fleet": other(DEPRECATED),
    # obs
    "obs.profile_trace": added(
        "device", why="the run's device: CUDA activity is traced only on a CUDA device"),
    # serving
    "serving.ServingEngine.__init__": added("device", why=DEVICE),
    "serving.ContinuousBatcher.__init__": added("device", why=DEVICE),
    # models
    "models.Model.init": other(
        "an int seed or a torch.Generator in place of a jax.random key, and device=: the "
        "port cannot draw jax.random's numbers, so parity goes through carried weights "
        "(models/carry.py)"),
    "models.Model.init_cache": added("device", why=DEVICE),
    "models.apply_moe": added(
        "grouped", why="one dispatch group a row for the per-row decode step of "
        "ContinuousBatcher, as the reference's vmapped batch-1 decode routes each slot "
        "alone (ROADMAP.md §3, MoE capacity per slot)"),
    "models.init_ssm_state": other(
        "dtype is a torch dtype (torch.float32 for jnp.float32), and device= follows"),
    "models.make_positions": added("device", why=DEVICE),
    # training
    "training.audio_stub_batch": added("device", why=DEVICE),
    "training.batch_iterator": added("device", why=DEVICE),
    "training.make_batch": added("device", why=DEVICE),
    "training.vision_stub_batch": added("device", why=DEVICE),
    "training.init_state": other(
        "key defaults to 0 and is an int seed or a torch.Generator (Model.init's), and "
        "device= follows"),
    # kernels
    "kernels.decode_attention.decode_attention": other(KERNEL_WRAPPER),
    "kernels.flash_attention.flash_attention": other(KERNEL_WRAPPER),
    "kernels.ssd_scan.ssd_scan": other(
        KERNEL_WRAPPER + "; and return_final_state= / initial_state=: the final state out "
        "and an initial state in, so that prefill and apply_mamba(ssm_state=) run on the "
        "kernel"),
    "kernels.ops.decode_attention": added(
        "backend", "scale", why="the model kernels' route: 'cuda' the Hopper kernel, 'torch' "
        "the plain version; scale: the softmax scale (default 1/sqrt(hd)), zamba2's "
        "(hd/2)^-1/2"),
    "kernels.ops.flash_attention": added(
        "backend", "scale", why="the model kernels' route: 'cuda' the Hopper kernel, 'torch' "
        "the plain version; scale: the softmax scale (default 1/sqrt(hd)), zamba2's "
        "(hd/2)^-1/2"),
    "kernels.ops.ssd": added(
        "return_final_state", "initial_state", "backend",
        why="the final state out and an initial state in, so that prefill and "
        "apply_mamba(ssm_state=) run on the kernel (the reference leaves its Pallas kernel "
        "for the plain ssd_reference there); backend as for the attention kernels"),
    # launch
    "launch.make_production_mesh": added(
        "device_type", why="the DeviceMesh's device type ('cuda'; 'cpu' for gloo groups)"),
    "launch.make_test_mesh": added(
        "device_type", why="the DeviceMesh's device type ('cuda'; 'cpu' for gloo groups)"),
    "launch.perf.run_variant": added("reduce", why="the variant on the reduced config (--reduce)"),
    "launch.serve.serve": added("device", why=DEVICE),
    "launch.train.train": added("device", why=DEVICE),
    "launch.dryrun.lower_one": other(
        "loop_correct= is not taken: the reference corrects XLA's cost of a scanned layer "
        "body, counted once; the port counts every op of the step below DTensor, so nothing "
        "is left to correct (the CLI flag stays, inert); reduce= added (--reduce)"),
    # roofline
    "roofline.HWSpec.__init__": other(
        "the defaults are the H100's (989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s NVLink one way) "
        "in place of the TPU v5e's"),
    "roofline.RooflineReport.__init__": added(
        "hw", "comm_counts", why="the card's name and the collectives counted by kind"),
    "roofline.collective_bytes": other(
        "takes the step's DTensor DeviceCounter in place of XLA's HLO text: the port has no "
        "HLO"),
    "roofline.roofline_terms": other(
        "counts= (the DTensor counter's FLOPs, bytes and collectives) in place of "
        "cost_analysis= and hlo_text=, and hw= defaults to the H100"),
}


def _unwrap(f):
    return f.__func__ if isinstance(f, (classmethod, staticmethod)) else f


def _surface(pkg):
    """``{name: (reference callable, port callable)}`` of one package, each
    reference function under its first name (the ``__all__`` one)."""
    out, seen = {}, set()

    def put(name, r, p):
        r, p = _unwrap(r), _unwrap(p)
        if callable(r) and callable(p) and id(r) not in seen:
            seen.add(id(r))
            out[name] = (r, p)

    for sub in (s for s in SUBPACKAGES if s.split(".")[0] == pkg):
        ref = importlib.import_module(f"repro.{sub}")
        port = importlib.import_module(f"repro_torch.{sub}")
        for n in ref.__all__:
            if not hasattr(port, n):
                continue  # a listed name (test_every_reference_name_is_ported_or_listed)
            r, p = getattr(ref, n), getattr(port, n)
            if inspect.isclass(r) and inspect.isclass(p):
                for m, rv in vars(r).items():
                    pv = inspect.getattr_static(p, m, None)
                    if (not m.startswith("_") or m == "__init__") and pv is not None \
                            and not isinstance(rv, property):
                        put(f"{sub}.{n}.{m}", rv, pv)
            elif not inspect.isclass(r):
                put(f"{sub}.{n}", r, p)
    root = importlib.import_module(f"repro.{pkg}")
    mods = [root] + ([importlib.import_module(m.name) for m in
                      pkgutil.walk_packages(root.__path__, f"repro.{pkg}.")]
                     if hasattr(root, "__path__") else [])
    for rm in mods:
        try:
            pm = importlib.import_module("repro_torch" + rm.__name__[len("repro"):])
        except ModuleNotFoundError:
            continue  # a module the port does not have (a Pallas kernel's)
        for n, rf in vars(rm).items():
            pf = vars(pm).get(n)
            if not n.startswith("_") and inspect.isfunction(rf) and rf.__module__ == rm.__name__ \
                    and inspect.isfunction(pf) and pf.__module__ == pm.__name__:
                put(f"{rm.__name__[len('repro.'):]}.{n}", rf, pf)
    return out


def _params(fn):
    return [(p.name, p.kind, repr(p.default)) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("pkg", SIGNATURE_PACKAGES)
def test_signatures_match_the_reference(pkg):
    surface = _surface(pkg)
    assert surface
    wrong = []
    for name, (r, p) in sorted(surface.items()):
        rp, pp = _params(r), _params(p)
        kind, names, _ = SIGNATURE_DIFFERENCES.get(name, ("same", (), ""))
        if kind == "same" and rp != pp:
            wrong.append(f"{name}: reference {rp}, port {pp}")
        elif kind == "added":
            kept = [x for x in pp if x[0] not in names]
            tail = [x[0] for x in pp[len(rp):]]
            if kept != rp or sorted(tail) != sorted(names):
                wrong.append(f"{name}: the port's {pp} is not the reference's {rp} + {names}")
        elif kind == "other" and rp == pp:
            wrong.append(f"{name}: listed as a difference, but the signatures are equal")
    assert not wrong, "\n".join(wrong)
    stale = sorted(n for n in SIGNATURE_DIFFERENCES if n.split(".")[0] == pkg
                   and n not in surface)
    assert not stale, f"listed but not on the compared surface: {stale}"


# ---------------------------------------------------------------------------
# the restored parameters, against the reference on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_generate_instance_as_numpy(seed):
    import repro.core as R

    import repro_torch.core as P

    cfg_r, cfg_p = R.GeneratorConfig(n_requests=24), P.GeneratorConfig(n_requests=24)
    want = R.generate_instance(seed, cfg_r, as_numpy=True)
    got = P.generate_instance(seed, cfg_p, as_numpy=True)
    on_cpu = P.generate_instance(seed, cfg_p, device="cpu")
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert isinstance(g, (np.ndarray, np.generic)), f.name
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
        np.testing.assert_array_equal(getattr(on_cpu, f.name).numpy(), g, err_msg=f.name)


@pytest.mark.parametrize("offset", [0, 5, "rows"])
def test_make_positions_offset(offset):
    import jax.numpy as jnp
    from repro.models import make_positions as ref_positions

    from repro_torch.models import make_positions

    B, S = 3, 7
    if offset == "rows":  # one start a row, as a (B, 1) array
        r_off, p_off = jnp.asarray([[0], [4], [9]]), torch.tensor([[0], [4], [9]])
    else:
        r_off = p_off = offset
    want = np.asarray(ref_positions(B, S, r_off))
    got = make_positions(B, S, p_off, device="cpu")
    assert tuple(got.shape) == (B, S) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(make_positions(B, S, device="cpu"), make_positions(B, S, 0))


def test_annotate_takes_keywords(tmp_path):
    """``annotate(name, **kwargs)``: the shared no-op with no profile
    active, as the reference's; under ``profile_trace`` a trace event named
    ``name`` whose args hold the keywords."""
    from repro.obs import annotate as ref_annotate

    from repro_torch.obs import annotate, profile_trace, profiling_active

    assert not profiling_active()
    assert annotate("idle", step=3) is annotate("idle")
    assert type(annotate("idle", step=3)) is type(ref_annotate("idle", step=3))  # nullcontext
    with annotate("idle", step=3):
        pass
    with profile_trace(tmp_path, device="cpu"):
        with annotate("fleet/probe", step=3, label="w0"):
            torch.ones(4).sum()
        with annotate("fleet/plain"):
            pass
    events = json.loads((tmp_path / "profile.pt.trace.json").read_text())["traceEvents"]
    probe = [e for e in events if e.get("name") == "fleet/probe"]
    assert probe and probe[0]["args"]["step"] == 3 and probe[0]["args"]["label"] == "w0"
    assert any(e.get("name") == "fleet/plain" for e in events)
