"""Multi-pod dry-run: every (architecture x input shape) on the production
meshes, with no device and no allocation.

The port's counterpart of ``repro/launch/dryrun.py``.  The reference lowers
and compiles each sharded step for 512 placeholder host devices and reads
XLA's cost analysis.  The port runs each step once, eagerly, as rank 0 of
a ``fake`` process group of 256 (16x16) or 512 (2x16x16) ranks, on
``FakeTensorMode`` tensors (shapes and dtypes, no storage): DTensor plans
every collective and runs rank 0's local ops on fake shards, and
:class:`~repro_torch.roofline.DeviceCounter` counts that rank's FLOPs,
bytes and collectives for the roofline table (``roofline.py``), on the
H100's rates.

The fake tensors are CPU tensors, so the attention and SSD calls run their
plain PyTorch versions (``kernels/ops.py``), not the Hopper kernels: the
counts are those of the plain path (the plain attention materializes its
scores), as the reference's CPU lowering counts its non-Pallas path.

The process group and its world size are fixed at the first collective, so
a dry-run runs in a process of its own (``python -m``), which
:func:`main` sets up.  The reference's loop correction
(``--no-loop-correct``) makes up for XLA:CPU counting a scanned layer
body once; an eager run counts every layer, so the flag is kept for the
command line and changes nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--multi-pod] [--out reports/dryrun]   # every arch x shape
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import traceback
import torch

from ..configs import ARCH_IDS, get_config, reduce_for_smoke
from ..models.model import Model
from ..roofline import DeviceCounter, roofline_terms
from .mesh import make_production_mesh, mesh_name
from .specs import SHAPES, model_flops, shape_config


#: the process's one FakeTensorMode: a tensor a run caches (the decode
#: masks' ``lru_cache``) stays valid in the next run of the same process
_FAKE_MODE = None


def init_fake_group(world_size: int) -> None:
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks (collectives plan and return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is already up; the "
                f"dry-run needs {world_size}: run it in a process of its own"
            )
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _real_strided_offsets() -> None:
    """DTensor works out a strided shard's sizes and offsets by running
    ``torch.arange`` over the dimension and reading the result back; under
    an active ``FakeTensorMode`` those tensors would be fake and the read
    would fail.  In this process (a dry-run's own), they run on real ones."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = getattr(_StridedShard, "local_shard_size_and_offset", None)
    if orig is None:
        raise RuntimeError(
            f"this torch ({torch.__version__}) has no _StridedShard.local_shard_size_and_offset "
            "to run on real tensors under FakeTensorMode; the dry-run cannot lay out strided "
            "shards"
        )
    if getattr(orig, "_real_offsets", False):
        return

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    real._real_offsets = True
    _StridedShard.local_shard_size_and_offset = real


def _fake_tree(tree):
    """A tree of ``meta`` tensors (``specs.py``) as CPU tensors of the
    active ``FakeTensorMode``."""
    from ..models.model import DecodeCache
    from .steps import _structured

    if isinstance(tree, (dict, list, DecodeCache)) or isinstance(tree, tuple) \
            and hasattr(tree, "_fields"):
        return _structured(tree, tree, lambda t, _: _fake_tree(t))
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    return tree


def run_counted(fn, args):
    """``fn(*args)`` once, counted: ``(result, DeviceCounter.counts())``."""
    counter = DeviceCounter()
    with counter:
        out = fn(*args)
    return out, counter.counts()


#: the meshes whose counts :func:`check_local_counts` has held
_CHECKED = set()


def check_local_counts(mesh) -> None:
    """Raise unless a pure data-parallel product over every rank of
    ``mesh`` counts rank 0's share of its FLOPs (global / ``mesh.size()``)
    and no collective: the counter sees the local ops, not DTensor's global
    ones.  Call it under the run's ``FakeTensorMode``; once a mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    key = (mesh.mesh_dim_names, tuple(mesh.shape))
    if key in _CHECKED:
        return
    B, K, N = mesh.size() * 8, 64, 32
    x = distribute_tensor(torch.empty(B, K), mesh, [Shard(0)] * mesh.ndim)
    w = distribute_tensor(torch.empty(K, N), mesh, [Replicate()] * mesh.ndim)
    _, counts = run_counted(lambda a, b: a @ b, (x, w))
    want = 2 * B * K * N // mesh.size()
    if counts["flops"] != want or counts["coll"]:
        raise RuntimeError(
            f"DeviceCounter counted {counts['flops']:.0f} FLOPs and {counts['coll']:.0f} "
            f"collective bytes for rank 0 of a data-parallel product on {mesh.size()} ranks; "
            f"its share is {want} FLOPs and none: the counts are not of the local ops"
        )
    _CHECKED.add(key)


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False, rules=None,
              cfg_patch=None, opt: bool = False, reduce: bool = False):
    """Run one (arch x shape) sharded step on the fake production mesh:
    ``(counts, report)``.

    ``cfg_patch`` (the perf variants) is applied after ``shape_config``.
    ``opt`` applies the reference's recommended settings: chunked attention
    and dots remat for train / prefill, the KV cache's sequence on
    ``model`` for decode where the KV heads cannot shard it.  ``reduce``
    runs ``reduce_for_smoke`` of the config (the CPU tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..sharding import DEFAULT_RULES
    from .steps import (
        SERVE_RULES,
        TRAIN_RULES,
        batch_shardings,
        build_prefill_step,
        build_serve_step,
        build_train_step,
        cache_shardings,
        distribute,
        params_shardings,
        state_shardings,
    )

    shape = SHAPES[shape_name]
    base = get_config(arch)
    cfg = shape_config(reduce_for_smoke(base) if reduce else base, shape)
    if opt:
        if shape.kind in ("train", "prefill"):
            cfg = dataclasses.replace(cfg, attn_impl="chunked", remat_policy="dots")
        elif cfg.num_kv_heads % 16 != 0:
            rules = dict(DEFAULT_RULES, kv_seq="model", **(rules or {}))
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    init_fake_group(512 if multi_pod else 256)
    _real_strided_offsets()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    model = Model(cfg)

    global _FAKE_MODE
    if _FAKE_MODE is None:
        _FAKE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    with _FAKE_MODE:
        check_local_counts(mesh)
        if shape.kind == "train":
            r = rules or TRAIN_RULES
            fn, (astate, aspecs) = build_train_step(model, mesh, shape, rules=rules)
            args = (distribute(_fake_tree(astate), state_shardings(model, mesh, r), mesh),
                    distribute(_fake_tree(aspecs), batch_shardings(cfg, aspecs, mesh, r), mesh))
            _, counts = run_counted(fn, args)
        else:
            r = rules or SERVE_RULES
            build = build_prefill_step if shape.kind == "prefill" else build_serve_step
            fn, (aparams, ain, acache) = build(model, mesh, shape, rules=rules)
            params = distribute(_fake_tree(aparams), params_shardings(model, mesh, r), mesh)
            cache = _fake_tree(acache)
            cache = distribute(cache, cache_shardings(model, acache, mesh, r), mesh)
            if shape.kind == "prefill":
                ins = distribute(_fake_tree(ain), batch_shardings(cfg, ain, mesh, r), mesh)
            else:  # one token against a cache of seq_len
                from .specs import decode_tokens_spec

                tok = decode_tokens_spec(shape)
                ins = distribute(_fake_tree(tok), batch_shardings(
                    cfg, {"t": tok}, mesh, r)["t"], mesh)
                cache = dataclasses.replace(cache, index=shape.seq_len - 1)
            with torch.no_grad():
                _, counts = run_counted(fn, (params, ins, cache))

    report = roofline_terms(
        arch=arch,
        shape=shape_name,
        mesh_name=mesh_name(mesh),
        n_devices=mesh.size(),
        counts=counts,
        model_flops_total=model_flops(cfg, shape),
        memory_analysis="fake tensors: no allocation measured",
    )
    return counts, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the reference's recommended settings (chunked attention, "
                         "dots remat, kv_seq on model for decode)")
    ap.add_argument("--reduce", action="store_true",
                    help="run reduce_for_smoke of each config (a quick check)")
    ap.add_argument("--no-loop-correct", dest="loop_correct", action="store_false",
                    help="kept from the reference; an eager run needs no loop correction")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{'2x16x16' if args.multi_pod else '16x16'}"
            if args.opt:
                tag += "__opt"
            t0 = time.time()
            try:
                _, report = lower_one(arch, shape, multi_pod=args.multi_pod, opt=args.opt,
                                      reduce=args.reduce)
                if args.opt:
                    report.mesh += "+opt"
                report.save(os.path.join(args.out, tag + ".json"))
                print(f"[OK {time.time()-t0:6.1f}s] {report.row()}", flush=True)
            except Exception:
                n_fail += 1
                print(f"[FAIL {time.time()-t0:6.1f}s] {tag}", flush=True)
                traceback.print_exc()
                if not args.continue_on_error:
                    return 1
    print(f"done: {len(archs)*len(shapes)-n_fail} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
