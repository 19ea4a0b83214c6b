"""One rank of the port's sharded steps on the CPU, for
``tests/test_torch_steps_dist.py``.

Run as ``python tests/torch_dist_worker.py STORE RANK WORLD OUT [REF]``:
joins a ``gloo`` process group of WORLD ranks through the ``FileStore`` at
STORE, and on every mesh of that world size (2 ranks: 1x2 and 2x1; 4
ranks: 2x2) runs, for its reduced configs (:data:`MESHES`), the sharded
prefill step and serve steps of ``repro_torch.launch.steps`` and one
sharded train step.  Every rank gathers the results to whole tensors;
rank 0 writes them to ``OUT/<mesh>-<arch>.pt``.  With REF (4 ranks), the
2x2 train step also starts from the reference's parameters in that npz
and its result goes to ``OUT/2x2-reference.pt``.  Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ARCHS = ("yi-9b", "mamba2-130m", "zamba2-1.2b", "qwen2-moe-a2.7b", "seamless-m4t-medium",
         "pixtral-12b")
#: each world size's meshes and the configs run on each: tensor parallel
#: (1x2) and both axes (2x2) every config (every family: dense, ssm,
#: hybrid, moe, encdec, vlm), data parallel alone (2x1) the dense and the
#: MoE ones (the batch split of the MoE dispatch)
MESHES = {2: (((1, 2), ARCHS), ((2, 1), ("yi-9b", "qwen2-moe-a2.7b"))),
          4: (((2, 2), ARCHS),)}
B, S, GEN = 4, 24, 4


def config(arch: str):
    from repro_torch.configs import get_config, reduce_for_smoke

    return dataclasses.replace(reduce_for_smoke(get_config(arch)), dtype="float32",
                               param_dtype="float32")


def ref_config():
    """The dense config of the reference's own sharded train-step test
    (``tests/test_sharding.py``), for the step held against the
    reference's ``build_train_step``."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=256, scan_layers=True)


def inputs(cfg):
    """The parameters and a batch, the same on every rank (and in the test).

    The encoder-decoder's q/k/v are rescaled to a fan-in of d_model, as
    ``chip_smoke.py`` phase 15b rescales them: at the reference's init its
    three sharp attentions a decoder layer leave its float32 train step
    7.5e-3 from the same step in float64 in the gradient norm (96% of the
    embedding's first moment outside the moments' tolerance), so no limit
    would tell a sharded fault from float32 rounding; rescaled, 8e-8."""
    from repro_torch.models.model import Model
    from repro_torch.training import make_batch

    params = Model(cfg).init(0, device="cpu")
    if cfg.family == "encdec":
        with torch.no_grad():
            for stack in ("enc_layers", "dec_layers"):
                for lp in params[stack]:
                    for attn in (lp[b] for b in ("attn", "xattn") if b in lp):
                        for name, fan_in in (("w_q", cfg.num_heads), ("w_k", cfg.num_kv_heads),
                                             ("w_v", cfg.num_kv_heads)):
                            attn[name].mul_((fan_in / cfg.d_model) ** 0.5)
    batch = make_batch(cfg, B, S, np.random.default_rng(0), device="cpu")
    return params, batch


def whole(tree):
    """Every DTensor of a tree as its whole tensor (a collective: every rank
    calls it)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(whole(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def serve_case(model, mesh, params, batch):
    """Greedy tokens of the sharded prefill step and GEN - 1 serve steps,
    and the prefill logits under the serve rules."""
    from repro_torch.launch import steps as st
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.sharding import use_sharding

    cfg = model.cfg
    shape = ShapeSpec("case", S, B, "prefill")
    prefill, (_, aspecs, _) = st.build_prefill_step(model, mesh, shape)
    serve, _ = st.build_serve_step(model, mesh, ShapeSpec("case", S, B, "decode"))
    p = st.distribute(params, st.params_shardings(model, mesh, st.SERVE_RULES), mesh)
    b = {k: batch[k] for k in aspecs}
    b = st.distribute(b, st.batch_shardings(cfg, b, mesh, st.SERVE_RULES), mesh)

    def cache():
        c = model.init_cache(B, S + GEN, device="cpu")
        return st.distribute(c, st.cache_shardings(model, c, mesh, st.SERVE_RULES), mesh)

    with torch.no_grad():
        with use_sharding(mesh, st.SERVE_RULES):
            logits, _ = model.prefill(p, b, cache())
        tok, c = prefill(p, b, cache())
        toks = [tok]
        for _ in range(GEN - 1):
            tok, c = serve(p, tok, c)
            toks.append(tok)
    return {"logits": whole(logits), "tokens": torch.cat([whole(t) for t in toks], 1)}


def train_case(model, mesh, params, batch):
    """One sharded train step from ``params``: the new parameters, the
    moments and the metrics, whole."""
    from repro_torch.launch import steps as st
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.training import TrainState, adamw_init

    fn, (_, aspecs) = st.build_train_step(model, mesh, ShapeSpec("case", S, B, "train"))
    state = TrainState(params, adamw_init(params))
    state = st.distribute(state, st.state_shardings(model, mesh, st.TRAIN_RULES), mesh)
    b = {k: batch[k] for k in aspecs}
    b = st.distribute(b, st.batch_shardings(model.cfg, b, mesh, st.TRAIN_RULES), mesh)
    new, metrics = fn(state, b)
    return {"params": whole(new.params), "m": whole(new.opt.m), "v": whole(new.opt.v),
            "metrics": {k: whole(v) for k, v in metrics.items()}}


def main(store_path: str, rank: int, world: int, out: str, ref: str = "") -> None:
    from repro_torch.launch.mesh import make_test_mesh, mesh_name
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        for shape, archs in MESHES[world]:
            mesh = make_test_mesh(*shape, device_type="cpu")
            for arch in archs:
                cfg = config(arch)
                model = Model(cfg)
                params, batch = inputs(cfg)
                res = {"serve": serve_case(model, mesh, params, batch),
                       "train": train_case(model, mesh, params, batch)}
                if rank == 0:
                    torch.save(res, os.path.join(out, f"{mesh_name(mesh)}-{arch}.pt"))
            if ref:
                from repro_torch.models.carry import params_from_reference

                data = np.load(ref)
                cfg = ref_config()
                tree = {}
                for k in data.files:
                    if k.startswith("p0."):
                        node = tree
                        *path, leaf = k[3:].split("/")
                        for name in path:
                            node = node.setdefault(name, {})
                        node[leaf] = data[k]
                params = params_from_reference(cfg, tree, device="cpu")
                batch = {"tokens": torch.from_numpy(data["tokens"]),
                         "labels": torch.from_numpy(data["labels"])}
                res = train_case(Model(cfg), mesh, params, batch)
                if rank == 0:
                    torch.save(res, os.path.join(out, f"{mesh_name(mesh)}-reference.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5] if len(sys.argv) > 5 else "")
