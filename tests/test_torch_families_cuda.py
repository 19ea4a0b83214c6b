"""The MoE, encoder-decoder and VLM families on the card against the CPU.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_families_cuda.py

* The MoE dispatch (both flavours, f32 and bf16, grouped and global, with
  drops and under a zero router): ``expert_idx``, ``keep`` and
  ``tok_map`` equal to the CPU's, but for tokens whose top-k margin on the
  CPU is below 1e-5 relative (a last-bit difference of the f32 router may
  flip those); ``y`` at the attention kernels' bounds (f32 ``rtol=1e-4,
  atol=1e-5``, bf16 ``rtol=atol=2e-2``), on every token whose choices
  and kept slots match.  ``route`` holds TF32 off for the router's f32
  product, which decides the routing, whatever the process-wide setting.
* Small f32 models of each new family: forward and prefill logits at
  ``rtol=atol=1e-3`` and 8 greedy tokens equal, with flash launched once a
  decoder layer in prefill and decode once a layer and step.  The reduced
  encoder-decoder model's q/k/v are rescaled to a fan-in of d_model: with
  the reference's init its own float32 forward lies 0.072 from float64 on
  the CPU, so no two float32 computations of it can be held at 1e-3.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model, params_to  # noqa: E402
from repro_torch.models.layers import init_tree  # noqa: E402
from repro_torch.models.moe import apply_moe, dispatch, moe_decl, route  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.training import make_batch  # noqa: E402

pytestmark = pytest.mark.gpu

MOE_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TIE_RTOL = 1e-5
WIDTH = dict(family="moe", num_layers=1, d_model=256, num_heads=4, num_kv_heads=4, d_ff=256,
             vocab_size=512, moe_d_ff=128)
FLAVOURS = {
    "shared": dict(n_experts=60, top_k=4, n_shared_experts=4, shared_expert_d_ff=64),
    "dense-residual": dict(n_experts=128, top_k=2, dense_residual=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "drops", "zero-router"])
@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_moe_dispatch_on_the_card_equals_the_cpu(cuda, flavour, case, dtype, grouped):
    cfg = ModelConfig(**WIDTH, **FLAVOURS[flavour],
                      capacity_factor=0.25 if case == "drops" else 1.25)
    dt = getattr(torch, dtype)
    p = init_tree(moe_decl(cfg), torch.float32, torch.Generator().manual_seed(11),
                  torch.device("cpu"))
    if case == "zero-router":
        p["router"].zero_()
    p = {k: ({kk: vv.to(dt) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dt))
         for k, v in p.items()}
    pg = params_to(p, cuda)
    shape = (4, 256, 256) if grouped else (256, 1, 256)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(12)).to(dt)
    dc = dispatch(x, p["router"], cfg, grouped=grouped)
    dg = dispatch(x.to(cuda), pg["router"], cfg, grouped=grouped)
    K = cfg.top_k
    top = torch.sort(dc.probs, -1, descending=True).values[..., :K + 1]
    gaps = (top[..., :-1] - top[..., 1:]) / top[..., :-1]
    near = ((gaps > 0) & (gaps < TIE_RTOL)).any(-1)
    bad = (dc.expert_idx != dg.expert_idx.cpu()).any(-1)
    assert not bool((bad & ~near).any())
    clean = ~bad.any(-1)
    assert torch.equal(dc.keep[clean], dg.keep.cpu()[clean])
    assert torch.equal(dc.tok_map[clean], dg.tok_map.cpu()[clean])
    if case == "zero-router":
        assert bool((dg.expert_idx == torch.arange(K, device=cuda)).all())
    # y on each token whose choices and kept slots match
    same = ~bad & (dc.keep == dg.keep.cpu()).reshape(bad.shape + (K,)).all(-1)
    assert int(same.sum()) > 0
    yc, _ = apply_moe(p, x, cfg)
    yg, _ = apply_moe(pg, x.to(cuda), cfg)
    yc = yc.reshape(same.shape + (256,))[same].float()
    yg = yg.cpu().reshape(same.shape + (256,))[same].float()
    torch.testing.assert_close(yg, yc, **MOE_TOL[dtype])


def test_router_product_is_full_f32_under_tf32(cuda):
    """``route`` holds TF32 off for the router product: with TF32 turned
    on (it changes a plain f32 product at qwen2-moe's router shape) its
    probabilities equal those with TF32 off bit for bit, and the setting is
    put back."""
    cfg = TC.get_config("qwen2-moe-a2.7b")
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(1024, cfg.d_model, device=cuda, generator=g)
    w = 0.02 * torch.randn(cfg.d_model, cfg.n_experts, device=cuda, generator=g)
    want, plain = route(x, w, cfg)[0], x @ w
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, tf32 = route(x, w, cfg)[0], x @ w
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.equal(tf32, plain)
    assert torch.equal(got, want)


def _rescale_attention(params, cfg):
    for stack in ("enc_layers", "dec_layers"):
        for lp in params[stack]:
            for block in [b for b in ("attn", "xattn") if b in lp]:
                for name, fan_in in (("w_q", cfg.num_heads), ("w_k", cfg.num_kv_heads),
                                     ("w_v", cfg.num_kv_heads)):
                    lp[block][name].mul_(math.sqrt(fan_in / cfg.d_model))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b", "seamless-m4t-medium",
                                  "pixtral-12b"])
def test_small_family_model_on_the_card_equals_the_cpu(cuda, arch):
    cfg = TC.reduce_for_smoke(TC.get_config(arch))
    model = Model(cfg)
    cpu = model.init(0, device="cpu")
    if cfg.family == "encdec":
        _rescale_attention(cpu, cfg)
    card = params_to(cpu, cuda)
    batch = make_batch(cfg, 2, 24, np.random.default_rng(0), device="cpu")
    batch_card = {k: t.to(cuda) for k, t in batch.items()}
    with torch.no_grad():
        fc, ac = model.forward(cpu, batch)
        fg, ag = model.forward(card, batch_card)
        torch.testing.assert_close(fg.cpu(), fc, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(float(ag["router_aux"]), float(ac["router_aux"]), rtol=1e-5)
        lc, _ = model.prefill(cpu, batch, model.init_cache(2, 32, device="cpu"))
        n0 = counters.snapshot()
        lg, _ = model.prefill(card, batch_card, model.init_cache(2, 32, device=cuda))
        assert counters.launches("flash_attention", n0) == cfg.num_layers
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    tok_cpu = ServingEngine(model, cpu, device="cpu").generate(batch, 8).tokens
    n0 = counters.snapshot()
    tok_card = ServingEngine(model, card, device=cuda).generate(batch_card, 8).tokens
    assert counters.launches("decode_attention", n0) == 7 * cfg.num_layers
    np.testing.assert_array_equal(tok_card, tok_cpu)

