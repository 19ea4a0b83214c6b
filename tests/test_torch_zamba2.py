"""The ``zamba2`` family (``configs/zamba2.py``, ``models/model.py``) on the
CPU, in float32, on seeded weights.

The port is held to the benchmark's plain reference
(``bench/reference/zamba2.py``) at a small size that keeps the published
structure (2 shared blocks taken in turn over 3 sites, 2 groups, the
attention reading 2 d wide inputs into heads of 2 d / H at the scale
(hd / 2) ** -1/2): the forward's logits, and prefill then decode through
the cache against the forward.  The reference is held to transformers'
``Zamba2ForCausalLM`` with the same weights copied in, and the port's
parameters to the published model's, counted at full size on the meta
device (both skip without transformers).  transformers' pure-PyTorch scan
departs from the recurrence across chunks, so that comparison keeps each
sequence inside one chunk; the reference's scan is held to the recurrence
across chunks here.

Tolerances: float32 through a few layers of width 32-64, where the two
sides sum products in other orders: ``rtol=atol=1e-4`` on logits of
magnitude ~0.5 (measured 1.2e-6 between reference and transformers,
5.7e-7 between the port and the reference).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench.harness import manifest  # noqa: E402
from bench.harness.cell import _META  # noqa: E402
from bench.harness.weights import leaves, make_weights  # noqa: E402
from bench.reference import logits_at  # noqa: E402
from bench.reference.layers import softplus, ssd  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs import Zamba2Config, get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.ssm import _gated_rmsnorm  # noqa: E402
from repro_torch.obs import counters  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)

SMALL = Zamba2Config(
    arch_id="zamba2-small", num_layers=5, d_model=32, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=48, vocab_size=64, tie_embeddings=True, ssm_state=8, ssm_headdim=8, ssm_expand=2,
    ssm_ngroups=2, ssm_conv=4, ssd_chunk=8, shared_sites=(1, 3, 4), num_mem_blocks=2,
    adapter_rank=4, scan_layers=False)
SEED = 2**33 + 5
B, S = 2, 19


def _file(cfg) -> dict:
    """A configuration file's dict of ``cfg``: its settings and its
    published keys, as the benchmark reads them."""
    return dataclasses.asdict(cfg)


def _weights(cfg=SMALL):
    return make_weights(_file(cfg), SEED, "cpu", torch.float32)


def _tokens(n=S, seed=3):
    return torch.randint(0, SMALL.vocab_size, (B, n), generator=torch.Generator().manual_seed(seed))


def _reference(cfg, w, tok):
    c = _file(cfg)
    return logits_at(c, w, list(tok), [torch.arange(tok.shape[1])] * tok.shape[0],
                     trunk=manifest.family(c).reference.trunk)


@pytest.mark.parametrize("attn_impl", ["reference", "chunked"])
def test_forward_equals_the_reference(attn_impl):
    cfg = dataclasses.replace(SMALL, attn_impl=attn_impl, attn_block=8)
    w, tok = _weights(cfg), _tokens()
    with torch.no_grad():
        got, aux = Model(cfg).forward(w, {"tokens": tok})
    assert float(aux["router_aux"]) == 0.0
    for b, want in enumerate(_reference(cfg, w, tok)):
        torch.testing.assert_close(got[b], want, **TOL)


@pytest.mark.parametrize("prompt", [1, 12])
def test_prefill_then_decode_equals_the_forward(prompt):
    model, w, tok = Model(SMALL), _weights(), _tokens()
    with torch.no_grad():
        full, _ = model.forward(w, {"tokens": tok})
        cache = model.init_cache(B, S + 2, device="cpu")
        assert cache.attn["k"].shape == (3, B, S + 2, 4, 16)
        assert cache.conv.shape[0] == cache.ssm.shape[0] == 5
        logits, cache = model.prefill(w, {"tokens": tok[:, :prompt]}, cache)
        steps = [logits[:, 0]]
        for t in range(prompt, S):
            logits, cache = model.decode_step(w, tok[:, t:t + 1], cache)
            steps.append(logits[:, 0])
    assert cache.index == S
    torch.testing.assert_close(torch.stack(steps, 1), full[:, prompt - 1:], **TOL)


def test_each_site_runs_its_block_in_turn_and_counts():
    cfg, model, w, tok = SMALL, Model(SMALL), _weights(), _tokens(9)
    assert [cfg.block_of(j) for j in range(3)] == [0, 1, 0]
    assert model.n_attn_sites() == 3
    assert [len(w[k]) for k in ("layers", "shared_blocks", "sites")] == [5, 2, 3]
    before = counters.snapshot()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        cache = model.init_cache(B, 10, device="cpu")
        _, cache = model.prefill(w, {"tokens": tok}, cache)
        model.decode_step(w, tok[:, :1], cache)
    got = counters.delta(before)
    assert got["model.shared_sites"] == 6
    assert got["kernel.launches.flash_attention.plain"] == 3
    assert got["kernel.launches.decode_attention.plain"] == 3
    assert got["kernel.launches.ssd.plain"] == 5
    names = ("shared/block", "shared/lora", "shared/site_linear", "mlp", "attn/core")
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in names),
                    key=lambda e: (e.start_ns(), -e.duration_ns()))
    blocks = [e for e in events if e.name() == "shared/block"]
    assert [(e.kwinputs()["site"], e.kwinputs()["block"]) for e in blocks] == [
        (0, 0), (1, 1), (2, 0)] * 2
    for e in events:
        if e.name() != "shared/block":  # every span of the block nests inside one
            assert any(b.start_ns() <= e.start_ns() and e.start_ns() + e.duration_ns()
                       <= b.start_ns() + b.duration_ns() for b in blocks), e.name()
    assert sum(e.name() == "shared/lora" for e in events) == 6
    assert sum(e.name() == "shared/site_linear" for e in events) == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gated_norm_of_one_group_is_bitwise_as_before(dtype):
    g = torch.Generator().manual_seed(1)
    y, z = (torch.randn(3, 7, 48, generator=g).to(dtype) for _ in range(2))
    scale = torch.rand(48, generator=g).to(dtype)
    before = y * F.silu(z)  # the one-group norm as it was written before groups
    b32 = before.float()
    want = (b32 * torch.rsqrt(b32.square().mean(-1, keepdim=True) + 1e-5) * scale).to(dtype)
    assert torch.equal(_gated_rmsnorm(y, z, scale, 1e-5), want)
    assert torch.equal(_gated_rmsnorm(y, z, scale, 1e-5, 1), want)
    # two groups: each half normalised on its own (Zamba2RMSNormGated)
    halves = [h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-5) for h in b32.chunk(2, -1)]
    want = (torch.cat(halves, -1) * scale).to(dtype)
    assert torch.equal(_gated_rmsnorm(y, z, scale, 1e-5, 2), want)


def test_the_reference_scan_follows_the_recurrence_across_chunks():
    g = torch.Generator().manual_seed(2)
    L, H, P, G, N = 37, 4, 8, 2, 8
    x, Bm, Cm = (torch.randn(L, *s, generator=g) for s in ((H, P), (G, N), (G, N)))
    dt = softplus(torch.randn(L, H, generator=g) - 2)
    A = -torch.exp(torch.rand(H, generator=g) * 2)
    Bh, Ch = (t.repeat_interleave(H // G, 1) for t in (Bm, Cm))
    h, ys = torch.zeros(H, N, P), []
    for t in range(L):
        h = torch.exp(dt[t] * A)[:, None, None] * h + dt[t][:, None, None] * Bh[t][:, :, None] \
            * x[t][:, None, :]
        ys.append(torch.einsum("hn,hnp->hp", Ch[t], h))
    torch.testing.assert_close(ssd(x, dt, A, Bm, Cm, chunk=8), torch.stack(ys), **TOL)


def test_get_config_equals_the_configuration_file():
    c = json.loads((ROOT / "bench" / "configs" / "zamba2-7b.json").read_text())
    cfg = get_config("zamba2-7b")
    assert isinstance(cfg, Zamba2Config) and cfg is TC.PUBLISHED["zamba2-7b"]
    assert {k: v for k, v in c.items() if k not in _META} == {
        k: getattr(cfg, k) for k in c if k not in _META}
    # the published config.json's 38 keys: 34 derived fields and 4 settings
    published = {f.name for f in dataclasses.fields(cfg) if not f.init}
    assert len(published) == 34 and published <= set(c)
    assert {"adapter_rank", "num_mem_blocks", "rope_theta", "vocab_size"} <= set(c)
    assert c["reduced"] == ["chunk_size"] and cfg.chunk_size == cfg.ssd_chunk == 128
    assert "zamba2-7b" not in TC.REGISTRY and "zamba2-7b" not in TC.ARCH_IDS
    assert (cfg.attn_in, cfg.attn_scale, cfg.norm_groups) == (7168, 112 ** -0.5, 2)
    assert model_sizes(cfg) == (81, 13, 2, 7_356_749_648)
    with pytest.raises(ValueError, match="do not span"):
        dataclasses.replace(cfg, head_dim=128)


def model_sizes(cfg):
    params = Model(cfg).abstract_params()
    n = sum(math.prod(t.shape) for _, t in leaves(params))
    return len(params["layers"]), len(params["sites"]), len(params["shared_blocks"]), n


_HF_KEYS = ("vocab_size", "max_position_embeddings", "hidden_size", "num_hidden_layers",
            "layers_block_type", "mamba_d_state", "mamba_d_conv", "mamba_expand",
            "mamba_ngroups", "n_mamba_heads", "use_conv_bias", "chunk_size", "add_bias_linear",
            "intermediate_size", "hidden_act", "num_attention_heads", "num_key_value_heads",
            "num_mem_blocks", "use_shared_attention_adapter", "adapter_rank", "use_mem_rope",
            "rope_theta", "rms_norm_eps", "use_long_context")


def _transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def _hf_config(cfg, **kw):
    return _transformers().Zamba2Config(**{k: getattr(cfg, k) for k in _HF_KEYS},
                                        tie_word_embeddings=True, **kw)


def test_the_port_has_the_published_models_parameters():
    hf = _hf_config(get_config("zamba2-7b"))
    with torch.device("meta"):
        model = _transformers().Zamba2ForCausalLM(hf)
    assert hf.attention_head_dim == 224 and hf.attention_hidden_size == 7168
    assert sum(p.numel() for p in model.parameters()) == model_sizes(get_config("zamba2-7b"))[3]


def _hf_state(cfg, w):
    """The weights of the program's layout under transformers' names."""
    sd = {"model.embed_tokens.weight": w["embed"],
          "model.final_layernorm.weight": w["ln_f"]["scale"]}
    site = {layer: j for j, layer in enumerate(cfg.shared_sites)}
    for i, lp in enumerate(w["layers"]):
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in site else "")
        m = lp["mamba"]
        sd.update({pre + "input_layernorm.weight": lp["ln"]["scale"],
                   pre + "mamba.in_proj.weight": m["in_proj"].T,
                   pre + "mamba.conv1d.weight": m["conv_w"].T[:, None, :],
                   pre + "mamba.conv1d.bias": m["conv_b"],
                   pre + "mamba.norm.weight": m["norm_scale"],
                   pre + "mamba.out_proj.weight": m["out_proj"].T})
        sd.update({pre + f"mamba.{k}": m[k] for k in ("A_log", "dt_bias", "D")})
        if i not in site:
            continue
        j = site[i]
        blk, s = w["shared_blocks"][cfg.block_of(j)], w["sites"][j]
        pre = f"model.layers.{i}.shared_transformer."
        ff = pre + "feed_forward."
        sd.update({f"model.layers.{i}.linear.weight": s["linear"].T,
                   pre + "input_layernorm.weight": blk["ln1"]["scale"],
                   pre + "pre_ff_layernorm.weight": blk["ln2"]["scale"],
                   pre + "self_attn.o_proj.weight": blk["attn"]["w_o"].flatten(0, 1).T,
                   ff + "gate_up_proj.weight": torch.cat([blk["mlp"]["w_gate"],
                                                          blk["mlp"]["w_up"]], 1).T,
                   ff + "down_proj.weight": blk["mlp"]["w_down"].T,
                   ff + f"gate_up_proj_adapter_list.{j}.0.weight": s["lora_a"].T,
                   ff + f"gate_up_proj_adapter_list.{j}.1.weight": s["lora_b"].T})
        sd.update({pre + f"self_attn.{n}_proj.weight": blk["attn"][f"w_{n}"].flatten(1).T
                   for n in "qkv"})
    return {k: v.contiguous() for k, v in sd.items()}


def test_the_reference_equals_transformers_zamba2():
    # chunk_size above the sequence: transformers' scan is exact inside one chunk;
    # time_step_min near 0: its fallback's clamp of dt (absent from the CUDA path) is
    # never reached
    hf = _hf_config(SMALL, time_step_min=1e-30)
    hf.chunk_size = 32
    model = _transformers().Zamba2ForCausalLM(hf).eval()
    w, tok = _weights(), _tokens()
    state = _hf_state(SMALL, w)
    missing, unexpected = model.load_state_dict(state, strict=False)
    # the blocks are shared modules, so each site's adapter is loaded under its own
    # layer's prefix and reported missing under the other's; the head is tied
    assert not unexpected and all("adapter_list" in k or k == "lm_head.weight" for k in missing)
    with torch.no_grad():
        got = model(tok).logits
    for b, want in enumerate(_reference(SMALL, w, tok)):
        torch.testing.assert_close(got[b], want, **TOL)
