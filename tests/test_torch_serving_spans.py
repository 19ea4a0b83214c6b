"""The serving path's spans and counters, on the CPU.

* A small dense model and a small Mamba-2 model (the widths of
  ``bench/tests/conftest.py``'s ``SMALL``) served through
  ``ServingEngine.generate`` under a ``torch.profiler`` profile give
  exactly the span tree the engine, ``models/model.py``, ``layers.py`` and
  ``ssm.py`` document: names, nesting, a span a layer, and args.
* The served tokens are bit-identical with and without the profile.
* With no profile recording, ``annotate`` and ``step_annotation`` return
  the one shared no-op.
* A batch's counter deltas are B, B * S and the plain route's launches.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import annotate, profiling_active, step_annotation  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

_COMMON = dict(d_model=64, vocab_size=256, norm="rmsnorm", norm_eps=1e-5, scan_layers=False)
CONFIGS = {
    "dense": ModelConfig(family="dense", num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                         d_ff=96, gated_mlp=True, activation="silu", **_COMMON),
    "ssm": ModelConfig(family="ssm", num_layers=3, tie_embeddings=True, ssm_state=16,
                       ssm_headdim=16, ssm_expand=2, ssm_ngroups=1, ssm_conv=4, ssd_chunk=32,
                       **_COMMON),
}
B, S = 2, 9

#: every span the serving path marks
SPANS = {"serve/generate", "serve/cache_init", "serve/sync", "serve/prefill", "serve/greedy",
         "serve/decode", "serve/to_host", "model/embed", "model/layer", "model/unembed",
         "cache/write", "norm", "mlp", "attn/qkv", "attn/rope", "attn/core", "attn/out",
         "ssm/in_proj", "ssm/conv", "ssm/dt", "ssm/scan", "ssm/gated_norm", "ssm/out_proj"}
#: the args each span carries
ARGS = {"serve/generate": ("batch", "B", "S", "new"), "model/layer": ("i",),
        "serve/decode": ("step",)}


def _engine(family):
    cfg = CONFIGS[family]
    model = Model(cfg)
    return ServingEngine(model, model.init(0, device="cpu"), device="cpu"), cfg


def _tokens(seed=0):
    return torch.randint(0, 256, (B, S), generator=torch.Generator().manual_seed(seed))


def _node(name, children=(), **args):
    return (name, args, list(children))


def _layer(family, i, decode):
    if family == "ssm":
        kids = [_node("norm")] + [_node(f"ssm/{p}") for p in
                                  ("in_proj", "conv", "dt", "scan", "gated_norm", "out_proj")]
        if decode:  # the recurrent step marks no pass of its own
            kids = [_node("norm")]
        return _node("model/layer", kids + [_node("cache/write")], i=i)
    attn = [_node("attn/qkv"), _node("attn/rope")]
    attn += [_node("cache/write"), _node("attn/core")] if decode else [_node("attn/core")]
    kids = [_node("norm")] + attn + [_node("attn/out"), _node("norm"), _node("mlp")]
    return _node("model/layer", kids if decode else kids + [_node("cache/write")], i=i)


def _model_pass(family, layers, decode):
    return ([_node("model/embed")] + [_layer(family, i, decode) for i in range(layers)]
            + [_node("model/unembed", [_node("norm")])])


def expected_tree(family, layers, new, serial=1):
    decode = [_node("serve/decode", _model_pass(family, layers, True) + [_node("serve/greedy")],
                    step=j) for j in range(new - 1)]
    kids = ([_node("serve/cache_init"), _node("serve/sync"),
             _node("serve/prefill", _model_pass(family, layers, False)), _node("serve/sync"),
             _node("serve/greedy")] + decode + [_node("serve/sync"), _node("serve/to_host")])
    return [_node("serve/generate", kids, batch=serial, B=B, S=S, new=new)]


def span_tree(prof):
    """The program's spans of a profile as nested (name, args, children),
    args cut to those the span documents."""
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in SPANS),
                    key=lambda e: (e.start_ns(), -e.duration_ns()))
    roots, stack = [], []
    for e in events:
        end = e.start_ns() + e.duration_ns()
        while stack and stack[-1][1] <= e.start_ns():
            stack.pop()
        kw = e.kwinputs()
        node = _node(e.name(), **{k: kw[k] for k in ARGS.get(e.name(), ())})
        (stack[-1][0][2] if stack else roots).append(node)
        stack.append((node, end))
    return roots


@pytest.mark.parametrize("new", [1, 3])
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_generate_gives_the_documented_span_tree(family, new):
    engine, cfg = _engine(family)
    engine.generate({"tokens": _tokens()}, max_new_tokens=new)  # batch 1, unprofiled
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        engine.generate({"tokens": _tokens()}, max_new_tokens=new)
    assert span_tree(prof) == expected_tree(family, cfg.num_layers, new, serial=2)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_tokens_are_the_same_with_and_without_the_profile(family):
    engine, _ = _engine(family)
    plain = engine.generate({"tokens": _tokens(3)}, max_new_tokens=4).tokens
    with profile(activities=[ProfilerActivity.CPU]):
        traced = engine.generate({"tokens": _tokens(3)}, max_new_tokens=4).tokens
    np.testing.assert_array_equal(traced, plain)


def test_annotate_is_the_shared_noop_without_a_profile():
    assert not profiling_active()
    noop = annotate("serve/generate", batch=1)
    assert annotate("norm") is noop and step_annotation("fleet/window", 3) is noop
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling_active()
        assert annotate("norm") is not noop and step_annotation("fleet/window", 3) is not noop
    assert not profiling_active() and annotate("norm") is noop


@pytest.mark.parametrize("new", [1, 3])
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_a_batch_counts_its_prompts_and_launches(family, new):
    engine, cfg = _engine(family)
    before = counters.snapshot()
    engine.generate({"tokens": _tokens()}, max_new_tokens=new)
    want = {"serve.batches": 1, "serve.prompt_tokens": B * S}
    L = cfg.num_layers
    if family == "dense":  # every layer's prefill and decode steps take the plain route here
        want["kernel.launches.flash_attention.plain"] = L
        if new > 1:
            want["kernel.launches.decode_attention.plain"] = L * (new - 1)
    else:  # the SSD scan in prefill; decode's recurrent step launches none
        want["kernel.launches.ssd.plain"] = L
    assert counters.delta(before) == want


def test_counters_add_snapshot_delta():
    before = counters.snapshot()
    counters.add("test.spans.a")
    counters.add("test.spans.b", 5)
    counters.add("test.spans.a", 2)
    mid = counters.snapshot()
    assert counters.delta(before, mid) == {"test.spans.a": 3, "test.spans.b": 5}
    assert counters.delta(mid) == {}
    mid["test.spans.a"] += 1  # a snapshot is a copy
    assert counters.snapshot()["test.spans.a"] == before.get("test.spans.a", 0) + 3
