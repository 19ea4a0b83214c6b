"""The Hopper attention kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attention_cuda.py

Flash attention has two routes (``flash_route``): bf16 at head_dim 64, 128
or 160 runs the tensor-core kernel (``flash_attention_wgmma.cu``), f32 and
other head dims the CUDA-core kernel (``flash_attention.cu``); the cases
below cover both, in bf16 too (hd 32 and 96), and the launch counters
(``obs.counters``) show which ran.
Decode is split-K: the cases cover one span and several.

Tolerances are those of ``tests/test_kernels.py``: f32 ``rtol=2e-4,
atol=2e-5`` (with TF32 off, so the plain version's f32 products are full
f32); bf16 ``rtol=atol=2e-2``, which covers the output's bf16 rounding and,
on the tensor-core route, P rounded to bf16 before P.V (the rounding of the
reference's ``ref.py`` oracle; the plain version keeps P in f32).  The small
model on the card is held to the same model on the CPU at the model tests'
``rtol=atol=1e-3``, its greedy tokens exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_ref,
    decode_splits,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    flash_route,
)
from repro_torch.models import Model, params_to  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.training import make_batch  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-4, atol=2e-5)


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,H,KV,S,hd,window",
    [
        (2, 4, 4, 100, 64, None),    # rep 1, ragged S
        (1, 8, 2, 200, 128, 8),      # rep 4, window
        (2, 16, 2, 77, 128, None),   # rep 8, ragged
        (1, 8, 1, 130, 64, 8),       # rep 8, window, ragged
        (1, 4, 2, 50, 32, None),     # small head dim
        (1, 4, 2, 40, 160, 16),      # pixtral's / stablelm's head dim (a 32-column tail atom)
        (1, 4, 2, 90, 96, None),     # bf16 at hd 96 stays on the CUDA cores
        (1, 8, 1, 300, 128, 100),    # rep 8, a window that starts mid-tile
        (2, 4, 1, 257, 64, 200),     # rep 4, window 200, ragged against 128 and 192 rows
        (1, 4, 4, 384, 64, None),    # whole tiles of both routes
    ],
)
def test_flash_kernel_equals_plain(cuda, B, H, KV, S, hd, window, dtype):
    q = _randn((B, H, S, hd), dtype, cuda, 1)
    k = _randn((B, KV, S, hd), dtype, cuda, 2)
    v = _randn((B, KV, S, hd), dtype, cuda, 3)
    route = flash_route(dtype, hd)
    before = counters.snapshot()
    got = flash_attention(q, k, v, causal=True, window=window, backend="cuda")
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert counters.launches("flash_attention", before, route) == 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize(
    "B,H,KV,S,window,causal",
    [
        (2, 8, 2, 300, None, True),     # rep 4, ragged S (300 = 2 x 128 + 44)
        (1, 32, 8, 77, None, True),     # B 1 at S 77, pixtral's heads
        (1, 8, 2, 400, 100, True),      # a window that starts mid-tile (rows 256+)
        (2, 4, 4, 200, None, False),    # not causal, rep 1
        (1, 8, 8, 256, 64, True),       # rep 1, whole tiles, window
        (8, 32, 8, 2048, None, True),   # pixtral-12b's prefill launch
    ],
)
def test_flash_hd160_tensor_core_route_equals_plain(cuda, B, H, KV, S, window, causal):
    """bf16 at hd 160 runs the tensor-core kernel (two 128-byte-swizzle atoms
    and a 64-byte-swizzle tail atom per tile): one ``wgmma`` launch, none on
    the CUDA-core route, within the bf16 tolerance of the plain version."""
    hd, dtype = 160, torch.bfloat16
    q = _randn((B, S, H, hd), dtype, cuda, 21).transpose(1, 2)  # model-layout views
    k = _randn((B, S, KV, hd), dtype, cuda, 22).transpose(1, 2)
    v = _randn((B, S, KV, hd), dtype, cuda, 23).transpose(1, 2)
    assert flash_route(dtype, hd) == "wgmma"
    before = counters.snapshot()
    got = flash_attention(q, k, v, causal=causal, window=window, backend="cuda")
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert counters.routes("flash_attention", before) == {"wgmma": 1, "simt": 0}
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,KV,rep,T,hd",
    [
        (2, 4, 1, 100, 64),     # rep 1, ragged T
        (3, 2, 4, 257, 128),    # rep 4
        (2, 4, 8, 1056, 128),   # rep 8, the serving path's T: 17 spans
        (8, 4, 8, 1056, 128),   # yi-9b's decode launch: 9 spans
        (9, 32, 1, 300, 64),    # 288 groups: one span
        (1, 2, 12, 70, 128),    # rep 12 (starcoder2)
        (2, 2, 2, 33, 32),
    ],
)
def test_decode_kernel_equals_plain(cuda, B, KV, rep, T, hd, dtype):
    q = _randn((B, KV, rep, hd), dtype, cuda, 4)
    k = _randn((B, KV, T, hd), dtype, cuda, 5)
    v = _randn((B, KV, T, hd), dtype, cuda, 6)
    g = torch.Generator(device=cuda).manual_seed(7)
    valid = torch.rand((B, T), generator=g, device=cuda) < 0.7
    valid[0] = False  # a sequence with no valid position: zeros
    n_split, span = decode_splits(B, KV, T)
    if n_split > 1 and B > 1:
        valid[1, :span] = False  # a span with no valid position drops out
    got = decode_attention(q, k, v, valid, backend="cuda")
    again = decode_attention(q, k, v, valid, backend="cuda")
    want = decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    assert torch.equal(got, again)  # the spans combine in a fixed order
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,H,KV,S",
    [
        (1, 4, 4, 130),      # rep 1, ragged S
        (2, 8, 2, 77),       # rep 4, ragged
        (1, 8, 8, 256),      # whole tiles
        (8, 32, 32, 1024),   # zamba2-7b's prefill launch at its shortest prompts
    ],
)
def test_flash_hd224_takes_the_scale(cuda, B, H, KV, S, dtype):
    """zamba2's shared attention: hd 224 at the scale (hd/2)^-1/2, bf16 on
    the tensor-core route (three atoms and the tail, one stage) and f32 on
    the CUDA-core route, one launch each, within the dtype's tolerance of
    the plain version at that scale and apart from it at 1/sqrt(hd)."""
    hd, scale = 224, 112 ** -0.5
    q = _randn((B, S, H, hd), dtype, cuda, 31).transpose(1, 2)  # model-layout views
    k = _randn((B, S, KV, hd), dtype, cuda, 32).transpose(1, 2)
    v = _randn((B, S, KV, hd), dtype, cuda, 33).transpose(1, 2)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash_route(dtype, hd) == route
    before = counters.snapshot()
    got = flash_attention(q, k, v, causal=True, backend="cuda", scale=scale)
    want = flash_attention_ref(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert counters.launches("flash_attention", before, route) == 1
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    unscaled = flash_attention_ref(q, k, v, causal=True)
    assert (unscaled.float() - want.float()).abs().max() > 4 * _tol(dtype)["atol"]
    model = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                backend="cuda", scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(model, got.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KV,rep,T", [(2, 4, 1, 300), (8, 32, 1, 4001), (1, 2, 4, 70)])
def test_decode_hd224_takes_the_scale(cuda, B, KV, rep, T, dtype):
    """Decode at hd 224 and the scale (hd/2)^-1/2, one span and several
    (zamba2-7b's step over a ring of 4001), equals the plain version at
    that scale; the model-layout adapter passes the scale on."""
    hd, scale = 224, 112 ** -0.5
    q = _randn((B, KV, rep, hd), dtype, cuda, 34)
    k = _randn((B, KV, T, hd), dtype, cuda, 35)
    v = _randn((B, KV, T, hd), dtype, cuda, 36)
    valid = torch.rand((B, T), generator=torch.Generator(device=cuda).manual_seed(37),
                       device=cuda) < 0.8
    got = decode_attention(q, k, v, valid, backend="cuda", scale=scale)
    want = decode_attention_ref(q, k, v, valid, scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    unscaled = decode_attention_ref(q, k, v, valid)
    assert (unscaled.float() - want.float()).abs().max() > 4 * _tol(dtype)["atol"]
    model = ops.decode_attention(q.flatten(1, 2), k.transpose(1, 2), v.transpose(1, 2), valid,
                                 backend="cuda", scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(model, got.flatten(1, 2))


@pytest.mark.parametrize("hd", [64, 128, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_model_layout_views_are_read_in_place(cuda, dtype, hd):
    """The adapters hand the kernels transposed views and one layer's slice
    of an (L, B, W, KV, hd) cache, and write the output through a view; the
    results equal the plain versions on contiguous copies."""
    B, S, H, KV, L = 2, 90, 8, 2, 3
    q = _randn((B, S, H, hd), dtype, cuda, 8)
    k = _randn((B, S, KV, hd), dtype, cuda, 9)
    got = ops.flash_attention(q, k, k, causal=True, window=None, backend="cuda")
    want = flash_attention_ref(*(t.transpose(1, 2).contiguous() for t in (q, k, k)))
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(), **_tol(dtype))
    cache = _randn((L, B, S, KV, hd), dtype, cuda, 10)
    valid = (torch.arange(S, device=cuda) % 3 != 0)[None].expand(B, S)
    got = ops.decode_attention(q[:, 0], cache[1], cache[2], valid, backend="cuda")
    want = decode_attention_ref(q[:, 0].unflatten(1, (KV, H // KV)),
                                cache[1].transpose(1, 2).contiguous(),
                                cache[2].transpose(1, 2).contiguous(), valid.contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.flatten(1, 2).float(), **_tol(dtype))


def test_launch_counters_and_input_checks(cuda):
    q = _randn((1, 4, 20, 64), torch.float32, cuda, 11)
    k = _randn((1, 2, 20, 64), torch.float32, cuda, 12)
    valid = torch.ones((1, 20), dtype=torch.bool, device=cuda)
    n0 = counters.snapshot()

    def launched():
        return counters.launches("flash_attention", n0), counters.launches("decode_attention", n0)

    flash_attention(q, k, k, backend="cuda")
    decode_attention(q[:, :, 0].unflatten(1, (2, 2)), k, k, valid, backend="cuda")
    assert launched() == (1, 1)
    flash_attention(q, k, k, backend="torch")
    assert launched() == (1, 1)
    assert counters.launches("flash_attention", n0, "plain") == 1
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), k.double(), backend="cuda")
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(q.transpose(2, 3), k.transpose(2, 3), k.transpose(2, 3), backend="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :62], k[..., :62], k[..., :62], backend="cuda")
    with pytest.raises(ValueError, match="valid"):
        decode_attention(q[:, :, 0].unflatten(1, (2, 2)), k, k, valid[:, :5], backend="cuda")
    assert launched() == (1, 1)



def test_calls_that_launch_nothing_count_nothing(cuda):
    """An empty batch, and on the tensor-core route a key-less call (zero
    rows written in place), return without a launch and count none."""
    n0 = counters.snapshot()
    for B, T, dtype in ((0, 20, torch.float32), (0, 20, torch.bfloat16), (1, 0, torch.bfloat16)):
        q = _randn((B, 4, 20, 64), dtype, cuda, 16)
        k = _randn((B, 2, T, 64), dtype, cuda, 17)
        out = flash_attention(q, k, k, backend="cuda")
        assert out.shape == q.shape and not bool(out.float().abs().sum())
    q = _randn((0, 2, 2, 64), torch.float32, cuda, 18)
    k = _randn((0, 2, 20, 64), torch.float32, cuda, 19)
    decode_attention(q, k, k, torch.ones((0, 20), dtype=torch.bool, device=cuda), backend="cuda")
    assert counters.delta(n0) == {}

def test_tensor_core_route_refuses_what_tma_cannot_read(cuda):
    """The tensor-core route describes its tensors to TMA: a stride that is
    not a multiple of 16 bytes, or a base off a 16-byte boundary, raises
    (no copy, no other route) and counts no launch."""
    B, H, S, hd = 1, 4, 64, 128
    wide = _randn((B, H, S, hd + 4), torch.bfloat16, cuda, 13)[..., :hd]
    flat = _randn((B * H * S * hd + 8,), torch.bfloat16, cuda, 14)
    shifted = flat[1:1 + B * H * S * hd].view(B, H, S, hd)
    ok = _randn((B, H, S, hd), torch.bfloat16, cuda, 15)
    counts = counters.snapshot()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention(wide, ok, ok, backend="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(ok, shifted, ok, backend="cuda")
    assert counters.delta(counts) == {}
    flash_attention(ok, ok, ok, backend="cuda")
    assert counters.routes("flash_attention", counts) == {"wgmma": 1, "simt": 0}


def test_small_model_on_the_card_equals_the_cpu(cuda):
    """One set of weights in both places, f32, GQA rep 4, a 16-token window
    whose ring wraps: prefill logits within 1e-3, 8 greedy tokens equal."""
    cfg = dataclasses.replace(TC.reduce_for_smoke(TC.get_config("yi-9b")), num_kv_heads=1,
                              sliding_window=16)
    model = Model(cfg)
    cpu_params = model.init(0, device="cpu")
    dev_params = params_to(cpu_params, cuda)
    b = make_batch(cfg, 2, 24, np.random.default_rng(0), device="cpu")
    lc, _ = model.prefill(cpu_params, b, model.init_cache(2, 32, device="cpu"))
    n0 = counters.snapshot()
    lg, _ = model.prefill(dev_params, {k: t.to(cuda) for k, t in b.items()},
                          model.init_cache(2, 32, device=cuda))
    assert counters.launches("flash_attention", n0) == cfg.num_layers
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    n0 = counters.snapshot()
    got = ServingEngine(model, dev_params, device=cuda).generate(
        {k: t.to(cuda) for k, t in b.items()}, max_new_tokens=8)
    assert counters.launches("decode_attention", n0) == 7 * cfg.num_layers
    want = ServingEngine(model, cpu_params, device="cpu").generate(b, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
