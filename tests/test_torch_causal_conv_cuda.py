"""The Hopper causal-conv kernel (Mamba-2's depthwise conv, bias and SiLU in
one pass) against its plain PyTorch version, and its launches on the
mamba2-130m serving path.

The kernel rounds where the plain expression rounds, so the criteria are
exact: the conv and bias (``silu=False``) equal the plain version bit for
bit, the SiLU's output lies within one step of the dtype of the plain
``F.silu`` (the two builds' ``expf`` may differ in its last bit), and the
new conv state equals the plain one exactly.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_causal_conv_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.causal_conv import causal_conv, causal_conv_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.training import make_batch  # noqa: E402

pytestmark = pytest.mark.gpu

#: mamba2-130m's conv channels (d_inner + 2 G N) and in_proj width
CH, PROJ, OFFSET = 1792, 3352, 1536


@pytest.fixture
def cuda():
    """The card, with the kernel's library built and loaded, so that a
    test's counters see its launches alone (a first build counts
    ``kernel.builds``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the causal-conv kernel runs only on the card")
    try:
        build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the causal-conv kernel")
    build.load_library("causal_conv")
    return torch.device("cuda")


def _inputs(B, S, Ch, W, dtype, dev, seed, width=None, offset=0, state=False):
    """xBC as the ``(B, S, Ch)`` slice at ``offset`` of a ``(B, S, width)``
    projection output (contiguous where ``width`` is None), w ~ 0.2 N(0, 1)
    (the model's init), b ~ 0.1 N(0, 1), and a random conv state."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    full = randn(B, S, width or Ch)
    x = full[..., offset:offset + Ch]
    st = randn(B, W - 1, Ch) if state else None
    return x, randn(W, Ch, scale=0.2), randn(Ch, scale=0.1), st


def _within_one_step(got, want):
    """|got - want| at most one step of the dtype at |want| (eps * 2^(e-1)
    for |want| = m 2^e, 0.5 <= m < 1)."""
    _, e = torch.frexp(want.float())
    step = torch.ldexp(torch.full(want.shape, torch.finfo(want.dtype).eps, device=want.device),
                       e - 1)
    over = (got.float() - want.float()).abs() > step
    assert not bool(over.any()), (
        f"{int(over.sum())} outputs beyond one step; worst |diff| "
        f"{float((got.float() - want.float()).abs().max())}")


def _check(x, w, b, st):
    """The kernel against the plain version: one launch each call, the conv
    and bias bitwise, the SiLU within one step, the state exactly."""
    n0 = counters.snapshot()
    raw, raw_st = causal_conv(x, w, b, st, silu=False, backend="cuda")
    got, got_st = causal_conv(x, w, b, st, backend="cuda")
    want, want_st = causal_conv_ref(x, w, b, st)
    torch.cuda.synchronize()
    assert counters.delta(n0) == {"kernel.launches.causal_conv.cuda": 2}
    assert got.dtype == x.dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(raw, want)
    _within_one_step(got, F.silu(want))
    if w.shape[0] == 1:
        assert got_st is None and raw_st is None
    else:
        assert torch.equal(got_st, want_st) and torch.equal(raw_st, want_st)


@pytest.mark.parametrize("S", [1024, 2048, 4000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_equals_plain_at_the_launch_shape(cuda, dtype, S):
    """mamba2-130m's prefill launch: B 32, Ch 1 792 read as the slice of a
    3 352-wide in_proj output (16-byte aligned: the vector path)."""
    _check(*_inputs(32, S, CH, 4, dtype, cuda, S, width=PROJ, offset=OFFSET))


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("layout", ["vector", "odd_ch", "misaligned"])
@pytest.mark.parametrize("S", [1, 2, 3, 64, 77, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_equals_plain_at_edge_shapes(cuda, dtype, S, layout, state):
    """S of 1 (decode), 2, W-1 and ragged tiles, with and without a prefix
    state; an odd Ch and a view one element off the 16-byte grid take the
    scalar path."""
    Ch, width, offset = {"vector": (96, 200, 40), "odd_ch": (37, None, 0),
                         "misaligned": (96, 200, 41)}[layout]
    _check(*_inputs(3, S, Ch, 4, dtype, cuda, S + Ch, width=width, offset=offset, state=state))


@pytest.mark.parametrize("W", [1, 2, 7])
@pytest.mark.parametrize("layout", ["vector", "odd_ch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_takes_any_width(cuda, dtype, layout, W):
    """Widths other than the published 4, on the kernel that reads each
    output's rows anew: no state (1), one row (2), a wide window (7); a
    prefix state, S below and above W."""
    Ch = 64 if layout == "vector" else 37
    for S in (W - 1 or 1, 150):
        _check(*_inputs(2, S, Ch, W, dtype, cuda, W * S, state=W > 1))


def test_empty_calls_count_no_launch(cuda):
    """An empty batch or sequence launches nothing and counts nothing; the
    state is then the prefix (or zeros)."""
    n0 = counters.snapshot()
    x, w, b, st = _inputs(2, 0, 64, 4, torch.bfloat16, cuda, 3, state=True)
    out, new = causal_conv(x, w, b, st, backend="cuda")
    assert out.shape == (2, 0, 64) and torch.equal(new, st)
    out, new = causal_conv(x, w, b, None, backend="cuda")
    assert not bool(new.abs().sum())
    out, new = causal_conv(x[:0], w, b, st[:0], backend="cuda")
    assert out.shape == (0, 0, 64) and new.shape == (0, 3, 64)
    assert counters.delta(n0) == {}


def test_grad_guard_and_input_checks(cuda):
    """No backward: an input that requires a gradient under grad mode
    raises before any launch (the train step takes the plain route); other
    dtypes and mixed dtypes raise; the ``torch`` backend on the card runs
    the plain version and counts nothing."""
    x, w, b, st = _inputs(2, 40, 64, 4, torch.float32, cuda, 5, state=True)
    n0 = counters.snapshot()
    with pytest.raises(RuntimeError, match="no backward"):
        causal_conv(x, w.requires_grad_(), b, st, backend="cuda")
    with torch.no_grad():
        causal_conv(x, w, b, st, backend="cuda")
    assert counters.delta(n0) == {"kernel.launches.causal_conv.cuda": 1}
    w = w.detach()
    with pytest.raises(TypeError):
        causal_conv(x.double(), w.double(), b.double(), backend="cuda")
    with pytest.raises(TypeError):
        causal_conv(x, w, b, st.bfloat16(), backend="cuda")
    with pytest.raises(ValueError, match="shape"):
        causal_conv(x, w, b, st[:, :2], backend="cuda")
    n1 = counters.snapshot()
    got, got_st = causal_conv(x, w, b, st, backend="torch")
    want, want_st = causal_conv_ref(x, w, b, st)
    assert torch.equal(got, F.silu(want)) and torch.equal(got_st, want_st)
    assert counters.delta(n1) == {}


@pytest.mark.parametrize("new", [1, 3])
def test_mamba2_130m_generate_launches_the_kernel_in_every_layer(cuda, new):
    """mamba2-130m at full width and depth: one launch per layer in
    prefill (24 for a batch scored with one greedy token, as the benchmark
    serves it) and one per layer and decode step."""
    cfg = TC.get_config("mamba2-130m")
    model = Model(cfg)
    params = model.init(0, device=cuda)
    batch = make_batch(cfg, 2, 300, np.random.default_rng(0), device=cuda)
    engine = ServingEngine(model, params, device=cuda)
    n0 = counters.snapshot()
    res = engine.generate(batch, max_new_tokens=new)
    assert counters.launches("causal_conv", n0) == cfg.num_layers * new
    assert counters.launches("ssd", n0) == cfg.num_layers
    assert res.tokens.shape == (2, new)
