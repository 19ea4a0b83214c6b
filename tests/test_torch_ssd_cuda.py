"""The Hopper SSD kernels (both routes) against their plain PyTorch
version, and the ``ssm`` and ``hybrid`` models on the card against the CPU.

``ssd_route`` sends bf16 at head dim 64, state 64 or 128 and chunk 128 to
the tensor-core kernel (``"wgmma"``) and the rest to the CUDA-core kernel
(``"simt"``); the shapes below reach both, and each launch's route is
counted.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_cuda.py

Tolerances: f32 ``rtol=1e-3, atol=1e-4`` (``tests/test_kernels.py``'s
Pallas-vs-plain SSD bound, with TF32 off so the plain version's f32
products are full f32); bf16 ``rtol=atol=2e-2`` (that file's bf16 bound:
both versions compute in f32 and round y once, so they differ by at most
one bf16 step; the tensor-core route splits W, the state and x * w into
two bf16 terms each, which keeps it there); the final state, f32 in both
dtypes and on both routes, at the f32 bound relative to its largest entry.  The small models on the card are held to
the same models on the CPU at the model tests' ``rtol=atol=1e-3``, their
greedy tokens exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_route, ssd_scan, ssd_scan_ref  # noqa: E402
from repro_torch.models import Model, params_to  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.training import make_batch  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-3, atol=1e-4)


def _inputs(B, H, G, S, P, N, dtype, dev, seed):
    """``tests/test_kernels.py``'s distributions: x, B, C standard normal,
    dt uniform in [0.001, 0.1], A = -uniform[0.5, 4]."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    x = randn(B, H, S, P)
    dt = (0.001 + 0.099 * torch.rand((B, H, S), generator=g, device=dev)).to(dtype)
    A = -(0.5 + 3.5 * torch.rand((H,), generator=g, device=dev))
    return x, dt, A, randn(B, G, S, N), randn(B, G, S, N)


def _close_state(got, want):
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("final", [False, True], ids=["y", "y+state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,H,G,S,P,N,Q",
    [
        (2, 3, 3, 64, 16, 8, 16),       # tests/test_kernels.py's first shape
        (2, 4, 4, 256, 64, 128, 128),   # N = 128, whole chunks
        (2, 4, 1, 2000, 64, 64, 128),   # ragged S, G = 1 (zamba2's N)
        (1, 8, 2, 300, 64, 128, 128),   # G = 2, ragged, N = 128 (mamba2's N)
        (2, 6, 3, 77, 64, 64, 128),     # G = 3, S below one chunk
        (1, 8, 2, 300, 64, 128, 64),    # G = 2, ragged, chunk 64
        (1, 6, 2, 77, 32, 16, 16),      # small head dim and chunk, ragged
        (2, 4, 4, 128, 48, 32, 32),     # P not a multiple of 32
    ],
)
def test_ssd_kernel_equals_plain(cuda, B, H, G, S, P, N, Q, dtype, final):
    x, dt, A, Bm, Cm = _inputs(B, H, G, S, P, N, dtype, cuda, S + N)
    route = ssd_route(dtype, P, N, Q)
    n0 = counters.snapshot()
    got = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, return_final_state=final, backend="cuda")
    want = ssd_scan_ref(x, dt, A, Bm, Cm, Q, return_final_state=final)
    torch.cuda.synchronize()
    assert counters.launches("ssd", n0) == 1
    assert counters.routes("ssd", n0) == {k: int(k == route) for k in ("wgmma", "simt")}
    if final:
        (got, got_st), (want, want_st) = got, want
        assert got_st.dtype == torch.float32 and tuple(got_st.shape) == (B, H, N, P)
        _close_state(got_st, want_st)
    assert got.dtype == dtype and tuple(got.shape) == (B, H, S, P)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("final", [False, True], ids=["y", "y+state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,H,G,S,P,N,Q",
    [
        (2, 4, 1, 2000, 64, 64, 128),   # ragged S, G = 1 (zamba2's N)
        (1, 8, 2, 300, 64, 128, 128),   # G = 2, ragged, N = 128 (mamba2's N)
        (2, 6, 3, 77, 64, 64, 128),     # S below one chunk: h0 is all the carry
        (1, 6, 2, 77, 32, 16, 16),      # the CUDA-core route's small shapes
    ],
)
def test_ssd_kernel_initial_state_equals_plain(cuda, B, H, G, S, P, N, Q, dtype, final):
    """Both routes from an initial state h0 (``apply_mamba``'s
    ``ssm_state``) against the plain version from the same h0; a zero h0
    gives the zero-state launch's result bit for bit."""
    x, dt, A, Bm, Cm = _inputs(B, H, G, S, P, N, dtype, cuda, S + N + 1)
    g = torch.Generator(device=cuda).manual_seed(S)
    h0 = torch.randn((B, H, N, P), generator=g, device=cuda)
    route = ssd_route(dtype, P, N, Q)
    r0 = counters.snapshot()
    got = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, return_final_state=final, initial_state=h0,
                   backend="cuda")
    want = ssd_scan_ref(x, dt, A, Bm, Cm, Q, return_final_state=final, initial_state=h0)
    torch.cuda.synchronize()
    assert counters.routes("ssd", r0) == {k: int(k == route) for k in ("wgmma", "simt")}
    if final:
        (got, got_st), (want, want_st) = got, want
        _close_state(got_st, want_st)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    zero = torch.zeros_like(h0)
    z = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, return_final_state=True, initial_state=zero,
                 backend="cuda")
    n = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, return_final_state=True, backend="cuda")
    assert torch.equal(z[0], n[0]) and torch.equal(z[1], n[1])


def test_ssd_kernel_refuses_a_wrong_initial_state(cuda):
    """An h0 of another shape, dtype, layout or device raises before the
    launch; none falls back to the plain version."""
    x, dt, A, Bm, Cm = _inputs(1, 4, 1, 256, 64, 64, torch.bfloat16, cuda, 5)
    good = torch.zeros((1, 4, 64, 64), device=cuda)
    n0 = counters.snapshot()
    for bad in (good[:, :2], good.bfloat16(), good.transpose(2, 3).contiguous().transpose(2, 3),
                good.cpu()):
        with pytest.raises(ValueError, match="initial_state must be"):
            ssd_scan(x, dt, A, Bm, Cm, chunk=128, initial_state=bad, backend="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=128, initial_state=good.clone().requires_grad_(),
                 backend="cuda")
    assert counters.delta(n0) == {}


@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_model_layout_views_are_read_in_place(cuda, dtype, N):
    """``ops.ssd`` hands the kernel transposed views of the strided slices
    that ``apply_mamba`` makes (in bf16 they reach the tensor-core route,
    whose TMA maps read them in place); the result equals the plain version
    on contiguous kernel-layout copies."""
    Bsz, S, H, P, G, Q = 2, 333, 8, 64, 1, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    xBC = torch.randn((Bsz, S, H * P + 2 * G * N), generator=g, device=cuda).to(dtype)
    xs, Bm, Cm = torch.split(xBC, [H * P, G * N, G * N], dim=-1)
    xs, Bm, Cm = xs.unflatten(-1, (H, P)), Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
    dt = (0.001 + 0.099 * torch.rand((Bsz, S, H), generator=g, device=cuda)).to(dtype)
    A = -(0.5 + 3.5 * torch.rand((H,), generator=g, device=cuda))
    route = ssd_route(dtype, P, N, Q)
    r0 = counters.snapshot()
    y, st = ops.ssd(xs, dt, A, Bm, Cm, chunk=Q, return_final_state=True, backend="cuda")
    assert counters.launches("ssd", r0, route) == 1
    wy, wst = ssd_scan_ref(*(t.transpose(1, 2).contiguous() for t in (xs, dt)), A,
                           *(t.transpose(1, 2).contiguous() for t in (Bm, Cm)), Q,
                           return_final_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.transpose(1, 2).float(), wy.float(), **_tol(dtype))
    _close_state(st, wst)


def test_ssd_tensor_core_route_refuses_what_tma_cannot_read(cuda):
    """A base off a 16-byte boundary, or a row stride that is not a multiple
    of 16 bytes, raises before any launch: no copy, no other route."""
    x, dt, A, Bm, Cm = _inputs(1, 2, 1, 256, 64, 64, torch.bfloat16, cuda, 5)
    assert ssd_route(x.dtype, 64, 64, 128) == "wgmma"
    shifted = torch.empty((1, 2, 256, 65), dtype=x.dtype, device=cuda)[..., 1:].copy_(x)
    wide = torch.empty((1, 2, 256, 68), dtype=x.dtype, device=cuda)[..., :64].copy_(x)
    n0 = counters.snapshot()
    with pytest.raises(ValueError, match="16-byte boundary"):
        ssd_scan(shifted, dt, A, Bm, Cm, chunk=128, backend="cuda")
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd_scan(wide, dt, A, Bm, Cm, chunk=128, backend="cuda")
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd_scan(x, dt, A, torch.empty((1, 1, 256, 68), dtype=x.dtype, device=cuda)[..., :64],
                 Cm, chunk=128, backend="cuda")
    assert counters.delta(n0) == {}
    # the same values from aligned tensors launch the tensor-core route
    torch.testing.assert_close(ssd_scan(wide.contiguous(), dt, A, Bm, Cm, chunk=128,
                                        backend="cuda").float(),
                               ssd_scan_ref(x, dt, A, Bm, Cm, 128).float(), **_tol(x.dtype))
    assert counters.routes("ssd", n0) == {"wgmma": 1, "simt": 0}


def test_ssd_launch_counter_and_input_checks(cuda):
    x, dt, A, Bm, Cm = _inputs(1, 4, 2, 40, 16, 8, torch.float32, cuda, 11)
    n0 = counters.snapshot()
    ssd_scan(x, dt, A, Bm, Cm, chunk=16, backend="cuda")
    assert counters.launches("ssd", n0) == 1
    ssd_scan(x, dt, A, Bm, Cm, chunk=16, backend="torch")  # the plain version on the card
    assert counters.launches("ssd", n0) == 1 and counters.launches("ssd", n0, "plain") == 1
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=256, backend="cuda")
    with pytest.raises(TypeError):
        ssd_scan(x.double(), dt.double(), A, Bm.double(), Cm.double(), chunk=16, backend="cuda")
    with pytest.raises(ValueError, match="unit stride"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, chunk=16,
                 backend="cuda")
    with pytest.raises(ValueError, match="do not split"):
        ssd_scan(x[:, :3], dt[:, :3], A[:3], Bm, Cm, chunk=16, backend="cuda")
    assert counters.launches("ssd", n0) == 1



def test_ssd_empty_calls_count_no_launch(cuda):
    """An empty batch or sequence returns without a launch and counts none;
    the final state is then the initial one."""
    n0 = counters.snapshot()
    for Bsz, S in ((0, 128), (1, 0)):
        x, dt, A, Bm, Cm = _inputs(Bsz, 4, 1, S, 64, 64, torch.bfloat16, cuda, 7)
        y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=128, return_final_state=True, backend="cuda")
        assert y.shape == x.shape and not bool(st.abs().sum())
    assert counters.delta(n0) == {}

@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_small_ssm_models_on_the_card_equal_the_cpu(cuda, arch):
    """One set of weights in both places, f32, 4 layers (two shared-attention
    sites for the hybrid), a ragged 45-token prompt: forward and prefill
    logits within 1e-3, 8 greedy tokens equal, every kernel launch counted."""
    cfg = dataclasses.replace(TC.reduce_for_smoke(TC.get_config(arch)), num_layers=4)
    model = Model(cfg)
    sites = model.n_attn_sites()
    cpu_params = model.init(0, device="cpu")
    dev_params = params_to(cpu_params, cuda)
    b = make_batch(cfg, 2, 45, np.random.default_rng(0), device="cpu")
    bd = {k: t.to(cuda) for k, t in b.items()}
    fc, _ = model.forward(cpu_params, b)
    n0 = counters.snapshot()
    fg, _ = model.forward(dev_params, bd)
    assert (counters.launches("ssd", n0), counters.launches("flash_attention", n0)) == (4, sites)
    torch.testing.assert_close(fg.cpu(), fc, rtol=1e-3, atol=1e-3)
    lc, _ = model.prefill(cpu_params, b, model.init_cache(2, 64, device="cpu"))
    lg, _ = model.prefill(dev_params, bd, model.init_cache(2, 64, device=cuda))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    n0 = counters.snapshot()
    got = ServingEngine(model, dev_params, device=cuda).generate(bd, max_new_tokens=8)
    assert (counters.launches("ssd", n0), counters.launches("decode_attention", n0)) \
        == (4, 7 * sites)
    want = ServingEngine(model, cpu_params, device="cpu").generate(b, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
