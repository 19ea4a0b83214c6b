"""The SSD tensor-core route's arithmetic and the route rule, on the CPU.

``csrc/ssd_scan_wgmma.cu`` runs only on the card.  :func:`ssd_tc_form` is
its arithmetic in plain PyTorch, rounding exactly where the kernel rounds:
the bf16 inputs are exact in f32; C.B^T, C.state, W.x and the state update
sum in f32; W, the carried state (for C.state) and x * exp(cs_Q - cs) dt
(for the state update) are each split into two bf16 terms, hi = bf16(a)
and lo = bf16(a - hi), multiplied separately and summed; the carried state
stays f32.  It is held against the port's plain version ``ssd_scan_ref``
and the reference's ``ref.ssd_ref`` and Pallas ``ssd_scan`` (interpret
mode, whole chunks only) at ``tests/test_kernels.py``'s bf16 bound
``rtol=atol=2e-2``; its f32 final state against ``ssd_scan_ref``'s at the
f32 bound ``rtol=1e-3`` with an absolute part of 1e-4 of the state's
largest entry, the bound the card's comparison holds both routes to.

:func:`ssd_route` is plain Python: one parametrised test pins which launch
takes which kernel.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_route, ssd_scan_ref  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
STATE_RTOL, STATE_ATOL_SHARE = 1e-3, 1e-4
Q = 128  # the route's chunk


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(a):
    """a as two bf16 terms, hi + lo (each exact in f32)."""
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def _split_mm(a, b):
    """a @ b with a split into its two bf16 terms, summed in f32."""
    hi, lo = _split(a)
    return hi @ b + lo @ b


def _split_mm_right(a, b):
    """a @ b with b split into its two bf16 terms, summed in f32."""
    hi, lo = _split(b)
    return a @ hi + a @ lo


def ssd_tc_form(x, dt, A, Bm, Cm, chunk=Q):
    """The tensor-core kernel's arithmetic: x (B, H, S, P), dt (B, H, S),
    Bm/Cm (B, G, S, N) in bf16, A (H,) f32 -> y (B, H, S, P) bf16 and the
    final state (B, H, N, P) f32, from a zero state; a ragged tail counts
    as dt = x = B = C = 0."""
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, pad))

    xs = padded(x)
    Bs = padded(Bm).repeat_interleave(H // G, 1)  # group h // (H // G), by index
    Cs = padded(Cm).repeat_interleave(H // G, 1)
    dts = torch.nn.functional.pad(dt.float(), (0, pad))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    y = torch.empty((Bsz, H, nc * chunk, P))
    state = torch.zeros((Bsz, H, N, P))
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc = xs[:, :, sl], dts[:, :, sl], Bs[:, :, sl], Cs[:, :, sl]
        cs = torch.cumsum(dtc * A[None, :, None], -1)                      # (B, H, Q)
        cb = Cc @ Bc.transpose(-1, -2)                                      # exact products
        w = torch.where(causal, cb * torch.exp(cs[..., :, None] - cs[..., None, :])
                        * dtc[..., None, :], 0.0)
        inter = _split_mm_right(Cc, state)                                  # C.state, split
        y[:, :, sl] = torch.exp(cs)[..., None] * inter + _split_mm(w, xc)
        xw = xc * (torch.exp(cs[..., -1:] - cs) * dtc)[..., None]           # x * w_j
        state = (torch.exp(cs[..., -1])[..., None, None] * state
                 + _split_mm_right(Bc.transpose(-1, -2), xw))
    return y[:, :, :S].to(torch.bfloat16), state


def _inputs(B, H, G, S, P, N, seed):
    """``tests/test_kernels.py``'s distributions, made with numpy, in bf16."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()  # noqa: E731
    return (f(rng.standard_normal((B, H, S, P))), f(rng.uniform(0.001, 0.1, (B, H, S))),
            torch.from_numpy((-rng.uniform(0.5, 4, (H,))).astype(np.float32)),
            f(rng.standard_normal((B, G, S, N))), f(rng.standard_normal((B, G, S, N))))


def _close_state(got, want):
    torch.testing.assert_close(got, want, rtol=STATE_RTOL,
                               atol=STATE_ATOL_SHARE * float(want.abs().max()))


@pytest.mark.parametrize("B,H,G,S,N", [
    (1, 2, 2, 256, 64),    # whole chunks, G = H (the Pallas kernel's layout), zamba2's N
    (1, 2, 2, 256, 128),   # whole chunks, mamba2's N
    (2, 4, 1, 300, 64),    # ragged S, G = 1
    (1, 6, 3, 200, 128),   # ragged S, G = 3, N = 128
    (1, 2, 1, 77, 64),     # S below one chunk
])
def test_tc_form_matches_plain_version_and_reference(B, H, G, S, N):
    P = 64
    x, dt, A, Bm, Cm = _inputs(B, H, G, S, P, N, seed=S + N)
    got, got_state = ssd_tc_form(x, dt, A, Bm, Cm)
    want, want_state = ssd_scan_ref(x, dt, A, Bm, Cm, Q, return_final_state=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, S, P)
    assert got_state.dtype == torch.float32 and tuple(got_state.shape) == (B, H, N, P)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    _close_state(got_state, want_state)
    # the reference: its oracle (B and C repeated over heads), and its Pallas
    # kernel in interpret mode where S is whole chunks
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, dt)]
    jbc = [jnp.asarray(np.repeat(t.float().numpy(), H // G, axis=1), jnp.bfloat16)
           for t in (Bm, Cm)]
    oracle = jref.ssd_ref(*jx, jnp.asarray(A.numpy()), *jbc, Q)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle, np.float32), **BF16_TOL)
    if S % Q == 0:
        pallas = j_ssd_scan(*jx, jnp.asarray(A.numpy()), *jbc, chunk=Q, interpret=True)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32),
                                   **BF16_TOL)


@pytest.mark.parametrize("dtype,P,N,chunk,route", [
    (torch.bfloat16, 64, 64, 128, "wgmma"),
    (torch.bfloat16, 64, 128, 128, "wgmma"),
    (torch.float32, 64, 64, 128, "simt"),     # f32: the CUDA-core route
    (torch.float32, 64, 128, 128, "simt"),
    (torch.bfloat16, 32, 64, 128, "simt"),    # head dim other than 64
    (torch.bfloat16, 64, 16, 128, "simt"),    # state other than 64 / 128
    (torch.bfloat16, 64, 128, 64, "simt"),    # chunk other than 128
    ("zamba2-1.2b", None, None, None, "wgmma"),  # the serving configs, at their dtype
    ("mamba2-130m", None, None, None, "wgmma"),
])
def test_ssd_route(dtype, P, N, chunk, route):
    if isinstance(dtype, str):
        cfg = TC.get_config(dtype)
        dtype, P, N, chunk = (getattr(torch, cfg.dtype), cfg.ssm_headdim, cfg.ssm_state,
                              cfg.ssd_chunk)
    assert ssd_route(dtype, P, N, chunk) == route
