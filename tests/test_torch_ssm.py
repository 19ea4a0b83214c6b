"""The port's Mamba-2 / SSD layer and the ``ssm`` and ``hybrid`` model
families against the reference's, on the CPU.

* ``ssd_scan_ref`` (the plain version in kernel layout, which the wrapper
  ``ssd_scan`` runs on CPU tensors) against the reference's Pallas
  ``ssd_scan(..., interpret=True)`` and ``ref.ssd_ref``, over
  ``tests/test_kernels.py``'s shapes plus a ragged S and SSM groups G > 1,
  at that file's ``rtol=1e-3, atol=1e-4``.  The reference kernel takes B and
  C repeated over heads; the port's takes them per group.
* The final state against ``ssd_reference(return_final_state=True)``, with
  and without an initial state and a ragged S.
* The layer's pieces: ``_causal_conv`` with and without a state (and,
  off the card, ``apply_mamba``'s conv through the unchanged expression),
  ``_gated_rmsnorm``, ``apply_mamba`` with ``return_state`` and several
  ``mamba_decode_step``s, on the reference's own weights.
* Both families at ``reduce_for_smoke`` sizes (4 layers, so the hybrid has
  two shared-attention sites) on carried weights: ``forward`` against both
  reference routes (``use_pallas`` False and True), ``prefill`` and
  ``decode_step`` logits and the conv/ssm/attn caches, greedy tokens
  exactly.

Stated tolerances: SSD in f32 ``rtol=1e-3, atol=1e-4`` (the reference's own
Pallas-vs-plain bound; measured here up to ~1e-6); model logits
``rtol=atol=1e-3`` and caches ``rtol=1e-3`` with an absolute part of 1e-4
of the largest entry (``tests/test_torch_model.py``'s: the port sums
matrix products and reductions in another order); bf16 ``rtol=atol=2e-2``
(``tests/test_kernels.py``'s bf16 bound).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.layers import init_from_decl  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    check_ssd_inputs,
    ssd_reference,
    ssd_scan,
    ssd_scan_ref,
)
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.carry import _tensor  # noqa: E402
from repro_torch.obs import counters  # noqa: E402

SSD_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def _close_cache(got, want, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-3,
                               atol=1e-4 * float(np.abs(want).max()), err_msg=msg)


def _ssd_inputs(B, H, G, S, P, N, seed, dtype=np.float32):
    """Kernel-layout inputs as ``tests/test_kernels.py`` draws them, with B
    and C per group."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, S, P)).astype(dtype)
    dt = rng.uniform(0.001, 0.1, (B, H, S)).astype(dtype)
    A = (-rng.uniform(0.5, 4, (H,))).astype(np.float32)
    Bm = rng.standard_normal((B, G, S, N)).astype(dtype)
    Cm = rng.standard_normal((B, G, S, N)).astype(dtype)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (B, H, G, S, P, N, Q): tests/test_kernels.py's four (G = H, as the Pallas
# kernel takes B and C), then a ragged S, G > 1, and both together
SSD_SHAPES = [
    (2, 3, 3, 64, 16, 8, 16),
    (1, 4, 4, 128, 32, 16, 32),
    (2, 2, 2, 256, 64, 128, 64),
    (1, 2, 2, 128, 64, 128, 128),
    (2, 4, 1, 100, 32, 16, 32),
    (1, 4, 2, 96, 16, 8, 32),
    (1, 6, 2, 77, 32, 16, 16),
]


@pytest.mark.parametrize("B,H,G,S,P,N,Q", SSD_SHAPES)
def test_ssd_scan_ref_matches_reference(B, H, G, S, P, N, Q):
    x, dt, A, Bm, Cm = _ssd_inputs(B, H, G, S, P, N, seed=S + N)
    got = ssd_scan_ref(*_t(x, dt, A, Bm, Cm), Q)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, S, P)
    # the reference takes B and C repeated over heads (head h: group h // rep)
    Bh, Ch = np.repeat(Bm, H // G, axis=1), np.repeat(Cm, H // G, axis=1)
    want = jref.ssd_ref(*map(jnp.asarray, (x, dt, A, Bh, Ch)), Q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    if S % Q == 0:  # the Pallas kernel takes whole chunks only
        pallas = j_ssd_scan(*map(jnp.asarray, (x, dt, A, Bh, Ch)), chunk=Q, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **SSD_TOL)
    # the wrapper runs the plain version on CPU tensors and counts no launch
    n0 = counters.snapshot()
    wrapped = ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=Q, backend="cuda")
    assert torch.equal(wrapped, got) and counters.launches("ssd", n0) == 0


@pytest.mark.parametrize("S,with_init", [(128, False), (100, False), (77, True), (96, True)])
def test_final_state_matches_reference(S, with_init):
    B, H, G, P, N, Q = 2, 4, 2, 16, 8, 32
    x, dt, A, Bm, Cm = _ssd_inputs(B, H, G, S, P, N, seed=S)
    init = (np.random.default_rng(9).standard_normal((B, H, N, P)).astype(np.float32)
            if with_init else None)
    xs, dts, Bs, Cs = (a.swapaxes(1, 2) for a in (x, dt, Bm, Cm))  # model layout
    wy, ws = jssm.ssd_reference(*map(jnp.asarray, (xs, dts, A, Bs, Cs)), Q,
                                initial_state=None if init is None else jnp.asarray(init),
                                return_final_state=True)
    ty, ts = ssd_reference(*_t(xs, dts, A, Bs, Cs), Q,
                           initial_state=None if init is None else torch.from_numpy(init),
                           return_final_state=True)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (B, H, N, P)
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), **SSD_TOL)
    if init is None:  # the kernel layout and the wrapper (zero start) give the same state
        ky, ks = ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=Q, return_final_state=True)
        assert torch.equal(ks, ts) and torch.equal(ky, ty.transpose(1, 2))


def test_ragged_tail_is_exact_padding():
    """A ragged S gives exactly what the same inputs padded with dt = 0
    tokens give, at the real positions and in the final state."""
    B, H, G, S, P, N, Q = 1, 2, 1, 45, 8, 8, 16
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(B, H, G, S, P, N, seed=3))
    y, st = ssd_scan_ref(x, dt, A, Bm, Cm, Q, return_final_state=True)
    pad = 48 - S
    yp, sp = ssd_scan_ref(
        torch.nn.functional.pad(x, (0, 0, 0, pad)), torch.nn.functional.pad(dt, (0, pad)), A,
        torch.nn.functional.pad(Bm, (0, 0, 0, pad)), torch.nn.functional.pad(Cm, (0, 0, 0, pad)),
        Q, return_final_state=True)
    assert torch.equal(y, yp[:, :, :S]) and torch.equal(st, sp)


def test_ssd_scan_ref_bf16_matches_reference():
    B, H, G, S, P, N, Q = 2, 4, 1, 96, 32, 16, 32
    x, dt, A, Bm, Cm = _ssd_inputs(B, H, G, S, P, N, seed=5)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, dt)] + [jnp.asarray(A)] + [
        jnp.asarray(np.repeat(a, H // G, axis=1), jnp.bfloat16) for a in (Bm, Cm)]
    want = jref.ssd_ref(*jb, Q)
    tb = [torch.from_numpy(a).bfloat16() for a in (x, dt)] + [torch.from_numpy(A)] + [
        torch.from_numpy(a).bfloat16() for a in (Bm, Cm)]
    got, st = ssd_scan_ref(*tb, Q, return_final_state=True)
    assert got.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_ops_ssd_adapter_takes_model_layout_views():
    """``ops.ssd`` on the strided slices ``apply_mamba`` hands it equals the
    model-layout ``ssd_reference`` on contiguous copies."""
    Bsz, S, H, P, G, N, Q = 2, 40, 4, 8, 2, 8, 16
    rng = np.random.default_rng(11)
    xBC = torch.from_numpy(rng.standard_normal((Bsz, S, H * P + 2 * G * N)).astype(np.float32))
    xs, Bm, Cm = torch.split(xBC, [H * P, G * N, G * N], dim=-1)
    xs, Bm, Cm = xs.unflatten(-1, (H, P)), Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (Bsz, S, H)).astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 4, (H,)).astype(np.float32))
    y, st = ops.ssd(xs, dt, A, Bm, Cm, chunk=Q, return_final_state=True)
    wy, ws = ssd_reference(xs.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), Q,
                           return_final_state=True)
    assert y.shape == (Bsz, S, H, P) and y.is_contiguous()
    assert torch.equal(y, wy) and torch.equal(st, ws)
    assert torch.equal(ops.ssd(xs, dt, A, Bm, Cm, chunk=Q), y)


def _good_args():
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(1, 4, 2, 40, 16, 8, seed=0))
    return dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, chunk=16)


@pytest.mark.parametrize("change,err", [
    (lambda a: a.update(x=a["x"].half(), dt=a["dt"].half(), Bm=a["Bm"].half(),
                        Cm=a["Cm"].half()), "float32 or bfloat16"),
    (lambda a: a.update(Bm=a["Bm"][:, :1].expand(1, 3, 40, 8),
                        Cm=a["Cm"][:, :1].expand(1, 3, 40, 8)), "do not split"),
    (lambda a: a.update(chunk=132), "chunk 132"),
    (lambda a: a.update(chunk=6), "chunk 6"),
    (lambda a: a.update(Bm=torch.zeros(1, 2, 40, 6), Cm=torch.zeros(1, 2, 40, 6)), "state size 6"),
    (lambda a: a.update(x=torch.zeros(1, 4, 40, 96)), "head dim 96"),
    (lambda a: a.update(x=a["x"].transpose(2, 3).contiguous().transpose(2, 3)), "unit stride"),
    (lambda a: a.update(dt=a["dt"][:, :, :-1]), "dt must be"),
    (lambda a: a.update(A=a["A"].double()), "A must be"),
    (lambda a: a.update(Cm=a["Cm"].bfloat16()), "Cm has dtype"),
    (lambda a: a.update(state_out=torch.zeros(1, 4, 16, 8)), "state_out must be"),
    (lambda a: a.update(initial_state=torch.zeros(1, 4, 16, 8)), "initial_state must be"),
    (lambda a: a.update(initial_state=torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16)),
     "initial_state must be"),
    (lambda a: a.update(initial_state=torch.zeros(1, 4, 16, 8).transpose(2, 3)),
     "initial_state must be"),
    (lambda a: a.update(initial_state=torch.zeros(1, 4, 8, 16, device="meta")),
     "initial_state must be"),
])
def test_check_ssd_inputs_refuses_what_the_kernel_does_not_take(change, err):
    args = _good_args()
    check_ssd_inputs(**args)  # the good case passes
    change(args)
    with pytest.raises((ValueError, TypeError), match=err):
        check_ssd_inputs(**args)


@pytest.mark.parametrize("S,G", [(77, 2), (96, 4)])
def test_initial_state_reaches_every_plain_entry(S, G):
    """``ssd_scan_ref(initial_state=)`` (kernel layout), the wrapper on CPU
    tensors and ``ops.ssd`` (model layout, a bf16 state taken in f32) all
    equal ``ssd_reference(initial_state=)`` bit for bit, and the state
    moves the result."""
    B, H, P, N, Q = 2, 4, 16, 8, 32
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(B, H, G, S, P, N, seed=S))
    h0 = torch.from_numpy(np.random.default_rng(S).standard_normal((B, H, N, P)).astype(np.float32))
    wy, ws = ssd_reference(*(t.transpose(1, 2) for t in (x, dt)), A,
                           *(t.transpose(1, 2) for t in (Bm, Cm)), Q, initial_state=h0,
                           return_final_state=True)
    ry, rs = ssd_scan_ref(x, dt, A, Bm, Cm, Q, return_final_state=True, initial_state=h0)
    assert torch.equal(ry, wy.transpose(1, 2)) and torch.equal(rs, ws)
    n0 = counters.snapshot()
    ky, ks = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, return_final_state=True, initial_state=h0,
                      backend="cuda")
    assert torch.equal(ky, ry) and torch.equal(ks, rs)
    assert counters.launches("ssd", n0) == 0
    my, ms = ops.ssd(*(t.transpose(1, 2) for t in (x, dt)), A, *(t.transpose(1, 2) for t in (Bm, Cm)),
                     chunk=Q, return_final_state=True, initial_state=h0)
    assert torch.equal(my, wy) and torch.equal(ms, ws)
    hb = h0.bfloat16()
    by = ops.ssd(*(t.transpose(1, 2) for t in (x, dt)), A, *(t.transpose(1, 2) for t in (Bm, Cm)),
                 chunk=Q, initial_state=hb)
    assert torch.equal(by, ssd_reference(*(t.transpose(1, 2) for t in (x, dt)), A,
                                         *(t.transpose(1, 2) for t in (Bm, Cm)), Q,
                                         initial_state=hb.float()))
    zero = ssd_scan_ref(x, dt, A, Bm, Cm, Q)
    assert not torch.allclose(zero, ry, **SSD_TOL)


def test_ssd_scan_refuses_other_devices():
    x = torch.zeros((1, 2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ssd_scan(x, x[..., 0], torch.zeros(2, device="meta"), x, x, chunk=4)


# ---------------------------------------------------------------------------
# The layer's pieces, on the reference's own weights
# ---------------------------------------------------------------------------

def _layer(arch="mamba2-130m", seed=0, **changes):
    """(reference cfg, port cfg, reference mamba params, port params)."""
    ref = dataclasses.replace(JC.reduce_for_smoke(JC.get_config(arch)), **changes)
    port = dataclasses.replace(TC.reduce_for_smoke(TC.get_config(arch)), **changes)
    jp = init_from_decl(jax.random.PRNGKey(seed), jssm.mamba_decl(ref))
    # perturb D and the norm scale from their ones init so that they matter
    rng = np.random.default_rng(seed)
    jp = dict(jp, D=jp["D"] + 0.1 * rng.standard_normal(jp["D"].shape).astype(np.float32),
              norm_scale=jp["norm_scale"] + 0.1 * rng.standard_normal(
                  jp["norm_scale"].shape).astype(np.float32),
              conv_b=0.1 * rng.standard_normal(jp["conv_b"].shape).astype(np.float32))
    tp = {k: _tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    return ref, port, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(1)
    xBC = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (0.2 * rng.standard_normal((4, 24))).astype(np.float32)
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state else None
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want, wst = jssm._causal_conv(*(jnp.asarray(a, jd) for a in (xBC, w, b)),
                                  None if st is None else jnp.asarray(st, jd))
    got, gst = tssm._causal_conv(*(torch.from_numpy(a).to(td) for a in (xBC, w, b)),
                                 None if st is None else torch.from_numpy(st).to(td))
    tol = BF16_TOL if dtype == "bfloat16" else dict(rtol=1e-6, atol=1e-6)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # the new state is the last W-1 inputs, exactly
    np.testing.assert_array_equal(gst.float().numpy(), np.asarray(wst, np.float32))


@pytest.mark.parametrize("scope", ["cpu", "torch_backend"])
def test_apply_mamba_off_the_card_runs_the_plain_conv(monkeypatch, scope):
    """On CPU tensors, and under ``model_backend("torch")``, the conv is the
    unchanged expression (``_causal_conv``, then ``F.silu``), once a call:
    the wrapper never reaches the kernel's library and counts no launch."""
    from repro_torch.kernels import causal_conv as conv_module
    from repro_torch.kernels.common import model_backend

    _, port, _, tp = _layer("mamba2-130m")
    calls = []

    def plain(*args):
        calls.append(len(args))
        return tssm._causal_conv(*args)

    def no_library():
        raise AssertionError("the plain route loaded the kernel's library")

    monkeypatch.setattr(conv_module, "causal_conv_ref", plain)
    monkeypatch.setattr(conv_module, "_library", no_library)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 13, port.d_model))
                         .astype(np.float32))
    di, H, P, G, N = tssm._dims(port)
    cv = torch.randn((2, port.ssm_conv - 1, di + 2 * G * N), generator=torch.Generator()
                     .manual_seed(1))
    before = counters.snapshot()
    with model_backend("torch") if scope == "torch_backend" else contextlib.nullcontext():
        y, (conv, _) = tssm.apply_mamba(tp, x, port, return_state=True)
        y2, cv2, _ = tssm.mamba_decode_step(tp, x[:, :1], port, cv, tssm.init_ssm_state(
            port, 2)[1])
        xBC = tssm._split_proj(x @ tp["in_proj"], port)[1]
        got, got_st = conv_module.causal_conv(xBC, tp["conv_w"], tp["conv_b"], cv)
    assert calls == [4, 4, 4]
    assert not any(k.startswith("kernel.launches.causal_conv") for k in counters.delta(before))
    want, want_st = tssm._causal_conv(xBC, tp["conv_w"], tp["conv_b"], cv)
    assert torch.equal(got, F.silu(want)) and torch.equal(got_st, want_st)
    assert torch.equal(conv, tssm._causal_conv(xBC, tp["conv_w"], tp["conv_b"])[1])
    x1 = tssm._split_proj(x[:, :1] @ tp["in_proj"], port)[1]
    assert torch.equal(cv2, torch.cat([cv, x1], 1)[:, 1:])


def test_causal_conv_module_imports_without_nvcc():
    """Importing the wrapper builds and loads nothing: no ``nvcc`` on the
    path, and no library loaded afterwards."""
    code = ("import shutil; import repro_torch.kernels.causal_conv as m; "
            "from repro_torch.kernels import build; "
            "assert shutil.which('nvcc') is None; assert not build._LOADED; print('ok')")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    env.pop("CUDA_HOME", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(2)
    y, z = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jssm._gated_rmsnorm(jnp.asarray(y, jd), jnp.asarray(z, jd), jnp.asarray(scale, jd), 1e-5)
    got = tssm._gated_rmsnorm(torch.from_numpy(y).to(td), torch.from_numpy(z).to(td),
                              torch.from_numpy(scale).to(td), 1e-5)
    tol = BF16_TOL if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-6)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("arch,S", [("mamba2-130m", 64), ("mamba2-130m", 45), ("zamba2-1.2b", 50)])
def test_apply_mamba_with_state_matches_reference(arch, S):
    ref, port, jp, tp = _layer(arch)
    x = np.random.default_rng(S).standard_normal((2, S, port.d_model)).astype(np.float32)
    want, (wcv, wst) = jssm.apply_mamba(jp, jnp.asarray(x), ref, return_state=True)
    got, (gcv, gst) = tssm.apply_mamba(tp, torch.from_numpy(x), port, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _close_cache(gcv, wcv, "conv state")
    _close_cache(gst, wst, "ssm state")
    assert gst.dtype == torch.float32
    plain = tssm.apply_mamba(tp, torch.from_numpy(x), port)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("return_state", [False, True], ids=["y", "y+state"])
@pytest.mark.parametrize("arch,S", [("mamba2-130m", 45), ("zamba2-1.2b", 50),
                                    ("zamba2-1.2b", 64)])
def test_apply_mamba_ssm_state_matches_reference_plain_path(arch, S, return_state):
    """``apply_mamba(ssm_state=h0)``: a random initial state (B, H, N, P)
    of the scan, against the reference's plain path (``use_pallas=False``,
    which honours it; its Pallas path drops it when ``return_state`` is
    off), on carried weights, with a conv state beside it."""
    ref, port, jp, tp = _layer(arch, seed=S, use_pallas=False)
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S, port.d_model)).astype(np.float32)
    di, H, P, G, N = tssm._dims(port)
    h0 = rng.standard_normal((2, H, N, P)).astype(np.float32)
    cv = rng.standard_normal((2, port.ssm_conv - 1, di + 2 * G * N)).astype(np.float32)
    want = jssm.apply_mamba(jp, jnp.asarray(x), ref, jnp.asarray(cv), jnp.asarray(h0),
                            return_state=return_state)
    # positionally too: the fifth argument is the SSM state
    got = tssm.apply_mamba(tp, torch.from_numpy(x), port, torch.from_numpy(cv),
                           torch.from_numpy(h0), return_state=return_state)
    if return_state:
        (want, (wcv, wst)), (got, (gcv, gst)) = want, got
        _close_cache(gcv, wcv, "conv state")
        _close_cache(gst, wst, "ssm state")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    zero = tssm.apply_mamba(tp, torch.from_numpy(x), port, torch.from_numpy(cv))
    assert not np.allclose(zero.numpy(), got.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference(state_dtype):
    ref, port, jp, tp = _layer("zamba2-1.2b", seed=4)
    rng = np.random.default_rng(5)
    jcv, jst = jssm.init_ssm_state(ref, 2, jnp.dtype(state_dtype))
    tcv, tst = tssm.init_ssm_state(port, 2, getattr(torch, state_dtype), "cpu")
    assert tuple(tcv.shape) == jcv.shape and tuple(tst.shape) == jst.shape
    # start from a prefilled state
    x = rng.standard_normal((2, 20, port.d_model)).astype(np.float32)
    _, (jcv, jst) = jssm.apply_mamba(jp, jnp.asarray(x), ref, return_state=True)
    jcv, jst = jcv.astype(jnp.dtype(state_dtype)), jst.astype(jnp.dtype(state_dtype))
    tcv, tst = _tensor(np.asarray(jcv), "cpu"), _tensor(np.asarray(jst), "cpu")
    for step in range(5):
        xt = rng.standard_normal((2, 1, port.d_model)).astype(np.float32)
        wy, jcv, jst = jssm.mamba_decode_step(jp, jnp.asarray(xt), ref, jcv, jst)
        gy, tcv, tst = tssm.mamba_decode_step(tp, torch.from_numpy(xt), port, tcv, tst)
        assert tst.dtype == getattr(torch, state_dtype)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **LOGIT_TOL, err_msg=f"step {step}")
        tol = BF16_TOL if state_dtype == "bfloat16" else SSD_TOL
        np.testing.assert_allclose(tst.float().numpy(), np.asarray(jst, np.float32), **tol)
        np.testing.assert_allclose(tcv.float().numpy(), np.asarray(jcv, np.float32), **tol)


# ---------------------------------------------------------------------------
# The two families, whole
# ---------------------------------------------------------------------------

def _family(arch, use_pallas=False):
    """Reference and port configs at smoke size with 4 layers (the hybrid's
    shared block fires at layers 0 and 2)."""
    ref = dataclasses.replace(JC.reduce_for_smoke(JC.get_config(arch)), num_layers=4,
                              use_pallas=use_pallas)
    port = dataclasses.replace(TC.reduce_for_smoke(TC.get_config(arch)), num_layers=4)
    return ref, port


def _carried(ref, port, seed):
    """The reference's init with every norm scale perturbed, carried."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JModel(ref).init(jax.random.PRNGKey(seed)))

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name or "'norm_scale'" in name or "'D'" in name:
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return tree, jax.tree.map(jnp.asarray, tree), params_from_reference(port, tree, device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["ref-route", "pallas-route"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_family_forward_matches_both_reference_routes(arch, use_pallas):
    ref, port = _family(arch, use_pallas)
    _, jp, tp = _carried(ref, port, 1)
    S = 64  # whole chunks: the reference's Pallas route takes no ragged S
    toks = np.random.default_rng(2).integers(0, port.vocab_size, (2, S)).astype(np.int32)
    lj, _ = JModel(ref).forward(jp, {"tokens": jnp.asarray(toks)})
    lt, aux = Model(port).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, S, port.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert float(aux["router_aux"]) == 0.0


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_family_prefill_and_decode_match_reference(arch):
    ref, port = _family(arch)
    _, jp, tp = _carried(ref, port, 3)
    jm, tm = JModel(ref), Model(port)
    B, S, steps = 2, 45, 4  # a ragged prompt: 45 = 32 + 13
    toks = np.random.default_rng(4).integers(0, port.vocab_size, (B, S)).astype(np.int32)
    cj, ct = jm.init_cache(B, S + steps + 1), tm.init_cache(B, S + steps + 1, device="cpu")
    assert tuple(ct.conv.shape) == cj.conv.shape and tuple(ct.ssm.shape) == cj.ssm.shape
    assert (ct.attn is None) == (cj.attn is None)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cj)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert ct.index == int(cj.index) == S

    def caches(msg):
        _close_cache(ct.conv, cj.conv, f"{msg} conv")
        _close_cache(ct.ssm, cj.ssm, f"{msg} ssm")
        if ct.attn is not None:
            for name in ("k", "v"):
                _close_cache(ct.attn[name], cj.attn[name], f"{msg} {name}")

    caches("prefill")
    for step in range(steps):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(lt[:, -1], -1).numpy(), tok[:, 0],
                                      err_msg=f"greedy token, step {step}")
        lj, cj = jm.decode_step(jp, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(tp, torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL, err_msg=f"step {step}")
        assert ct.index == int(cj.index)
    caches("decoded")


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_family_decode_matches_forward(arch):
    """The port alone: prefill + decode logits equal the teacher-forced
    forward's at the same positions (``tests/test_arch_smoke.py``'s 5e-3)."""
    port = TC.reduce_for_smoke(TC.get_config(arch))
    model = Model(port)
    params = model.init(3, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, port.vocab_size, (2, 40)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": toks})
    P = 36
    last, cache = model.prefill(params, {"tokens": toks[:, :P]},
                                model.init_cache(2, 40, device="cpu"))
    errs = [float((last[:, 0] - full[:, P - 1]).abs().max())]
    for t in range(P, 40):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, errs


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_full_config_cache_matches_reference_shapes(arch):
    """At full width the caches are in the activation dtype (bf16 SSM
    state), with the reference's shapes: zamba2 has 7 attention sites."""
    ref, port = JC.get_config(arch), TC.get_config(arch)
    want = jax.eval_shape(lambda: JModel(ref).init_cache(2, 16))
    cache = Model(port).init_cache(2, 16, device="cpu")
    assert Model(port).n_attn_sites() == (7 if arch == "zamba2-1.2b" else 0)
    for name in ("conv", "ssm"):
        got = getattr(cache, name)
        assert tuple(got.shape) == getattr(want, name).shape and got.dtype == torch.bfloat16
    if want.attn is None:
        assert cache.attn is None
    else:
        assert tuple(cache.attn["k"].shape) == want.attn["k"].shape


def test_weight_carry_splits_mamba_layers_and_keeps_shared_attn():
    ref, port = _family("zamba2-1.2b")
    tree, _, params = _carried(ref, port, 5)
    assert len(params["layers"]) == 4
    for i, layer in enumerate(params["layers"]):
        for leaf in ("in_proj", "conv_w", "A_log", "dt_bias", "D", "norm_scale", "out_proj"):
            np.testing.assert_array_equal(layer["mamba"][leaf].numpy(),
                                          tree["layers"]["mamba"][leaf][i])
    np.testing.assert_array_equal(params["shared_attn"]["attn"]["w_q"].numpy(),
                                  tree["shared_attn"]["attn"]["w_q"])
    np.testing.assert_array_equal(params["shared_attn"]["mlp"]["w_gate"].numpy(),
                                  tree["shared_attn"]["mlp"]["w_gate"])


def test_port_init_draws_the_mamba_distributions():
    port = dataclasses.replace(TC.reduce_for_smoke(TC.get_config("mamba2-130m")), num_layers=8)
    params = Model(port).init(0, device="cpu")
    a_log = torch.stack([lp["mamba"]["A_log"] for lp in params["layers"]])
    dt_bias = torch.stack([lp["mamba"]["dt_bias"] for lp in params["layers"]])
    conv_w = torch.stack([lp["mamba"]["conv_w"] for lp in params["layers"]])
    # A in [1, 16): A_log in [0, log 16); dt = softplus(dt_bias) in [1e-3, 1e-1]
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) < np.log(16.0)
    dt = torch.nn.functional.softplus(dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 1e-1 * (1 + 1e-4)
    assert abs(float(conv_w.std()) / 0.2 - 1) < 0.05
    assert all(torch.equal(lp["mamba"]["D"], torch.ones_like(lp["mamba"]["D"]))
               for lp in params["layers"])
