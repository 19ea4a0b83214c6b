"""Training on the card: the kernels' no-backward guard, the train step's
plain route, and serving freshly trained parameters on the kernels.

Every test here needs a CUDA device and ``nvcc``; without them they skip
with that reason (a CUDA kernel has no CPU mode).  On a GPU machine run:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_training_cuda.py

A hand kernel writes its output through a raw pointer, so autograd would
not see it: on the ``cuda`` route each model kernel refuses inputs that
require a gradient while grad mode is on, and launches under
``torch.no_grad()``.  The train step asks for the plain route, so it
launches no kernel; its result is held to the same step on the CPU at
``tests/test_torch_training.py``'s tolerances for the loss (``rtol=1e-5``)
and, with TF32 off, the moments and parameters (``rtol=1e-4,
atol=1e-6`` on all but 0.1% of the elements, each within ``2 lr``).  The
reduced yi-9b's float32 gradient is ill-conditioned: the CPU's own float32
step lies 5.5e-4 from the same step computed wide in its gradient norm
(``tests/test_torch_training.py::test_float32_step_against_a_wide_step``),
so there the card's step is held to that wide step, at the limits the
CPU's float32 step meets.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
import repro_torch.training as T  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import Model, params_to  # noqa: E402
from repro_torch.obs import counters  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_unflatten  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grad_inputs(dev, shapes, dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(0)
    return [torch.randn(s, generator=g, dtype=torch.float32).to(dev, dtype).requires_grad_(True)
            for s in shapes]


def test_flash_refuses_grad_and_launches_under_no_grad(cuda):
    q, k, v = _grad_inputs(cuda, [(1, 4, 16, 32), (1, 2, 16, 32), (1, 2, 16, 32)])
    n = counters.snapshot()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, backend="cuda")
    assert counters.launches("flash_attention", n) == 0
    with torch.no_grad():
        flash_attention(q, k, v, backend="cuda")
    assert counters.launches("flash_attention", n) == 1
    flash_attention(q.detach(), k.detach(), v.detach(), backend="cuda")
    assert counters.launches("flash_attention", n) == 2


def test_decode_refuses_grad(cuda):
    q, k, v = _grad_inputs(cuda, [(2, 2, 2, 32), (2, 2, 24, 32), (2, 2, 24, 32)])
    valid = torch.ones((2, 24), dtype=torch.bool, device=cuda)
    n = counters.snapshot()
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, k, v, valid, backend="cuda")
    with torch.no_grad():
        decode_attention(q, k, v, valid, backend="cuda")
    assert counters.launches("decode_attention", n) == 1


def test_ssd_refuses_grad_and_launches_under_no_grad(cuda):
    x, dt, Bm, Cm = _grad_inputs(cuda, [(1, 4, 64, 32), (1, 4, 64), (1, 1, 64, 16),
                                        (1, 1, 64, 16)])
    A = -torch.rand(4, device=cuda)
    dt = dt.detach().abs().requires_grad_(True)
    n = counters.snapshot()
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=32, backend="cuda")
    with torch.no_grad():
        ssd_scan(x, dt, A, Bm, Cm, chunk=32, backend="cuda")
    assert counters.launches("ssd", n) == 1


#: tests/test_training.py's dense config
DENSE = dict(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=256, scan_layers=False)
#: the moments' and parameters' tolerance, and the share of elements the
#: parameters may leave it by (AdamW's normalized step: each within 2 lr)
STATE_TOL, OFF_SHARE = dict(rtol=1e-4, atol=1e-6), 1e-3
#: the limits of a float32 step against the same step computed wide
#: (tests/test_torch_training.py's WIDE_GNORM_RTOL, WIDE_OFF_SHARE)
WIDE_GNORM_RTOL, WIDE_OFF_SHARE = 1e-3, 5e-3


def _off_share(got, want):
    """The share of elements outside ``STATE_TOL`` and the largest
    difference, ``got`` on the card against ``want`` on the CPU."""
    off = n = 0
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = (a.cpu().double() - b.double()).abs()
        off += int((d > STATE_TOL["atol"] + STATE_TOL["rtol"] * b.double().abs()).sum())
        n += d.numel()
        worst = max(worst, float(d.max()))
    return off / n, worst


@pytest.mark.parametrize("arch", ["dense", "yi-9b", "mamba2-130m", "zamba2-1.2b"])
def test_train_step_on_the_card_takes_the_plain_route(cuda, arch):
    cfg = (TC.base.ModelConfig(**DENSE) if arch == "dense"
           else TC.reduce_for_smoke(TC.get_config(arch)))
    model = Model(cfg)
    opt = T.AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3)
    state_cpu = T.init_state(model, 1, device="cpu")
    state = T.TrainState(params_to(state_cpu.params, cuda),
                         T.adamw_init(params_to(state_cpu.params, cuda)))
    batch_cpu = next(T.batch_iterator(cfg, 2, 64, seed=3, device="cpu"))
    batch = {k: v.to(cuda) for k, v in batch_cpu.items()}
    step = T.make_train_step(model, opt)
    counts = counters.snapshot()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    assert [counters.launches(k, counts) for k in counters.ROUTES] == [0, 0, 0, 0]
    want, wm = step(state_cpu, batch_cpu)
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    if arch == "yi-9b":  # against the wide step
        wcfg = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
        wide = tree_unflatten(state_cpu.params,
                              [p.double() for p in tree_leaves(state_cpu.params)])
        want, wm = T.make_train_step(Model(wcfg), opt)(T.TrainState(wide, T.adamw_init(wide)),
                                                       batch_cpu)
        np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]),
                                   rtol=WIDE_GNORM_RTOL)
        for got, ref in ((new.opt.m, want.opt.m), (new.opt.v, want.opt.v)):
            assert _off_share(got, ref)[0] <= WIDE_OFF_SHARE
        share, worst = _off_share(new.params, want.params)
        assert share <= WIDE_OFF_SHARE and worst <= 2 * opt.lr
        return
    for got, ref in ((new.opt.m, want.opt.m), (new.opt.v, want.opt.v)):
        for a, b in zip(tree_leaves(got), tree_leaves(ref)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **STATE_TOL)
    share, worst = _off_share(new.params, want.params)
    assert share <= OFF_SHARE and worst <= 2 * opt.lr


def test_trained_parameters_serve_on_the_kernels(cuda):
    """A train step's leaves require grad only inside the step; parameters
    that still do (a caller's own leaves) serve through the kernels, since
    the engine runs under no_grad."""
    cfg = TC.reduce_for_smoke(TC.get_config("yi-9b"))
    model = Model(cfg)
    state = T.init_state(model, 0, device=cuda)
    batch = next(T.batch_iterator(cfg, 2, 32, device=cuda))
    state, _ = T.make_train_step(model, T.AdamWConfig())(state, batch)
    params = {k: v for k, v in state.params.items()}
    params["layers"] = [{k: {n: t.detach().requires_grad_(True) for n, t in sub.items()}
                         for k, sub in layer.items()} for layer in state.params["layers"]]
    eng = ServingEngine(model, params, device=cuda)
    n0 = counters.snapshot()
    r = eng.generate(batch, max_new_tokens=4)
    assert counters.launches("flash_attention", n0) == cfg.num_layers
    assert counters.launches("decode_attention", n0) == 3 * cfg.num_layers
    assert r.tokens.shape == (2, 4)
    n1 = counters.snapshot()
    eng.eval_next_token_accuracy(batch)
    assert counters.launches("flash_attention", n1) == cfg.num_layers
