"""The port's sharded steps (``repro_torch.launch.steps``) with real
collectives, on the CPU: 2 and 4 processes on ``gloo``.

Each group is spawned once for the module (``tests/torch_dist_worker.py``,
one process a rank, meeting through a ``FileStore`` under the test's
temporary directory, never a TCP port), runs every case, and rank 0 writes
the whole tensors to files.  The meshes are 1x2 and 2x1 (2 ranks) and 2x2
(4 ranks); the configs the reduced dense (yi-9b), ssm (mamba2-130m), hybrid
(zamba2-1.2b), moe (qwen2-moe-a2.7b), encdec (seamless-m4t-medium) and vlm
(pixtral-12b) ones in float32, every one on 1x2 and 2x2, the dense and moe
ones on 2x1 (``torch_dist_worker.MESHES``).
Held here:

* the sharded prefill logits against the unsharded port's at
  ``rtol=atol=1e-3``, and the greedy tokens of the sharded prefill and
  serve steps exactly;
* the sharded train step against the unsharded one at the limits
  ``ROADMAP.md`` §3 fixed for these reduced configs, whose float32
  gradients are ill-conditioned (the wide limits of
  ``tests/test_torch_training.py``);
* the 2x2 train step of the reference's own sharded-step config against
  the reference's ``build_train_step`` on ``make_test_mesh(2, 2)``, run in
  a subprocess with four virtual XLA devices, at the train-step limits.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402

from repro_torch.launch.specs import ShapeSpec, input_specs  # noqa: E402
from repro_torch.models.carry import params_to_reference, to_numpy  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.training import AdamWConfig, TrainState, adamw_init, make_train_step  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
PYTHONPATH = os.pathsep.join([SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p])
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
#: the wide limits of the reduced configs' float32 train steps (ROADMAP.md §3)
WIDE_GNORM_RTOL, WIDE_OFF_SHARE = 1e-3, 5e-3
TIMEOUT_S = 1200  # the groups share the CPU with the rest of the suite

_REF_SCRIPT = r"""
import sys
import jax, numpy as np
from repro.configs.base import ModelConfig
from repro.launch.mesh import make_test_mesh
from repro.launch.specs import ShapeSpec
from repro.launch.steps import build_train_step
from repro.models import Model
from repro.training import init_state
B, S = int(sys.argv[2]), int(sys.argv[3])
cfg = ModelConfig(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  d_ff=128, vocab_size=256, scan_layers=True)
model = Model(cfg)
mesh = make_test_mesh(2, 2)
fn, _ = build_train_step(model, mesh, ShapeSpec("case", seq_len=S, global_batch=B, kind="train"))
state = init_state(model, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
seq = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
def put(prefix, tree):
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(k.key for k in path)] = np.asarray(x)
put("p0.", state.params)
with mesh:
    new, metrics = fn(state, {"tokens": out["tokens"], "labels": out["labels"]})
put("p1.", new.params)
put("m1.", new.opt.m)
put("v1.", new.opt.v)
for k, v in metrics.items():
    out["metric." + k] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 2x2 step first (its initial parameters feed the
    port's), then both groups at once; returns the results directory."""
    d = tmp_path_factory.mktemp("steps_dist")
    ref = str(d / "reference.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=PYTHONPATH)
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, ref, str(W.B), str(W.S)],
                          env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=PYTHONPATH)
    procs = []
    for world, extra in ((2, []), (4, [ref])):
        store = str(d / f"store{world}")
        for rank in range(world):
            log = open(d / f"rank{world}-{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, WORKER, store, str(rank), str(world), str(d)] + extra,
                env=env, stdout=log, stderr=subprocess.STDOUT), log, world, rank))
    try:
        for p, log, world, rank in procs:
            rc = p.wait(timeout=TIMEOUT_S)
            log.close()
            tail = open(d / f"rank{world}-{rank}.log").read()[-3000:]
            assert rc == 0, f"rank {rank} of {world}: rc {rc}\n{tail}"
    finally:
        for p, log, *_ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return d


def _unsharded(arch):
    """The unsharded port on the workers' inputs: prefill logits, greedy
    tokens of prefill + serve steps, one train step."""
    cfg = W.config(arch)
    model = Model(cfg)
    params, batch = W.inputs(cfg)
    with torch.no_grad():
        logits, _ = model.prefill(params, batch, model.init_cache(W.B, W.S + W.GEN, device="cpu"))
        cache = model.init_cache(W.B, W.S + W.GEN, device="cpu")
        tok, cache = make_prefill_step(model)(params, batch, cache)
        toks = [tok]
        for _ in range(W.GEN - 1):
            tok, cache = make_serve_step(model)(params, tok, cache)
            toks.append(tok)
    keys = input_specs(cfg, ShapeSpec("case", W.S, W.B, "train"))  # the worker's batch
    state, metrics = make_train_step(model, AdamWConfig())(
        TrainState(params, adamw_init(params)), {k: batch[k] for k in keys})
    return logits, torch.cat(toks, 1), state, metrics


def _off(got, want):
    return int((~torch.isclose(got, want, **STATE_TOL)).sum())


@pytest.mark.parametrize("mesh,arch", [
    (f"{shape[0]}x{shape[1]}", arch) for world in W.MESHES for shape, archs in W.MESHES[world]
    for arch in archs])
def test_sharded_steps_equal_the_unsharded_port(runs, mesh, arch):
    res = torch.load(runs / f"{mesh}-{arch}.pt")
    logits, tokens, state, metrics = _unsharded(arch)
    torch.testing.assert_close(res["serve"]["logits"], logits, **LOGIT_TOL)
    assert torch.equal(res["serve"]["tokens"], tokens)

    got = res["train"]
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]), **LOSS_TOL)
    np.testing.assert_allclose(float(got["metrics"]["grad_norm"]), float(metrics["grad_norm"]),
                               rtol=WIDE_GNORM_RTOL)
    lr = float(metrics["lr"])
    np.testing.assert_allclose(float(got["metrics"]["lr"]), lr, rtol=1e-6)
    p_off = n_all = 0
    for name, g, w in (("m", got["m"], state.opt.m), ("v", got["v"], state.opt.v)):
        for a, b in zip(tree_leaves(g), tree_leaves(w)):
            assert _off(a, b) <= b.numel() * WIDE_OFF_SHARE, (name, tuple(b.shape))
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(state.params)):
        assert float((a - b).abs().max()) <= 2 * AdamWConfig().lr
        p_off += _off(a, b)
        n_all += b.numel()
    assert p_off <= n_all * WIDE_OFF_SHARE, (p_off, n_all)


def test_2x2_train_step_equals_the_references(runs):
    """The port's 2x2 step from the reference's initial parameters against
    the reference's 2x2 step: the loss, ``m`` and ``v`` at the stated
    tolerance, the parameters on all but 0.1% of their elements, each
    within ``2 lr`` (AdamW's ill-conditioned band, ROADMAP.md §3)."""
    ref = np.load(runs / "reference.npz")
    got = torch.load(runs / "2x2-reference.pt")
    cfg = W.ref_config()
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(ref["metric." + k]),
                                   err_msg=k, **LOSS_TOL)
    p_off = n_all = 0
    for prefix, tree in (("m1.", got["m"]), ("v1.", got["v"]), ("p1.", got["params"])):
        flat = params_to_reference(cfg, tree)
        for key in (k for k in ref.files if k.startswith(prefix)):
            node = flat
            for name in key[len(prefix):].split("/"):
                node = node[name]
            want = ref[key]
            if prefix == "p1.":
                assert np.abs(node - want).max() <= 2 * AdamWConfig().lr, key
                p_off += int((~np.isclose(node, want, **STATE_TOL)).sum())
                n_all += want.size
            else:
                np.testing.assert_allclose(node, want, err_msg=key, **STATE_TOL)
    assert p_off <= n_all * 1e-3, (p_off, n_all)
    assert to_numpy(got["metrics"]["lr"]).shape == ()


@pytest.mark.parametrize("H,KV,n", [(32, 4, 2), (32, 4, 4), (32, 4, 8), (32, 4, 16),
                                    (24, 1, 8), (16, 16, 4), (16, 4, 16)])
def test_kv_head_span_is_the_local_heads_groups(H, KV, n):
    """The KV heads a rank's query heads read (head ``h`` reads ``h // (H
    // KV)``), as ``kernels/ops.py`` narrows a replicated KV to them, for
    every rank of a model axis of ``n``."""
    from repro_torch.kernels.ops import _kv_head_span

    rep, hl = H // KV, H // n
    for r in range(n):
        lo, m = _kv_head_span(H, KV, r * hl, hl, "t")
        assert list(range(lo, lo + m)) == sorted({h // rep for h in range(r * hl, (r + 1) * hl)})


def test_kv_head_span_refuses_heads_that_straddle_groups():
    from repro_torch.kernels.ops import _kv_head_span

    # 12 heads on 4 KV heads (groups of 3), two heads a rank: rank 1 reads
    # groups 0 and 1 with one head each, which no local rep can express
    with pytest.raises(ValueError, match="cannot keep the grouping"):
        _kv_head_span(12, 4, 2, 2, "t")


# -- the two DTensor workarounds of torch 2.11, bitwise on one device ------------


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A 1 x 1 ``("data", "model")`` mesh over a gloo group of one rank in
    this process (a FileStore, no port), taken down after the module."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("mesh1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_test_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _leaf(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()


def _on(mesh, t, placements):
    from torch.distributed.tensor import distribute_tensor

    d = distribute_tensor(t.detach(), mesh, placements)
    return d.requires_grad_() if t.requires_grad else d


@pytest.mark.parametrize("table_pl", ["train", "replicated"])
def test_take_rows_is_the_lookup_bitwise(mesh1, table_pl):
    """``model._take_rows`` (the embedding lookup's workaround: the rows
    taken from the local tensors, the table's gradient a declared partial
    sum) against ``table[idx]`` on plain tensors and against DTensor's own
    lookup, which torch 2.11 cannot take backward: the rows and the table's
    gradient bit for bit, with repeated tokens."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.model import _take_rows

    rng = np.random.default_rng(3)
    V, D, Bsz, S = 40, 16, 4, 24
    table = _leaf(rng, (V, D))
    idx = torch.from_numpy(rng.integers(0, V // 2, (Bsz, S)))  # repeats
    g = torch.from_numpy(rng.standard_normal((Bsz, S, D)).astype(np.float32))
    want = table[idx]
    want.backward(g)
    pl = [Shard(1), Shard(0)] if table_pl == "train" else [Replicate(), Replicate()]
    for lookup in (_take_rows, lambda t, i: t[i]):  # the workaround, DTensor's own
        td = _on(mesh1, table, pl)
        rows = lookup(td, _on(mesh1, idx, [Shard(0), Replicate()]))
        assert torch.equal(rows.full_tensor(), want)
        rows.backward(_on(mesh1, g, list(rows.placements)))
        assert torch.equal(td.grad.full_tensor(), table.grad)
    assert torch.equal(_take_rows(table.detach(), idx), want)  # plain tensors: the lookup


@pytest.mark.parametrize("fn", ["sdpa", "chunked"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
def test_plain_attention_on_local_heads_is_bitwise(mesh1, fn, H, KV):
    """``layers._sdpa`` (and ``_sdpa_chunked``) on DTensors q/k/v sharded
    on the batch and the heads runs its einsums on each rank's shards
    (torch 2.11 cannot fold the sharded batch and heads): the output and
    the gradients of q, k and v equal the plain tensors' bit for bit."""
    from torch.distributed.tensor import Shard

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers

    rng = np.random.default_rng(H + KV)
    Bsz, S, T, hd = 2, 10, 12 if fn == "sdpa" else 10, 8
    q, k, v = _leaf(rng, (Bsz, S, H, hd)), _leaf(rng, (Bsz, T, KV, hd)), _leaf(rng, (Bsz, T, KV, hd))
    g = torch.from_numpy(rng.standard_normal((Bsz, S, H, hd)).astype(np.float32))
    mask = torch.from_numpy(rng.random((S, T)) < 0.8) | torch.eye(S, T, dtype=torch.bool)
    cfg = ModelConfig(family="dense", num_layers=1, d_model=H * hd, num_heads=H,
                      num_kv_heads=KV, attn_block=4)

    def run(a, b, c):
        if fn == "sdpa":
            return layers._sdpa(a, b, c, mask)
        return layers._sdpa_chunked(a, b, c, cfg, causal=True, window=3)

    want = run(q, k, v)
    want.backward(g)
    pl = [Shard(0), Shard(2)]
    qd, kd, vd = (_on(mesh1, t, pl) for t in (q, k, v))
    y = run(qd, kd, vd)
    assert tuple(y.placements) == tuple(pl) and torch.equal(y.full_tensor(), want)
    y.backward(_on(mesh1, g, pl))
    for d, t in ((qd, q), (kd, k), (vd, v)):
        assert torch.equal(d.grad.full_tensor(), t.grad)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("x_pl", ["batch_channels", "replicated"])
def test_causal_conv_on_local_shards_is_bitwise(mesh1, x_pl, with_state):
    """``ops.causal_conv`` on a DTensor xBC runs the conv on each rank's
    shards of the batch and the channels, the taps, the bias and the conv
    state cut to match (the plain version on the CPU): the output, the new
    state and the gradients of xBC, the taps and the bias equal the plain
    tensors' bit for bit, and the outputs keep xBC's placements."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.models.ssm import _causal_conv

    rng = np.random.default_rng(7 + with_state)
    Bsz, S, Ch, Wd = 2, 9, 12, 4
    x, w, b = _leaf(rng, (Bsz, S, Ch)), _leaf(rng, (Wd, Ch)), _leaf(rng, (Ch,))
    cv = _leaf(rng, (Bsz, Wd - 1, Ch)) if with_state else None
    g = torch.from_numpy(rng.standard_normal((Bsz, S, Ch)).astype(np.float32))
    pre, want_st = _causal_conv(x, w, b, cv)
    want = F.silu(pre)
    want.backward(g)
    b_grad, b.grad = b.grad, None
    pl = [Shard(0), Shard(2)] if x_pl == "batch_channels" else [Replicate(), Replicate()]
    xd, wd, bd = _on(mesh1, x, pl), _on(mesh1, w, [Replicate(), Shard(1)]), b  # b: plain
    cd = None if cv is None else _on(mesh1, cv, [Shard(0), Shard(2)])
    y, st = ops.causal_conv(xd, wd, bd, cd)
    assert tuple(y.placements) == tuple(st.placements) == tuple(pl)
    assert torch.equal(y.full_tensor(), want) and torch.equal(st.full_tensor(), want_st)
    y.backward(_on(mesh1, g, pl))
    assert torch.equal(xd.grad.full_tensor(), x.grad)
    assert torch.equal(wd.grad.full_tensor(), w.grad) and torch.equal(b.grad, b_grad)
    if cd is not None:
        assert torch.equal(cd.grad.full_tensor(), cv.grad)
