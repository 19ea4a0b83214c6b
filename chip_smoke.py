#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 chip_smoke.py

It drives the port (``src/repro_torch``) end to end and exits non-zero if
any phase fails:

1. builds every kernel of the main paths (seven sources: flash attention
   and the SSD scan each have a tensor-core route and a CUDA-core route)
   from ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per
   source, all started together), prints the card's name and power limit,
   and whether the tensor-core flash and SSD libraries' SASS hold
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads), by ``cuobjdump -sass``
   where the toolkit has it;
2. holds each kernel against its plain PyTorch version on the card — the
   GUS kernel's integer assignments must be equal (0 mismatches) on the
   golden frames, the paper's 20 000-instance numerical batch (plain and
   both Happy-* relaxations), degenerate frames and the dense fleet's own
   frames (a window, its first frame alone, the window with every budget
   spent); the class allocator's ``take``/``start`` cells and fixed-order
   loads on class grids built from generated frames (several seeds and
   padding buckets, one above 4096), duplicate classes, tie,
   all-infeasible, zero-count, exact-capacity and budget-carry frames, and
   one full-width window of the hierarchical main path;
3. runs the dense Monte-Carlo fleet (``simulate_fleet``, policy ``gus``) on
   the fleet benchmark's cluster (9 edges + 1 cloud, 5 services, 10
   variants; 30 s horizon, 6 req/s per edge): 64 replications with
   congestion off, on, and on with a half drain must equal the same call on
   the CPU, then 1024 replications in windows of 5 frames — the dense main
   path, whose kernel launches are counted;
4. runs the hierarchical class-aggregate fleet
   (``EngineOptions(scheduler="hierarchical")``) on the ``mega-city``
   scenario and the users-sweep cluster (20 edges + 1 cloud, 5 services, 10
   variants; 9 s horizon): at ~10^3 users per frame and 4 replications,
   congestion off and on with a half drain, it must equal the same call on
   the CPU; then the scenario's own defaults (streamed arrivals, 2400 req/s
   per edge, ~1.4e5 users per frame), 8 replications, ``window=1``,
   ``prefetch=2`` — the hierarchical main path, whose launches are counted;
5. runs every scheduling policy on the GUS kernel: each GUS-cored policy
   (``gus-ordered`` with and without priority weights, ``random`` with
   threefry keys, ``offload_all``, ``local_all``, ``gus-adaptive`` with a
   carry that shades overloaded servers and masks a down one) must equal its
   plain version (0 mismatches) on the paper batch and the golden frames;
   then the sequential testbed ``simulate`` — the paper's ``fig_scenarios``
   matrix, every registered policy on every ``dense_sweep`` scenario
   (3 edges + 1 cloud, 30 s, 2 req/s per edge, seed 0), plus ``gus`` and
   ``gus-adaptive`` congested at a half drain — on the card must equal the
   same calls on the CPU (``as_dict()``, bandwidth estimates, congestion
   stats): the sequential main path, whose B=1 GUS launches are counted;
   one point of Fig. 1(e)-(h) (200 requests, 120 s) for every batched
   policy, timed; and the dense fleet of phase 3 with ``random`` (one
   threefry key per replication and frame) and ``gus-ordered``: 64
   replications equal to the CPU, then 1024 in windows of 5, counted;
6. holds the attention kernels against their plain versions on the card
   (ragged lengths, GQA rep 1/4/8, window None and 8, head_dim 64, 128 and
   160, f32 and bf16: both flash routes; decode in one span and in several,
   masks partly and wholly invalid, a span with no valid position, and
   both kernels' serving-path launch shapes), then a small dense model
   (f32, GQA rep 4, a 16-token window whose ring wraps: the CUDA-core flash
   route) on the card against the same weights on the CPU: prefill logits
   and 8 greedy tokens;
7. serves yi-9b at full width and depth (48 layers, bf16, seeded random
   weights on the card): ``ServingEngine.generate`` on batch 8 x a
   1024-token prompt from ``make_batch(seed=0)``, 32 greedy tokens — the
   serving main path, whose 48 ``flash_attention`` launches (all on the
   tensor-core route) and 31 x 48 ``decode_attention`` launches are
   counted; greedy decoding is checked
   against argmax decoding by one full re-forward (in f32, at full width
   and 8 layers); ``torch.profiler`` splits one prefill's and four decode
   steps' device time by kernel kind and gives the device's busy share;
8. holds both SSD routes against the plain version on the card (S a
   multiple of the chunk and ragged, G = 1, 2 and 3, N = 16, 64 and 128,
   f32 and bf16, with and without the final state, and both SSM main
   paths' launch shapes; each launch's route counted), flash and decode
   attention at
   zamba2-1.2b's shapes (H = KV = 32, hd 64), then small f32 ``ssm`` and
   ``hybrid`` models (4 layers, a ragged prompt) on the card against the
   same weights on the CPU: forward and prefill logits, 8 greedy tokens;
9. serves zamba2-1.2b (38 Mamba-2 layers, 7 shared-attention sites) and
   mamba2-130m (24 layers) at full width and depth (bf16, seeded random
   weights) on batch 8 x a 2048-token prompt from ``make_batch(seed=0)``,
   32 greedy tokens — the SSM slice's main paths, each counted on its own:
   38 ``ssd_scan`` (tensor-core route), 7 ``flash_attention``
   (tensor-core route) and 7 x 31 ``decode_attention`` launches for
   zamba2, 24 ``ssd_scan`` (tensor-core route) for mamba2;
   ``torch.profiler``
   splits zamba2's prefill and decode device time by kernel kind; then one
   teacher-forcing ``forward`` of mamba2-130m at 8 x 2048 (24 counted
   launches, no state output);
10. checks prefill + decode against one forward in f32 at full width and
   depth (a 200-token prompt, 8 decode steps; the SSD's CUDA-core route):
   within 5e-3 for mamba2-130m, and for zamba2-1.2b with its shared
   attention's q/k/v rescaled to a fan-in of d_model;
11. times each kernel with CUDA events at its main path's launch shape
   beside its plain version, its bound (bytes over the card's memory
   rate, or operations over its rate) and, for attention, one
   ``scaled_dot_product_attention`` call as a library yardstick (never
   called by the port); the attention kernels also at zamba2-1.2b's
   launch shapes, and each attention kernel, its yardstick and the SSD
   kernel a second time as device time: one replay of a captured CUDA
   graph of many launches, which leaves out the Python wrapper's host
   time; the SSD's CUDA-core route at the same bf16 shapes beside its
   tensor-core route; the GUS kernel also at one frame (B=1, eager and
   device time) and on its window with every budget spent (its chain
   floor); the ordered policy at the paper batch, the scaled entry (priority
   weights) beside the plain entry at the fleet window, in turns, and the
   kernel at one decision of ``simulate`` (B=1: device time, eager, and with
   the wrapper's host time and the copy back); the class allocator's chain
   floor (the same window with every budget spent, so each class takes the
   shortest step);
12. prints one JSON line listing every ported kernel, then the contract line
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package.  Without a CUDA device,
or without the rest of the repository beside it, it fails before printing
any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM: HBM3 rate, float32 rate outside the tensor cores and the bf16
#: tensor-core rate (NVIDIA's data sheet, dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: float32 operations GUS does per candidate: 2 subtractions, 2 divisions,
#: 2 multiplications, 1 addition (Eq. 1) and 6 comparisons (feasibility,
#: budgets, argmax)
GUS_OPS_PER_CANDIDATE = 13
#: operations the class allocator does per cell of a chunk step: 4
#: comparisons (feasibility, budgets) and 1 for the argmax
HIER_OPS_PER_CELL = 5
#: the stated tolerance of ``mean_us_per_rep`` between devices: its row
#: mean is a float32 reduction whose summation order differs
US_RTOL, US_ATOL = 1e-5, 1e-6
#: attention kernel vs plain version (tests/test_kernels.py's tolerances)
ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
#: the model on the card vs on the CPU, f32 logits (tests/test_torch_model.py)
MODEL_RTOL = MODEL_ATOL = 1e-3
#: the serving main path: yi-9b at full width and depth
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "yi-9b", 8, 1024, 32
#: SSD kernel vs plain version: tests/test_kernels.py's Pallas-vs-plain SSD
#: bound in f32, its bf16 bound in bf16 (both versions compute in f32 and
#: round y once); the f32 final state at rtol 1e-3 with an absolute part of
#: 1e-4 of its largest entry
SSD_TOL = {"float32": dict(rtol=1e-3, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_STATE_RTOL, SSD_STATE_ATOL_SHARE = 1e-3, 1e-4
#: the SSM slice's main paths: zamba2-1.2b and mamba2-130m at full width and
#: depth, batch 8 x a 2048-token prompt, 32 greedy tokens
SSM_HYBRID_ARCH, SSM_ARCH, SSM_PROMPT = "zamba2-1.2b", "mamba2-130m", 2048
#: f32 prefill + decode vs forward at full width: a ragged prompt (200 =
#: 128 + 72) and 8 decode steps, held to tests/test_arch_smoke.py's 5e-3
SSM_ACC_PROMPT, SSM_ACC_STEPS, SSM_DECODE_ATOL = 200, 8, 5e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync(dev):
    """Wait for the card (a no-op on the CPU, where the phases are rehearsed)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def randn(dev, shape, dtype, seed):
    """Standard normal draws on ``dev`` from ``seed``, made in f32 and cast
    to ``dtype`` (a torch dtype name)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(
        getattr(torch, dtype))


def compare_attn(errs, name, label, got, want, dtype):
    """Hold an attention kernel's output against its plain version at
    ``ATTN_TOL``; ``errs[name]`` keeps the largest error seen."""
    import torch

    sync(got.device)
    err = float((got.float() - want.float()).abs().max())
    errs[name] = max(errs[name], err)
    ok = torch.allclose(got.float(), want.float(), **ATTN_TOL[dtype])
    print(f"compare {name} {label} {dtype}: max_abs_err={err} within {ATTN_TOL[dtype]}: {ok}")
    check(ok, f"{name} kernel != plain version on {label} {dtype}")


def time_events(fn, reps, warmup=2):
    """Mean ms of ``fn()`` over ``reps`` calls after ``warmup`` calls, by
    CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_graph(fn, reps):
    """Mean ms of ``fn()`` as device time: ``reps`` calls captured in one
    CUDA graph (after a warm-up call on a side stream) and replayed once,
    timed by CUDA events, so the host's time per call drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes, ops, dtype):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    memory rate and ``ops`` over the rate of ``dtype``'s operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(fn, reps, timer=time_events):
    """One PyTorch call for the same function, timed as a yardstick only."""
    try:
        return timer(fn, reps)
    except RuntimeError as exc:  # a backend that refuses these inputs (or a capture)
        print(f"library yardstick unavailable: {exc}")
        return None


def attention_bounds(B, H, KV, S, T, n_valid, hd, dtype):
    """((ms, by) of flash, (ms, by) of decode) at a serving launch shape.
    Flash over an S-token causal prompt: q, k, v and out once, two dot
    products of hd multiply-adds for each of the S (S + 1) / 2 causal
    (row, col) pairs.  Decode over a T-position cache: q and out once, the
    ``n_valid`` valid positions' k and v once, the (B, T) mask."""
    import torch

    elt = getattr(torch, dtype).itemsize
    flash = bound(2 * B * (H + KV) * S * hd * elt, 4 * hd * B * H * (S * (S + 1) // 2), dtype)
    decode = bound(2 * B * H * hd * elt + 2 * B * KV * n_valid * hd * elt + B * T,
                   4 * hd * B * H * n_valid, dtype)
    return flash, decode


class AttentionLaunch:
    """Both attention kernels' inputs at a serving launch shape of ``cfg``
    (``batch`` x ``prompt`` tokens, then ``gen``), as model-layout views the
    way the path hands them over: flash q/k/v over the prompt, one decode
    query, six k/v caches of prompt + gen positions (timed launches take
    them in turn, so each finds its cache out of L2 as the serving path
    does, where the layers' weights stream between two launches) and the
    last decode step's mask (every position but one holds a token)."""

    def __init__(self, dev, cfg, batch, prompt, gen, seed):
        import torch

        self.dtype = dt = cfg.dtype
        self.B, self.H, self.KV, self.hd = batch, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.S, self.T = prompt, prompt + gen
        B, H, KV, hd, S, T = self.B, self.H, self.KV, self.hd, self.S, self.T
        self.fq = randn(dev, (B, S, H, hd), dt, seed).transpose(1, 2)
        self.fk = randn(dev, (B, S, KV, hd), dt, seed + 1).transpose(1, 2)
        self.fv = randn(dev, (B, S, KV, hd), dt, seed + 2).transpose(1, 2)
        self.dq = randn(dev, (B, KV, H // KV, hd), dt, seed + 3)
        self.caches = randn(dev, (6, 2, B, T, KV, hd), dt, seed + 4)
        self.valid = (torch.arange(T, device=dev) < T - 1)[None].expand(B, T)
        self.turn = 0

    def cache(self, i=0):
        """The (k, v) views of cache ``i``."""
        return self.caches[i, 0].transpose(1, 2), self.caches[i, 1].transpose(1, 2)

    def next_cache(self):
        self.turn = (self.turn + 1) % self.caches.shape[0]
        return self.cache(self.turn)

    def label(self, name):
        if name == "flash_attention":
            return f"B={self.B} H={self.H} KV={self.KV} S={self.S} hd={self.hd}"
        return f"B={self.B} KV={self.KV} rep={self.H // self.KV} T={self.T} hd={self.hd}"

    def compare(self, errs, where):
        """Hold both kernels against their plain versions at this shape."""
        from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
        from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

        q, k, v = self.fq, self.fk, self.fv
        compare_attn(errs, "flash_attention", f"{where} {self.label('flash_attention')}",
                     flash_attention(q, k, v, backend="cuda"), flash_attention_ref(q, k, v),
                     self.dtype)
        k, v = self.cache()
        compare_attn(errs, "decode_attention", f"{where} {self.label('decode_attention')}",
                     decode_attention(self.dq, k, v, self.valid, backend="cuda"),
                     decode_attention_ref(self.dq, k, v, self.valid), self.dtype)

    def time(self, where):
        """Each kernel, its plain version and ``scaled_dot_product_attention``
        timed by CUDA events next to the bound, and the kernel and the
        yardstick again as device time (``time_graph``): ``{name: {"ms",
        "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library_graph_ms"}}``."""
        import torch

        from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
        from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

        sdpa = torch.nn.functional.scaled_dot_product_attention
        q, k, v, dq, valid = self.fq, self.fk, self.fv, self.dq, self.valid
        n_valid = int(valid[0].sum())
        (fb_ms, fb_by), (db_ms, db_by) = attention_bounds(
            self.B, self.H, self.KV, self.S, self.T, n_valid, self.hd, self.dtype)
        mask = valid[:, None, None, :]

        def flash():
            flash_attention(q, k, v, backend="cuda")

        def flash_lib():
            sdpa(q, k, v, is_causal=True, enable_gqa=True)

        def decode():
            decode_attention(dq, *self.next_cache(), valid, backend="cuda")

        def decode_lib():
            sdpa(dq.flatten(1, 2)[:, :, None], *self.next_cache(), attn_mask=mask,
                 enable_gqa=True)

        out = {
            "flash_attention": {
                "ms": time_events(flash, 10),
                "graph_ms": time_graph(flash, 10),
                "plain_ms": time_events(lambda: flash_attention_ref(q, k, v), 3, warmup=1),
                "bound_ms": fb_ms, "bound_by": fb_by,
                "library_ms": library_ms(flash_lib, 10),
                "library_graph_ms": library_ms(flash_lib, 10, time_graph),
            },
            "decode_attention": {
                "ms": time_events(decode, 60),
                "graph_ms": time_graph(decode, 60),
                "plain_ms": time_events(
                    lambda: decode_attention_ref(dq, *self.next_cache(), valid), 12),
                "bound_ms": db_ms, "bound_by": db_by,
                "library_ms": library_ms(decode_lib, 60),
                "library_graph_ms": library_ms(decode_lib, 60, time_graph),
            },
        }
        for name, t in out.items():
            extra = f" valid={n_valid}" if name == "decode_attention" else " causal"
            print(
                f"time {name} {where} launch {self.label(name)}{extra} {self.dtype}: kernel "
                f"{t['ms']:.4f} ms eager, {t['graph_ms']:.4f} ms device (graph replay), plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                f"device/bound {t['graph_ms'] / t['bound_ms']:.2f}x, library "
                f"scaled_dot_product_attention {t['library_ms']} ms eager, "
                f"{t['library_graph_ms']} ms device"
            )
        return out


def tree_size(tree):
    """(elements, bytes) of a parameter tree of dicts and lists of tensors."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        sizes = [tree_size(t) for t in tree]
        return sum(n for n, _ in sizes), sum(b for _, b in sizes)
    return tree.numel(), tree.numel() * tree.element_size()


def serving_smoke(dev, zero_counts, cfg_serve, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                  gen=SERVE_GEN):
    """Phases 6-7 and the attention part of phase 11: the attention kernels
    against their plain versions, the small model on the card against the
    CPU, the counted serving main path (``cfg_serve`` at its own width and
    depth, ``batch`` x ``prompt`` tokens, ``gen`` greedy tokens) and both
    kernels timed at its launch shapes.  Returns each kernel's entry of the
    ``kernels`` line without its name, route, source and replaced kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import reduce_for_smoke
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
        decode_splits,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
        flash_route,
    )
    from repro_torch.kernels.gus import gus_assign
    from repro_torch.kernels.hier import hier_cells
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, params_to
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_batch

    # -- 6. the attention kernels vs their plain versions, the small model
    #       on the card vs the CPU --------------------------------------------
    attn_err = {"flash_attention": 0.0, "decode_attention": 0.0}

    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for B, H, KV, S, hd, win in (
            (2, 4, 4, 100, 64, None),     # rep 1, ragged S
            (1, 8, 2, 200, 128, 8),       # rep 4, window 8
            (2, 16, 2, 77, 128, None),    # rep 8, ragged
            (1, 8, 1, 130, 64, 8),        # rep 8, window 8, ragged
            (1, 8, 1, 300, 128, 100),     # rep 8, a window that starts mid-tile
            (1, 4, 2, 40, 160, 16),       # hd 160: the CUDA-core route in bf16 too
        ):
            q = randn(dev, (B, S, H, hd), dtype, 1).transpose(1, 2)  # model-layout views
            k = randn(dev, (B, S, KV, hd), dtype, 2).transpose(1, 2)
            v = randn(dev, (B, S, KV, hd), dtype, 3).transpose(1, 2)
            route = flash_route(q.dtype, hd)
            before = flash_attention.route_launches[route]
            compare_attn(
                attn_err, "flash_attention",
                f"B={B} H={H} KV={KV} S={S} hd={hd} window={win} route={route}",
                flash_attention(q, k, v, causal=True, window=win, backend="cuda"),
                flash_attention_ref(q, k, v, causal=True, window=win), dtype,
            )
            check(flash_attention.route_launches[route] == before + 1,
                  f"flash_attention did not launch its {route} route")
        for B, KV, rep, T, hd in ((2, 4, 1, 100, 64), (3, 2, 4, 257, 128), (2, 4, 8, 333, 128),
                                  (2, 4, 8, 1056, 128), (9, 32, 1, 300, 64)):
            q = randn(dev, (B, KV, rep, hd), dtype, 4)
            k = randn(dev, (B, T, KV, hd), dtype, 5).transpose(1, 2)  # cache-layout views
            v = randn(dev, (B, T, KV, hd), dtype, 6).transpose(1, 2)
            g = torch.Generator(device=dev).manual_seed(7)
            valid = torch.rand((B, T), generator=g, device=dev) < 0.6
            valid[0] = False  # no valid position at all: zeros
            n_split, span = decode_splits(B, KV, T)
            if n_split > 1:
                valid[1, :span] = False  # a span with no valid position drops out
            got = decode_attention(q, k, v, valid, backend="cuda")
            again = decode_attention(q, k, v, valid, backend="cuda")
            compare_attn(attn_err, "decode_attention",
                         f"B={B} KV={KV} rep={rep} T={T} hd={hd} spans={n_split}x{span}", got,
                         decode_attention_ref(q, k, v, valid), dtype)
            check(bool((got[0] == 0).all()), "an all-invalid decode row must be zeros")
            check(torch.equal(got, again), "split decode must not change from run to run")

    # both kernels at the serving main path's launch shapes and dtype
    launch = AttentionLaunch(dev, cfg_serve, batch, prompt, gen, 8)
    launch.compare(attn_err, "main-path launch")
    print(f"attention kernel comparisons: {time.perf_counter() - t0:.3f} s")

    # the same small model (f32, rep 4, 16-token window) on the card and the CPU
    t0 = time.perf_counter()
    small = dataclasses.replace(reduce_for_smoke(cfg_serve), num_kv_heads=1, sliding_window=16)
    small_model = Model(small)
    cpu_params = small_model.init(0, device="cpu")
    card_params = params_to(cpu_params, dev)
    sb = make_batch(small, 2, 24, np.random.default_rng(0), device="cpu")
    sb_card = {k: t.to(dev) for k, t in sb.items()}
    lc, _ = small_model.prefill(cpu_params, sb, small_model.init_cache(2, 32, device="cpu"))
    lg, _ = small_model.prefill(card_params, sb_card, small_model.init_cache(2, 32, device=dev))
    logit_err = float((lg.cpu() - lc).abs().max())
    tok_card = ServingEngine(small_model, card_params, device=dev).generate(sb_card, 8).tokens
    tok_cpu = ServingEngine(small_model, cpu_params, device="cpu").generate(sb, 8).tokens
    print(
        f"small model card vs cpu ({small.num_layers} layers, d={small.d_model}, "
        f"H={small.num_heads} KV={small.num_kv_heads}, window={small.sliding_window}, 24-token "
        f"prompt + 8): prefill logits max_abs_diff={logit_err}, tokens equal="
        f"{np.array_equal(tok_card, tok_cpu)}, {time.perf_counter() - t0:.3f} s"
    )
    check(torch.allclose(lg.cpu(), lc, rtol=MODEL_RTOL, atol=MODEL_ATOL),
          "the small model's prefill logits on the card != on the CPU")
    check(np.array_equal(tok_card, tok_cpu), "the small model's greedy tokens differ")
    serve(cfg_serve.arch_id, batch=2, prompt=24, gen=4)  # the serving command, reduced config, on the card

    # -- 7. the serving main path: at full width and depth ------------------
    serve_model = Model(cfg_serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # left by the earlier phases
    t0 = time.perf_counter()
    serve_params = serve_model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    param_bytes = tree_size(serve_params)[1]
    engine = ServingEngine(serve_model, serve_params, device=dev)
    prompt_batch = make_batch(cfg_serve, batch, prompt, np.random.default_rng(0), device=dev)
    zero_counts()
    torch.cuda.synchronize()
    res = engine.generate(prompt_batch, max_new_tokens=gen)
    n_flash, n_decode = flash_attention.launches, decode_attention.launches
    routes = dict(flash_attention.route_launches)
    check(gus_assign.launches == hier_cells.launches == ssd_scan.launches == 0,
          "the serving main path launched a scheduler or SSD kernel")
    peak = torch.cuda.max_memory_allocated() - base
    W = serve_model.cache_window(prompt + gen)
    cache_bytes = 2 * cfg_serve.num_layers * batch * W * cfg_serve.num_kv_heads * \
        cfg_serve.head_dim * 2
    gen_tokens = batch * gen
    print(
        f"serve main path {SERVE_ARCH} ({cfg_serve.num_layers} layers, d={cfg_serve.d_model}, "
        f"H={cfg_serve.num_heads} KV={cfg_serve.num_kv_heads}, {cfg_serve.dtype}): "
        f"batch={batch} prompt={prompt} gen={gen}: "
        f"prefill_ms {res.prefill_ms:.3f} decode_ms_per_token {res.decode_ms_per_token:.3f} "
        f"total_ms {res.total_ms:.3f} generated tokens/s {gen_tokens / res.total_ms * 1e3:.1f} "
        f"decode tokens/s {batch / res.decode_ms_per_token * 1e3:.1f} "
        f"init_s {init_s:.3f} params {param_bytes / 1e9:.3f} GB ({cfg_serve.n_params()} "
        f"params) kv_cache {cache_bytes / 1e9:.3f} GB peak memory of the path {peak / 1e9:.3f} GB "
        f"(max_memory_allocated less {base / 1e9:.3f} GB held by earlier phases) "
        f"flash_attention launches={n_flash} (by route {json.dumps(routes)}) "
        f"decode_attention launches={n_decode} "
        f"(spans {decode_splits(batch, cfg_serve.num_kv_heads, W)})"
    )
    check(n_flash == cfg_serve.num_layers,
          f"prefill must launch flash_attention once per layer, got {n_flash}")
    check(routes == {"wgmma": n_flash, "simt": 0},
          f"prefill must run the tensor-core flash route, got {routes}")
    check(n_decode == (gen - 1) * cfg_serve.num_layers,
          f"decode must launch decode_attention once per layer and step, got {n_decode}")
    toks = res.tokens
    check(toks.shape == (batch, gen) and (toks >= 0).all()
          and (toks < cfg_serve.vocab_size).all(), "serving main path tokens malformed")

    def reforward_agreement(model, params, toks):
        """Share of the generated tokens that argmax decoding by one full
        teacher-forced re-forward of prompt + generated reproduces."""
        full = torch.cat([prompt_batch["tokens"], torch.from_numpy(toks[:, :-1]).to(dev)], dim=1)
        logits, _ = model.forward(params, {"tokens": full})
        check(bool(torch.isfinite(logits).all()), "the re-forward's logits are not finite")
        again = torch.argmax(logits[:, prompt - 1:], dim=-1).cpu().numpy()
        return float((again == toks).mean())

    # Reported, not held: this random-init network amplifies rounding.  The
    # reference's init takes a 3-D leaf's fan-in from shape[-2], so w_q and
    # w_k have stds of 1/sqrt(H) and 1/sqrt(KV) and the attention scores a
    # std of hundreds: each softmax is nearly one-hot, a last-bit change in
    # a key can move it to another position, and that change reaches every
    # later position through the cache.  Decoding and the re-forward run
    # products of other shapes, which cuBLAS rounds differently.
    print(f"serve main path: generated == argmax of the bf16 re-forward on "
          f"{reforward_agreement(serve_model, serve_params, toks):.4f} of tokens")
    profile_serving(serve_model, serve_params, prompt_batch)
    del engine, serve_params

    # The check at full width: f32, depth cut to 8 layers.  First the
    # amplification itself: the same forward over the prompt, once at batch
    # 8 and once as two batches of 4 (only cuBLAS's rounding differs).  Then
    # q, k and v projections rescaled to a fan-in of d_model (stds of
    # 1/sqrt(d_model), scores of order 1): the split forward must agree, and
    # greedy decoding must reproduce the re-forward.
    cfg32 = dataclasses.replace(cfg_serve, num_layers=8, dtype="float32", param_dtype="float32")
    model32 = Model(cfg32)
    params32 = model32.init(1, device=dev)

    def split_agreement():
        whole = model32.forward(params32, prompt_batch)[0][:, -gen:].argmax(-1)
        half = batch // 2
        parts = torch.cat([
            model32.forward(params32, {"tokens": prompt_batch["tokens"][i:i + half]})[0][
                :, -gen:].argmax(-1)
            for i in (0, half)
        ])
        return float((whole == parts).float().mean())

    raw = split_agreement()
    for lp in params32["layers"]:
        for name, fan_in in (("w_q", cfg32.num_heads), ("w_k", cfg32.num_kv_heads),
                             ("w_v", cfg32.num_kv_heads)):
            lp["attn"][name].mul_(math.sqrt(fan_in / cfg32.d_model))
    scaled = split_agreement()
    toks32 = ServingEngine(model32, params32, device=dev).generate(prompt_batch, gen).tokens
    agree32 = reforward_agreement(model32, params32, toks32)
    print(
        f"serve path f32, full width, 8 layers: argmax of forward(B={batch}) == forward(2 x "
        f"B={batch // 2}) on the last {gen} prompt positions: {raw:.4f} with the reference's "
        f"init, {scaled:.4f} with q/k/v at fan-in d_model; then generated == argmax of the "
        f"re-forward on {agree32:.4f} of tokens"
    )
    check(scaled >= 0.95 and agree32 >= 0.95, "f32 greedy decoding disagrees with the re-forward")
    del params32

    timed = launch.time("main-path")
    flash_ms = timed["flash_attention"]["graph_ms"]
    decode_ms = timed["decode_attention"]["graph_ms"]
    print(
        f"serve main path attention share: flash {n_flash} x {flash_ms:.4f} ms of "
        f"{res.prefill_ms:.3f} ms prefill, decode {n_decode} x {decode_ms:.4f} ms of "
        f"{res.decode_ms_per_token * (gen - 1):.3f} ms decode (device times at the launch "
        "shape, out of L2)"
    )

    timed["flash_attention"].update(launches=n_flash, routes=routes,
                                    max_abs_err=attn_err["flash_attention"])
    timed["decode_attention"].update(launches=n_decode,
                                     max_abs_err=attn_err["decode_attention"])
    return timed


def ssm_smoke(dev, zero_counts, hybrid_cfg, ssm_cfg, batch=SERVE_BATCH, prompt=SSM_PROMPT,
              gen=SERVE_GEN, acc_prompt=SSM_ACC_PROMPT, acc_steps=SSM_ACC_STEPS):
    """Phases 8-10 and the SSM slice's part of phase 11: the SSD kernel
    against its plain version, flash and decode at the hybrid's shapes, the
    small ``ssm`` and ``hybrid`` models on the card against the CPU, the
    counted main paths (``hybrid_cfg`` and ``ssm_cfg`` served at their own
    width and depth, ``batch`` x ``prompt`` tokens, ``gen`` greedy tokens;
    one teacher-forcing forward of ``ssm_cfg``), f32 decode against forward
    at full width, the SSD kernel timed at both launch shapes and the
    attention kernels at the hybrid's.  Returns ``ssd_scan``'s entry of the
    ``kernels`` line without its name, route, source and replaced kernel,
    and the attention kernels' entries at the hybrid's launch shapes."""
    import numpy as np
    import torch

    from repro_torch.configs import reduce_for_smoke
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gus import gus_assign
    from repro_torch.kernels.hier import hier_cells
    from repro_torch.kernels import ssd_scan as ssd_module
    from repro_torch.kernels.ssd_scan import ssd_route, ssd_scan, ssd_scan_ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, params_to
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_batch

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errs = dict.fromkeys(ssd_scan.route_launches, 0.0)  # by route

    def ssd_inputs(B, H, G, S, P, N, dtype, seed):
        """tests/test_kernels.py's distributions, made on the card."""
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((B, H, S, P), generator=g, device=dev).to(dtypes[dtype])
        dt = (0.001 + 0.099 * torch.rand((B, H, S), generator=g, device=dev)).to(dtypes[dtype])
        A = -(0.5 + 3.5 * torch.rand((H,), generator=g, device=dev))
        Bm = torch.randn((B, G, S, N), generator=g, device=dev).to(dtypes[dtype])
        Cm = torch.randn((B, G, S, N), generator=g, device=dev).to(dtypes[dtype])
        return x, dt, A, Bm, Cm

    def compare_ssd(label, args, chunk, dtype, final):
        route = ssd_route(args[0].dtype, args[0].shape[3], args[3].shape[3], chunk)
        before = ssd_scan.route_launches[route]
        got = ssd_scan(*args, chunk=chunk, return_final_state=final, backend="cuda")
        want = ssd_scan_ref(*args, chunk, return_final_state=final)
        sync(dev)
        (got, gst), (want, wst) = (got, want) if final else ((got, None), (want, None))
        err = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), **SSD_TOL[dtype])
        msg = f"y max_abs_err={err} within {SSD_TOL[dtype]}: {ok}"
        if final:
            st_err = float((gst - wst).abs().max())
            st_atol = SSD_STATE_ATOL_SHARE * float(wst.abs().max())
            st_ok = torch.allclose(gst, wst, rtol=SSD_STATE_RTOL, atol=st_atol)
            msg += (f"; final state max_abs_err={st_err} within rtol={SSD_STATE_RTOL}, "
                    f"atol={st_atol:.3e}: {st_ok}")
            ok = ok and st_ok
        errs[route] = max(errs[route], err)
        print(f"compare ssd_scan {label} {dtype} route={route}: {msg}")
        check(ok, f"ssd_scan kernel != plain version on {label} {dtype}")
        check(ssd_scan.route_launches[route] == before + 1,
              f"ssd_scan did not launch its {route} route")

    # -- 8. the SSD kernel vs its plain version; flash and decode at the
    #       hybrid's shapes ---------------------------------------------------
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for B, H, G, S, P, N, Q, final in (
            (2, 4, 4, 256, 64, 128, 128, True),    # whole chunks, N 128
            (2, 4, 1, 2000, 64, 64, 128, True),    # ragged S, G 1, N 64
            (2, 4, 1, 2000, 64, 64, 128, False),   # the same, no state output
            (1, 8, 2, 300, 64, 128, 128, True),    # G 2, ragged, N 128
            (1, 6, 3, 77, 64, 64, 128, False),     # G 3, S below one chunk
            (1, 8, 2, 300, 64, 128, 64, False),    # G 2, ragged, chunk 64
            (1, 6, 3, 77, 32, 16, 16, True),       # G 3, small P, N and chunk
        ):
            compare_ssd(f"B={B} H={H} G={G} S={S} P={P} N={N} Q={Q} state={final}",
                        ssd_inputs(B, H, G, S, P, N, dtype, S + N), Q, dtype, final)

    def launch_shape(cfg):
        return (batch, cfg.ssm_nheads, cfg.ssm_ngroups, prompt, cfg.ssm_headdim, cfg.ssm_state)

    main_args = {}
    for cfg in (hybrid_cfg, ssm_cfg):
        B, H, G, S, P, N = launch_shape(cfg)
        main_args[cfg.arch_id] = ssd_inputs(B, H, G, S, P, N, cfg.dtype, 21)
        compare_ssd(f"main-path launch {cfg.arch_id} B={B} H={H} G={G} S={S} P={P} N={N} "
                    f"Q={cfg.ssd_chunk} state=True", main_args[cfg.arch_id], cfg.ssd_chunk,
                    cfg.dtype, True)

    attn_err = {"flash_attention": 0.0, "decode_attention": 0.0}

    hybrid_launch = AttentionLaunch(dev, hybrid_cfg, batch, prompt, gen, 31)
    hybrid_launch.compare(attn_err, f"{hybrid_cfg.arch_id} launch")
    print(f"ssd/attention kernel comparisons: {time.perf_counter() - t0:.3f} s")

    # -- 8. (cont.) the small ssm and hybrid models on the card vs the CPU ---
    for cfg in (hybrid_cfg, ssm_cfg):
        t0 = time.perf_counter()
        small = dataclasses.replace(reduce_for_smoke(cfg), num_layers=4)
        model = Model(small)
        cpu_params = model.init(0, device="cpu")
        card_params = params_to(cpu_params, dev)
        sb = make_batch(small, 2, 45, np.random.default_rng(0), device="cpu")  # ragged: 45
        sb_card = {k: t.to(dev) for k, t in sb.items()}
        fc, fg = model.forward(cpu_params, sb)[0], model.forward(card_params, sb_card)[0].cpu()
        fwd_err = float((fg - fc).abs().max())
        lc, _ = model.prefill(cpu_params, sb, model.init_cache(2, 64, device="cpu"))
        lg, _ = model.prefill(card_params, sb_card, model.init_cache(2, 64, device=dev))
        logit_err = float((lg.cpu() - lc).abs().max())
        tok_card = ServingEngine(model, card_params, device=dev).generate(sb_card, 8).tokens
        tok_cpu = ServingEngine(model, cpu_params, device="cpu").generate(sb, 8).tokens
        print(f"small {small.family} model card vs cpu ({small.num_layers} layers, "
              f"d={small.d_model}, {small.ssm_nheads} SSM heads, N={small.ssm_state}, "
              f"{model.n_attn_sites()} attention sites, 45-token prompt + 8): forward logits "
              f"max_abs_diff={fwd_err}, prefill logits max_abs_diff={logit_err}, tokens equal="
              f"{np.array_equal(tok_card, tok_cpu)}, {time.perf_counter() - t0:.3f} s")
        check(torch.allclose(fg, fc, rtol=MODEL_RTOL, atol=MODEL_ATOL) and torch.allclose(
            lg.cpu(), lc, rtol=MODEL_RTOL, atol=MODEL_ATOL),
            f"the small {small.family} model's logits on the card != on the CPU")
        check(np.array_equal(tok_card, tok_cpu), f"the small {small.family} model's tokens differ")
        serve(cfg.arch_id, batch=2, prompt=37, gen=4, device=dev)  # the serving command, reduced

    # -- 9. the main paths: the hybrid and the ssm model at full width and
    #       depth, then the ssm model's teacher-forcing forward --------------
    def counts():
        return {"ssd_scan": ssd_scan.launches, "ssd_routes": dict(ssd_scan.route_launches),
                "flash_attention": flash_attention.launches,
                "flash_routes": dict(flash_attention.route_launches),
                "decode_attention": decode_attention.launches,
                "scheduler": gus_assign.launches + hier_cells.launches}

    served = {}
    for cfg in (hybrid_cfg, ssm_cfg):
        model = Model(cfg)
        sync(dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = model.init(0, device=dev)
        sync(dev)
        init_s = time.perf_counter() - t0
        engine = ServingEngine(model, params, device=dev)
        prompt_batch = make_batch(cfg, batch, prompt, np.random.default_rng(0), device=dev)
        zero_counts()
        sync(dev)
        res = engine.generate(prompt_batch, max_new_tokens=gen)
        n = counts()
        peak = torch.cuda.max_memory_allocated() - base
        cache = model.init_cache(batch, prompt + gen, device=dev)
        cache_bytes = sum(t.numel() * t.element_size() for t in (
            [cache.conv, cache.ssm] + ([cache.attn["k"], cache.attn["v"]] if cache.attn else [])))
        del cache
        sites = model.n_attn_sites()
        print(
            f"serve main path {cfg.arch_id} ({cfg.num_layers} layers, d={cfg.d_model}, "
            f"{cfg.ssm_nheads} SSM heads x P={cfg.ssm_headdim}, N={cfg.ssm_state}, "
            f"{sites} attention sites, {cfg.dtype}): batch={batch} prompt={prompt} gen={gen}: "
            f"prefill_ms {res.prefill_ms:.3f} decode_ms_per_token {res.decode_ms_per_token:.3f} "
            f"total_ms {res.total_ms:.3f} generated tokens/s "
            f"{batch * gen / res.total_ms * 1e3:.1f} decode tokens/s "
            f"{batch / res.decode_ms_per_token * 1e3:.1f} prefill tokens/s "
            f"{batch * prompt / res.prefill_ms * 1e3:.1f} init_s {init_s:.3f} params "
            f"{tree_size(params)[0]} ({tree_size(params)[1] / 1e9:.3f} GB; config n_params "
            f"{cfg.n_params()}) cache {cache_bytes / 1e9:.4f} GB peak memory of the path "
            f"{peak / 1e9:.3f} GB (max_memory_allocated less {base / 1e9:.3f} GB held before) "
            f"launches {json.dumps(n)}"
        )
        check(n["ssd_scan"] == cfg.num_layers,
              f"prefill must launch ssd_scan once per mamba layer, got {n['ssd_scan']}")
        check(n["ssd_routes"] == {"wgmma": cfg.num_layers, "simt": 0},
              f"prefill must run the tensor-core SSD route, got {n['ssd_routes']}")
        check(n["flash_attention"] == sites,
              f"prefill must launch flash_attention once per attention site, got "
              f"{n['flash_attention']}")
        check(n["flash_routes"] == {"wgmma": sites, "simt": 0},
              f"prefill must run the tensor-core flash route, got {n['flash_routes']}")
        check(n["decode_attention"] == (gen - 1) * sites,
              f"decode must launch decode_attention once per site and step, got "
              f"{n['decode_attention']}")
        check(n["scheduler"] == 0, "the serving main path launched a scheduler kernel")
        toks = res.tokens
        check(toks.shape == (batch, gen) and (toks >= 0).all() and (toks < cfg.vocab_size).all(),
              f"{cfg.arch_id} main path tokens malformed")
        served[cfg.arch_id] = n
        if cfg is hybrid_cfg:
            profile_serving(model, params, prompt_batch)
        else:
            zero_counts()
            sync(dev)
            t0 = time.perf_counter()
            logits, _ = model.forward(params, prompt_batch)
            sync(dev)
            fwd_ms = (time.perf_counter() - t0) * 1e3
            nf = counts()
            print(f"forward main path {cfg.arch_id} B={batch} S={prompt} (teacher forcing, no "
                  f"state output): {fwd_ms:.3f} ms, launches {json.dumps(nf)}, logits "
                  f"{tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())}")
            check(nf["ssd_scan"] == cfg.num_layers and nf["flash_attention"] == 0
                  and nf["decode_attention"] == 0 and nf["scheduler"] == 0,
                  "the forward must launch ssd_scan once per layer and nothing else")
            check(nf["ssd_routes"] == {"wgmma": cfg.num_layers, "simt": 0},
                  f"the bf16 forward must run the tensor-core SSD route, got {nf['ssd_routes']}")
            check(tuple(logits.shape) == (batch, prompt, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()), "the forward's logits are malformed")
            del logits
        del engine, params

    # -- 10. f32 at full width and depth: prefill + decode == forward --------
    def decode_vs_forward(cfg, rescale):
        """Max |logit| difference between prefill + teacher-forced decode and
        one forward over the same tokens, f32, ragged prompt; and the share
        of positions whose argmax agrees."""
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        model = Model(cfg32)
        params = model.init(1, device=dev)
        if rescale:
            # the reference's init gives w_q, w_k, w_v a fan-in of H or KV
            # (shape[-2] of a 3-D leaf), so scores have a std in the tens and
            # every softmax is nearly one-hot; rescale to a fan-in of d_model
            sa = params["shared_attn"]["attn"]
            for name, fan_in in (("w_q", cfg32.num_heads), ("w_k", cfg32.num_kv_heads),
                                 ("w_v", cfg32.num_kv_heads)):
                sa[name].mul_(math.sqrt(fan_in / cfg32.d_model))
        toks = make_batch(cfg32, 2, acc_prompt + acc_steps, np.random.default_rng(1),
                          device=dev)["tokens"]
        full, _ = model.forward(params, {"tokens": toks})
        last, cache = model.prefill(params, {"tokens": toks[:, :acc_prompt]},
                                    model.init_cache(2, acc_prompt + acc_steps, device=dev))
        got = [last[:, 0]]
        for t in range(acc_prompt, acc_prompt + acc_steps):
            lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
            got.append(lg[:, 0])
        got = torch.stack(got, 1)
        want = full[:, acc_prompt - 1:]
        err = float((got - want).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        return err, agree, float(want.abs().max())

    t0 = time.perf_counter()
    ssd_scan.route_launches = dict.fromkeys(ssd_scan.route_launches, 0)
    err, agree, scale = decode_vs_forward(ssm_cfg, False)
    print(f"{ssm_cfg.arch_id} f32 full width and depth, prompt {acc_prompt} + {acc_steps} "
          f"decode steps: max |decode - forward| logits {err} (max |logit| {scale}), argmax "
          f"agreement {agree:.4f}, bound {SSM_DECODE_ATOL}")
    check(err < SSM_DECODE_ATOL, f"{ssm_cfg.arch_id} f32 decode disagrees with the forward")
    raw_err, raw_agree, _ = decode_vs_forward(hybrid_cfg, False)
    err, agree, scale = decode_vs_forward(hybrid_cfg, True)
    print(f"{hybrid_cfg.arch_id} f32 full width and depth, prompt {acc_prompt} + {acc_steps} "
          f"decode steps: max |decode - forward| logits {raw_err} (argmax agreement "
          f"{raw_agree:.4f}) with the reference's init; {err} (max |logit| {scale}, argmax "
          f"agreement {agree:.4f}) with q/k/v at fan-in d_model; bound {SSM_DECODE_ATOL}; "
          f"{time.perf_counter() - t0:.3f} s")
    check(err < SSM_DECODE_ATOL, f"{hybrid_cfg.arch_id} f32 decode disagrees with the forward")
    f32_routes = dict(ssd_scan.route_launches)
    print(f"f32 checks' ssd_scan launches by route: {json.dumps(f32_routes)}")
    check(f32_routes["simt"] > 0 and f32_routes["wgmma"] == 0,
          "the f32 checks must run the CUDA-core SSD route")

    # -- 11. timing at both main-path launch shapes --------------------------
    def ssd_bound(B, H, G, S, P, N, Q, dtype):
        """Each input read once and each output written once (y and the f32
        final state, as prefill asks); the operations the chunked form needs
        for this S: per chunk of q real tokens, C.B^T and W.x over the
        causal q(q+1)/2 pairs, C.state and the state update over q x N x P."""
        elt = dtypes[dtype].itemsize
        nb = (2 * B * H * S * P + B * H * S + 2 * B * G * S * N) * elt + H * 4 + B * H * N * P * 4
        ops = 0
        for c0 in range(0, S, Q):
            q = min(Q, S - c0)
            ops += B * H * (q * (q + 1) * (N + P) + 4 * q * N * P)
        return bound(nb, ops, dtype)

    def simt_ms(fn, reps):
        """``fn``'s time by CUDA events with every launch on the CUDA-core
        route (ssd_scan.cu), for comparison at the tensor-core route's
        own shapes; the port's route rule is restored after."""
        rule = ssd_module.ssd_route
        ssd_module.ssd_route = lambda *a: "simt"
        try:
            return time_events(fn, reps)
        finally:
            ssd_module.ssd_route = rule

    timing = {}
    for cfg in (hybrid_cfg, ssm_cfg):
        args, Q, dt_ = main_args[cfg.arch_id], cfg.ssd_chunk, cfg.dtype

        def run(args=args, Q=Q):
            ssd_scan(*args, chunk=Q, return_final_state=True, backend="cuda")

        B, H, G, S, P, N = launch_shape(cfg)
        route = ssd_route(args[0].dtype, P, N, Q)
        t = {"route": route, "ms": time_events(run, 10), "graph_ms": time_graph(run, 10),
             "simt_ms": simt_ms(run, 5),
             "plain_ms": time_events(lambda: ssd_scan_ref(*args, Q, return_final_state=True), 3,
                                     warmup=1)}
        t["bound_ms"], t["bound_by"] = ssd_bound(B, H, G, S, P, N, Q, dt_)
        timing[cfg.arch_id] = t
        print(f"time ssd_scan main-path launch {cfg.arch_id} B={B} H={H} G={G} S={S} P={P} "
              f"N={N} Q={Q} {dt_} with final state: kernel ({route} route) {t['ms']:.4f} ms "
              f"eager, {t['graph_ms']:.4f} ms device (graph replay); CUDA-core route "
              f"{t['simt_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), device/bound {t['graph_ms'] / t['bound_ms']:.2f}x; library: "
              f"none (no single PyTorch call computes SSD); x {cfg.num_layers} launches per "
              f"prefill = {t['graph_ms'] * cfg.num_layers:.3f} ms")

    attn_timed = hybrid_launch.time(hybrid_cfg.arch_id)
    print(f"{hybrid_cfg.arch_id} attention max_abs_err: flash {attn_err['flash_attention']} "
          f"decode {attn_err['decode_attention']}")
    n = served[hybrid_cfg.arch_id]
    attn_timed["flash_attention"].update(launches=n["flash_attention"],
                                         routes=n["flash_routes"],
                                         max_abs_err=attn_err["flash_attention"])
    attn_timed["decode_attention"].update(launches=n["decode_attention"],
                                          max_abs_err=attn_err["decode_attention"])

    t = timing[hybrid_cfg.arch_id]
    mamba = dict(timing[ssm_cfg.arch_id], launches=served[ssm_cfg.arch_id]["ssd_scan"],
                 routes=served[ssm_cfg.arch_id]["ssd_routes"])
    return {
        "launches": n["ssd_scan"], "routes": n["ssd_routes"],
        "max_abs_err": max(errs.values()), "max_abs_err_by_route": errs,
        "ms": t["ms"], "graph_ms": t["graph_ms"], "simt_ms": t["simt_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, ssm_cfg.arch_id: mamba,
    }, attn_timed


def profile_serving(model, params, prompt_batch, steps=4):
    """Device time of the serving path by kernel, from ``torch.profiler``:
    one prefill, then ``steps`` decode steps, each its own window.  Prints
    each window's host wall time, the device's busy share of it (the union
    of the kernels' intervals), and the kernel time by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import make_serve_step

    B, S = prompt_batch["tokens"].shape
    cache = model.init_cache(B, S + steps + 1, device=prompt_batch["tokens"].device)
    step = make_serve_step(model)
    kinds = (("flash_attention", "flash_attention"),  # both routes' kernels
             ("decode_attention", "decode_attention_kernel"),
             ("ssd_scan", "ssd_scan"),  # both routes' kernels
             ("matrix products (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")),
             ("elementwise, norms, reductions, copies", ""))
    state = {"cache": cache}

    def run_prefill():
        logits, state["cache"] = model.prefill(params, prompt_batch, state["cache"])
        state["tok"] = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

    def run_decode():
        for _ in range(steps):
            state["tok"], state["cache"] = step(params, state["tok"], state["cache"])

    for label, fn in (("prefill", run_prefill), (f"{steps} decode steps", run_decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        busy, end = 0.0, float("-inf")
        for a, b in spans:  # union of the kernels' intervals
            if b > end:
                busy += b - max(a, end)
                end = b
        by_kind = dict.fromkeys((k for k, _ in kinds), 0.0)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            name = e.name.lower()
            for kind, keys in kinds:
                keys = (keys,) if isinstance(keys, str) else keys
                if any(key in name for key in keys):
                    by_kind[kind] += e.time_range.elapsed_us()
                    break
        total = sum(by_kind.values())
        parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / max(total, 1e-9):.1%})"
                          for k, v in by_kind.items())
        print(f"profile serving {label}: wall {wall_us / 1e3:.3f} ms, {len(kernels)} kernels, "
              f"device busy {busy / 1e3:.3f} ms ({busy / wall_us:.1%} of wall): {parts}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"  {us / 1e3:9.3f} ms  {name[:100]}")


def sass_check(lib, label, required=("HGMMA",)):
    """Print the counts of wgmma (``HGMMA``) and TMA (``UTMALDG``,
    ``UTMASTG``) instructions in the library's SASS; fail if one of
    ``required`` is missing.  ``label`` names the library in the messages.
    Skipped, with a line that says so, where the toolkit has no cuobjdump."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or (
        str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else None)
    if not tool or not Path(tool).exists():
        print(f"sass {label} {lib.name}: cuobjdump not found, not checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    found = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    print(f"sass {label} {lib.name}: instruction counts {json.dumps(found)}")
    for op in required:
        check(found[op] > 0, f"the {label} library holds no {op} instruction")


def dense_fleet_window(dev, n_rep, window):
    """The dense fleet benchmark's cluster and config, and the first window
    of its ``n_rep``-replication run (``window`` frames of every
    replication, frame-major: frame 0 of replications 0..n_rep-1 first), as
    ``simulate_fleet`` builds it, on ``dev``."""
    from repro_torch.core import FlatInstance, SimConfig, demo_cluster_spec, get_scenario
    from repro_torch.core.simulator import _build_window, _pad_bucket, _RepFrameSource
    from repro_torch.obs.trace import Stopwatch

    spec = demo_cluster_spec(n_edge=9, n_cloud=1, n_services=5, n_variants=10)
    cfg = SimConfig(
        horizon_ms=30_000.0, arrival_rate_per_s=6.0, delay_req_ms=6000.0,
        acc_req_mean=50.0, acc_req_std=10.0,
    )
    T = int(math.ceil(cfg.horizon_ms / cfg.frame_ms))
    scn = get_scenario("paper-default")
    sources = [
        _RepFrameSource(
            scn, r, spec.n_edge, spec.proc_ms.shape[1], cfg, T, False, False, "vectorized"
        )
        for r in range(n_rep)
    ]
    n_pad = _pad_bucket(max(s.max_bucket for s in sources))
    host, _ = _build_window(sources, spec, cfg, scn, 0, window, n_pad, Stopwatch(), True)
    fields = [f.name for f in dataclasses.fields(FlatInstance)]
    return spec, cfg, FlatInstance(**{f: host[f].to(dev) for f in fields})


#: the sequential testbed's matrix: benchmarks/paper_figures.py::fig_scenarios
#: at its full size (_base_cfg(False, horizon_ms=30_000)), one seed
SEQ_CFG = dict(horizon_ms=30_000.0, arrival_rate_per_s=2.0, delay_req_ms=6000.0,
               acc_req_mean=50.0, acc_req_std=10.0)
#: one point of Fig. 1(e)-(h) (paper_figures.py::fig_num_users): 200 requests
#: submitted over a 120 s horizon on demo_cluster_spec()
FIG1_CFG, FIG1_REQUESTS = dict(SEQ_CFG, horizon_ms=120_000.0), 200


def gus_kernel_args(batch):
    """``gus_assign``'s arguments for a batch of frames."""
    B = batch.A.shape[0]
    return tuple(
        getattr(batch, f.name).expand(B).contiguous() if f.name in ("max_as", "max_cs")
        else getattr(batch, f.name).contiguous()
        for f in dataclasses.fields(batch)
    )


class plain_gus:
    """Inside the block every GUS-cored policy takes GUS's plain version
    (``REPRO_TORCH_GUS_BACKEND=torch``), on whatever device its frames are."""

    def __enter__(self):
        import os

        from repro_torch.core.options import ENV_BACKEND

        self.old = os.environ.get(ENV_BACKEND)
        os.environ[ENV_BACKEND] = "torch"

    def __exit__(self, *exc):
        import os

        from repro_torch.core.options import ENV_BACKEND

        if self.old is None:
            os.environ.pop(ENV_BACKEND, None)
        else:
            os.environ[ENV_BACKEND] = self.old


def policies_smoke(dev, zero_counts, paper, golden, fleet_spec, fleet_cfg, fleet_win,
                   n_rep_scale, window):
    """Phase 5 and the policies' part of phase 11: every GUS-cored policy's
    kernel path against its plain version on the paper batch and the golden
    frames, the sequential testbed's matrix on the card against the CPU
    (its B=1 launches counted), a point of Fig. 1(e)-(h), the dense fleet
    with the keyed and the ordered policy against the CPU and at
    ``n_rep_scale`` replications (counted), then the timings: the ordered
    policy at the paper batch, the scaled entry beside the plain one at the
    fleet window, and one B=1 decision of ``simulate``.  Returns
    ``(mismatch_count, launches_by_path, timings)``."""
    import numpy as np
    import torch

    from repro_torch.core import (
        CongestionConfig,
        EngineOptions,
        Policy,
        SimConfig,
        demo_cluster_spec,
        fleet_policy_carry,
        get_policy,
        get_scenario,
        gus_schedule_ordered,
        list_policies,
        list_scenarios,
        prng,
        simulate,
        simulate_fleet,
    )
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gus import gus_assign, gus_assign_ref
    from repro_torch.kernels.hier import hier_cells
    from repro_torch.kernels.ssd_scan import ssd_scan

    def others_idle(what):
        check(hier_cells.launches == flash_attention.launches == decode_attention.launches
              == ssd_scan.launches == 0, f"{what} launched another kernel")

    # -- 5a. each GUS-cored policy's kernel path vs its plain version --------
    mism_total = 0

    def policy_calls(batch, seed):
        B, N, M, _ = batch.acc.shape
        rng = np.random.default_rng(seed)
        keys = prng.split(prng.PRNGKey(seed), B)
        prio = torch.from_numpy(rng.uniform(0.05, 4.0, (B, N)).astype(np.float32)).to(dev)
        carry = fleet_policy_carry(B, M, device=dev)
        up = torch.ones((B, M), dtype=torch.float32)
        up[:, 1] = 0.0  # server 1 reported down
        carry = dataclasses.replace(
            carry, server_up=up.to(dev),
            ema_util=torch.from_numpy(rng.uniform(0.0, 2.5, (B, M)).astype(np.float32)).to(dev))

        def bind(name):
            return get_policy(name).bind(M - 1, M)

        return {
            "gus-ordered": lambda: bind("gus-ordered")(batch),
            "gus-ordered priority": lambda: gus_schedule_ordered(batch, prio, device=dev),
            "random": lambda: bind("random")(batch, keys),
            "offload_all": lambda: bind("offload_all")(batch),
            "local_all": lambda: bind("local_all")(batch),
            "gus-adaptive": lambda: bind("gus-adaptive")(batch, carry)[0],
        }

    def compare_policies(label, batch, seed=0):
        nonlocal mism_total
        for name, call in policy_calls(batch, seed).items():
            n0 = gus_assign.launches
            a = call()
            launched = gus_assign.launches - n0
            with plain_gus():
                b = call()
            sync(dev)
            mism = int((a.j != b.j).sum()) + int((a.l != b.l).sum())
            mism_total += mism
            served = float((a.j >= 0).float().mean())
            print(f"compare policy {name} on {label}: B={batch.A.shape[0]} N={batch.A.shape[1]} "
                  f"kernel launches={launched} mismatches={mism} served={served:.4f}")
            check(mism == 0, f"policy {name}'s kernel path != its plain version on {label}")
            check(launched == 1, f"policy {name} did not launch the GUS kernel once")

    t0 = time.perf_counter()
    compare_policies("paper batch N=100 M=10 L=10", paper)
    for stem, one in golden:
        compare_policies(stem, one, seed=1)
    print(f"policy comparisons: {time.perf_counter() - t0:.3f} s")

    # -- 5b. the sequential testbed's matrix: card vs CPU, B=1 launches ------
    seq_spec = demo_cluster_spec(n_edge=3, n_cloud=1)
    seq_cfg = SimConfig(**SEQ_CFG)
    dense = [s for s in list_scenarios() if get_scenario(s).dense_sweep]
    runs = [(pol, scn, CongestionConfig()) for scn in dense for pol in list_policies()]
    drain = CongestionConfig(enabled=True, drain=0.5)
    runs += [(pol, scn, drain) for pol in ("gus", "gus-adaptive")
             for scn in ("paper-default", "sustained-overload")]
    per_pol = {}
    cpu_s = 0.0
    zero_counts()
    sync(dev)
    t_seq = time.perf_counter()
    for pol, scn, cong in runs:
        cfg = dataclasses.replace(seq_cfg, congestion=cong)
        n0 = gus_assign.launches
        g = simulate(seq_spec, cfg, policy=pol, scenario=scn, seed=0, device=dev)
        launched = gus_assign.launches - n0
        t0 = time.perf_counter()
        c = simulate(seq_spec, cfg, policy=pol, scenario=scn, seed=0, device="cpu")
        cpu_s += time.perf_counter() - t0
        same = (g.as_dict() == c.as_dict() and g.bandwidth_estimates == c.bandwidth_estimates
                and g.congestion_stats == c.congestion_stats)
        check(same, f"simulate on the card != on the CPU ({pol}, {scn}, congestion "
                    f"{cong.enabled})")
        host = not get_policy(pol).vmappable
        check((launched == 0) if host else (launched > 0),
              f"simulate {pol}: {launched} GUS launches")
        key = pol + (" congested" if cong.enabled else "")
        agg = per_pol.setdefault(key, dict(runs=0, requests=0, launches=0, sched_s=0.0,
                                           build_s=0.0, realize_s=0.0, total_s=0.0, sat=[]))
        agg["runs"] += 1
        agg["requests"] += g.n_requests
        agg["launches"] += launched
        for k in ("sched_s", "build_s", "realize_s", "total_s"):
            agg[k] += g.timings[k]
        agg["sat"].append(g.satisfied_pct)
    seq_wall = time.perf_counter() - t_seq - cpu_s
    seq_launches = gus_assign.launches
    others_idle("the sequential main path")
    for key, a in per_pol.items():
        per = f"{a['sched_s'] / a['launches'] * 1e3:.4f} ms" if a["launches"] else "host"
        print(f"simulate {key}: {a['runs']} runs equal to the CPU; "
              f"requests={a['requests']} B=1 launches={a['launches']} sched_s "
              f"{a['sched_s']:.4f} ({per} per decision) build_s {a['build_s']:.4f} "
              f"realize_s {a['realize_s']:.4f} total_s {a['total_s']:.4f} mean satisfied "
              f"{np.mean(a['sat']):.3f}%")
    print(f"sequential main path: {len(runs)} simulate runs on the card in {seq_wall:.3f} s "
          f"(the CPU's {cpu_s:.3f} s aside), gus_assign launches={seq_launches} (B=1)")
    check(seq_launches > 0, "the sequential main path never launched the GUS kernel")
    gus_seq = per_pol["gus"]

    # -- 5c. one point of Fig. 1(e)-(h): every batched policy, timed --------
    fig_spec = demo_cluster_spec()
    fig_cfg = SimConfig(**FIG1_CFG)
    for pol in [p for p in list_policies() if get_policy(p).vmappable]:
        n0 = gus_assign.launches
        t0 = time.perf_counter()
        g = simulate(fig_spec, fig_cfg, policy=pol, seed=0, n_requests=FIG1_REQUESTS, device=dev)
        wall = time.perf_counter() - t0
        c = simulate(fig_spec, fig_cfg, policy=pol, seed=0, n_requests=FIG1_REQUESTS,
                     device="cpu")
        check(g.as_dict() == c.as_dict(), f"Fig. 1 point {pol}: card != CPU")
        print(f"fig1 num-users n={FIG1_REQUESTS} {pol}: satisfied {g.satisfied_pct:.3f}% "
              f"mean_us {g.mean_us:.5f} wall {wall:.4f} s ({gus_assign.launches - n0} launches) "
              "timings " + json.dumps({k: round(v, 4) for k, v in g.timings.items()}))

    # -- 5d. the dense fleet with the keyed and the ordered policy -----------
    launches_by_path = {"sequential simulate (B=1)": seq_launches}
    for pol in ("random", "gus-ordered"):
        def run(n_rep, device, **opt):
            return simulate_fleet(fleet_spec, fleet_cfg, policy=pol, scenario="paper-default",
                                  n_rep=n_rep, seed=0, device=device,
                                  options=EngineOptions(rng_mode="vectorized", **opt))

        g, c = run(64, dev), run(64, "cpu")
        same = (g.n_requests == c.n_requests and g.n_served == c.n_served
                and np.array_equal(g.satisfied_per_rep, c.satisfied_per_rep))
        us_err = float(np.abs(g.mean_us_per_rep - c.mean_us_per_rep).max())
        print(f"fleet {pol} n_rep=64: requests={g.n_requests} served={g.n_served} "
              f"integer_fields_equal={same} mean_us_max_abs_diff={us_err}")
        check(same and np.allclose(g.mean_us_per_rep, c.mean_us_per_rep, rtol=US_RTOL,
                                   atol=US_ATOL), f"fleet {pol} on the card != the CPU")
        zero_counts()
        sync(dev)
        t0 = time.perf_counter()
        fr = run(n_rep_scale, dev, window=window)
        wall = time.perf_counter() - t0
        n = gus_assign.launches
        others_idle(f"the {pol} fleet")
        check(n > 0 and 0 < fr.n_served <= fr.n_requests
              and np.isfinite(fr.mean_us_per_rep).all(), f"fleet {pol} scale run malformed")
        check(np.array_equal(fr.satisfied_per_rep[:64], g.satisfied_per_rep),
              f"fleet {pol}: the scale run's first 64 replications disagree")
        launches_by_path[f"dense fleet {pol} ({n_rep_scale} reps)"] = n
        print(f"fleet {pol} n_rep={fr.n_rep} window={fr.window}: wall {wall:.3f} s dispatch_s "
              f"{fr.dispatch_s:.3f} gen_s {fr.gen_s:.3f} requests={fr.n_requests} "
              f"requests/s {fr.n_requests / wall:.1f} satisfied={fr.satisfied_pct:.4f}% "
              f"gus_assign launches={n}")

    # -- 11 (policies). timings ---------------------------------------------
    timings = {}
    ordered = get_policy("gus-ordered").bind(9, 10)
    timings["gus_ordered_paper_ms"] = time_events(lambda: ordered(paper), 5)
    with plain_gus():
        timings["gus_ordered_paper_plain_ms"] = time_events(lambda: ordered(paper), 1, warmup=1)
    print(f"time gus-ordered policy at the paper batch B=20000 N=100 (sort, permute, kernel, "
          f"scatter): {timings['gus_ordered_paper_ms']:.4f} ms, plain "
          f"{timings['gus_ordered_paper_plain_ms']:.4f} ms")

    args = gus_kernel_args(fleet_win)
    B, N = fleet_win.A.shape
    prio = torch.from_numpy(
        np.random.default_rng(0).uniform(0.5, 2.0, (B, N)).astype(np.float32)).to(dev)
    got, want = gus_assign(*args, prio), gus_assign_ref(*args, prio)
    sync(dev)
    mism = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    mism_total += mism
    check(mism == 0, "the scaled entry != its plain version at the fleet window")
    calls = {"plain entry": lambda: gus_assign(*args), "scaled entry": lambda: gus_assign(*args, prio)}
    t = {"plain entry": [], "scaled entry": []}
    for name in ("plain entry", "scaled entry", "scaled entry", "plain entry"):
        t[name].append(time_events(calls[name], 10))
    timings["window_plain_entry_ms"] = t["plain entry"]
    timings["window_scaled_entry_ms"] = t["scaled entry"]
    print(f"time gus_assign at the fleet window B={B} N={N} M=10 L=10, in turns: plain entry "
          f"{t['plain entry'][0]:.4f} / {t['plain entry'][1]:.4f} ms, scaled entry "
          f"{t['scaled entry'][0]:.4f} / {t['scaled entry'][1]:.4f} ms (scaled == plain "
          f"version: 0 mismatches)")

    # one B=1 decision of simulate, as the main path hands it over
    frames = []
    gus = get_policy("gus")
    capture = Policy(name="gus-capture", description="gus, keeping its frames", kind="greedy",
                     make=lambda n_edge, n_servers: lambda b: (frames.append(b),
                                                                gus.bind(n_edge, n_servers)(b))[1])
    simulate(seq_spec, seq_cfg, policy=capture, scenario="paper-default", seed=0, device=dev)
    one = max(frames, key=lambda b: b.A.shape[1])
    args1 = gus_kernel_args(one)
    timings["b1_eager_ms"] = time_events(lambda: gus_assign(*args1), 200)
    timings["b1_device_ms"] = time_graph(lambda: gus_assign(*args1), 50)
    t0 = time.perf_counter()
    for _ in range(200):
        j, _, _, _ = gus_assign(*args1)
        j.cpu()
    timings["b1_host_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    timings["b1_sched_ms_per_decision"] = gus_seq["sched_s"] / max(gus_seq["launches"], 1) * 1e3
    print(f"time gus_assign one simulate decision (B=1 N={one.A.shape[1]} M={one.acc.shape[2]} "
          f"L={one.acc.shape[3]}): {timings['b1_device_ms']:.4f} ms device (CUDA-graph replay), "
          f"{timings['b1_eager_ms']:.4f} ms eager, {timings['b1_host_ms']:.4f} ms with the "
          f"wrapper's host time and the copy back; simulate's sched_s per decision "
          f"{timings['b1_sched_ms_per_decision']:.4f} ms (padding, H2D, launch, D2H)")
    return mism_total, launches_by_path, timings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.core import (
        CongestionConfig,
        EngineOptions,
        FlatInstance,
        GeneratorConfig,
        SimConfig,
        demo_cluster_spec,
        generate_batch,
        get_scenario,
        gus_schedule_batch,
        simulate_fleet,
    )
    from repro_torch.core.aggregation import QuantizationConfig, class_batch
    from repro_torch.core.simulator import _build_hier_window, _hier_device_inputs, _RepFrameSource
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gus import gus_assign, gus_assign_ref
    from repro_torch.kernels.hier import hier_cells, hier_cells_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.obs.trace import Stopwatch

    dev = torch.device("cuda")
    fields = [f.name for f in dataclasses.fields(FlatInstance)]
    # f32 comparisons on the card are full f32: no TF32 in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def zero_counts():
        gus_assign.launches = hier_cells.launches = 0
        flash_attention.launches = decode_attention.launches = ssd_scan.launches = 0
        flash_attention.route_launches = dict.fromkeys(flash_attention.route_launches, 0)
        ssd_scan.route_launches = dict.fromkeys(ssd_scan.route_launches, 0)
    t_start = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    builds = build_libraries(["gus_assign", "hier_cells", "flash_attention",
                              "flash_attention_wgmma", "decode_attention", "ssd_scan",
                              "ssd_scan_wgmma"])
    for info in builds.values():
        print(f"build {info.name}: nvcc {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    sass_check(builds["flash_attention_wgmma"].path, "tensor-core flash", ("HGMMA", "UTMALDG"))
    sass_check(builds["ssd_scan_wgmma"].path, "tensor-core SSD", ("HGMMA", "UTMALDG"))

    # -- 2. kernel vs plain version on the card -----------------------------
    max_err = 0.0

    def compare(label, batch, **relax):
        nonlocal max_err
        a = gus_schedule_batch(batch, backend="cuda", device=dev, **relax)
        b = gus_schedule_batch(batch, backend="torch", device=dev, **relax)
        torch.cuda.synchronize()
        mism = int((a.j != b.j).sum()) + int((a.l != b.l).sum())
        err = max(
            float((a.j - b.j).abs().max()) if a.j.numel() else 0.0,
            float((a.l - b.l).abs().max()) if a.l.numel() else 0.0,
            float((a.loads[0] - b.loads[0]).abs().max()),
            float((a.loads[1] - b.loads[1]).abs().max()),
        )
        max_err = max(max_err, err)
        served = float((a.j >= 0).float().mean()) if a.j.numel() else 0.0
        print(
            f"compare {label}: B={batch.A.shape[0]} N={batch.A.shape[-1]} "
            f"mismatches={mism} max_abs_err={err} served={served:.4f}"
        )
        check(mism == 0 and err == 0.0, f"kernel != plain version on {label}")
        return a

    def batch_of_one(d):
        one = FlatInstance.from_numpy(d, dev)
        return FlatInstance(**{f: getattr(one, f)[None] for f in fields})

    golden = []
    for path in sorted((ROOT / "tests" / "fixtures").glob("gus_golden_*.npz")):
        d = np.load(path)
        golden.append((path.stem, batch_of_one(d)))
        a = compare(path.stem, golden[-1][1])
        check(
            np.array_equal(a.j[0].cpu().numpy(), d["exp_j"])
            and np.array_equal(a.l[0].cpu().numpy(), d["exp_l"]),
            f"kernel != golden assignment on {path.stem}",
        )

    t0 = time.perf_counter()
    paper = generate_batch(0, 20000, device=dev)
    print(f"paper batch generate_batch(0, 20000): {time.perf_counter() - t0:.3f} s host")
    compare("paper N=100 M=10 L=10", paper)
    compare("paper relax_compute", paper, relax_compute=True)
    compare("paper relax_comm", paper, relax_comm=True)

    # degenerate frames: empty, all-infeasible, exact-capacity fit, ties
    def first(batch, n_frames, n_rows=None):
        """The first frames of a batch, optionally cut to the first rows."""
        out = {}
        for f in fields:
            x = getattr(batch, f)[:n_frames]
            if n_rows is not None and f not in ("gamma", "eta", "max_as", "max_cs"):
                x = x[:, :n_rows]
            out[f] = x
        return FlatInstance(**out)

    n0 = gus_assign.launches
    a = compare("empty N=0", first(paper, 4, 0))
    check(tuple(a.j.shape) == (4, 0) and gus_assign.launches == n0, "N=0 must not launch")
    infeasible = first(paper, 64)
    a = compare(
        "all-infeasible",
        dataclasses.replace(infeasible, avail=torch.zeros_like(infeasible.avail)),
    )
    check(bool((a.j == -1).all()), "an all-infeasible frame must drop every request")
    N, M, L = 3, 2, 1
    fit = dict(
        cover=np.zeros(N, np.int32), A=np.full(N, 10.0), C=np.full(N, 1000.0),
        w_a=np.ones(N), w_c=np.ones(N), acc=np.full((N, M, L), 80.0),
        ctime=np.broadcast_to(np.array([100.0, 200.0])[None, :, None], (N, M, L)),
        v=np.ones((N, M, L)), u=np.zeros((N, M, L)), avail=np.ones((N, M, L), bool),
        gamma=np.array([2.0, 0.0]), eta=np.zeros(M), max_as=100.0, max_cs=1000.0,
    )
    a = compare("exact-capacity fit", batch_of_one(fit))
    check(a.j[0].tolist() == [0, 0, -1], "exact-capacity fit must serve exactly two")
    N, M, L = 6, 3, 2
    ties = dict(
        cover=np.zeros(N, np.int32), A=np.full(N, 10.0), C=np.full(N, 1000.0),
        w_a=np.ones(N), w_c=np.ones(N), acc=np.full((N, M, L), 50.0),
        ctime=np.full((N, M, L), 100.0), v=np.ones((N, M, L)), u=np.ones((N, M, L)),
        avail=np.ones((N, M, L), bool), gamma=np.full(M, 100.0), eta=np.full(M, 100.0),
        max_as=100.0, max_cs=1000.0,
    )
    a = compare("duplicate-utility ties", batch_of_one(ties))
    check(bool((a.j == 0).all() and (a.l == 0).all()), "ties must pick the lowest flat index")

    # the fleet's own frames: the first window of the 1024-replication run
    n_rep_scale, window = 1024, 5
    t0 = time.perf_counter()
    spec, cfg, fleet_win = dense_fleet_window(dev, n_rep_scale, window)
    print(f"fleet window built: {time.perf_counter() - t0:.3f} s host, "
          f"n_pad={fleet_win.A.shape[1]}")
    compare("fleet window (1024 reps x 5 frames)", fleet_win)
    fleet_step = FlatInstance(**{f: getattr(fleet_win, f)[:n_rep_scale] for f in fields})
    # the sequential simulator's shape: one frame (replication 0's first)
    fleet_first = FlatInstance(**{f: getattr(fleet_win, f)[:1] for f in fields})
    compare("fleet first frame (B=1)", fleet_first)
    # every budget spent: the chain's shortest steps
    fleet_spent = dataclasses.replace(fleet_win, gamma=torch.zeros_like(fleet_win.gamma),
                                      eta=torch.zeros_like(fleet_win.eta))
    a = compare("fleet window, every budget spent", fleet_spent)
    check(bool((a.j == -1).all()), "a frame with every budget spent must drop every request")

    # -- 3. the fleet main path ---------------------------------------------
    def fleet(n_rep, device, congestion=CongestionConfig(), **opt):
        return simulate_fleet(
            spec, dataclasses.replace(cfg, congestion=congestion), policy="gus",
            scenario="paper-default", n_rep=n_rep, seed=0,
            options=EngineOptions(rng_mode="vectorized", **opt), device=device,
        )

    # GUS honours the budgets it is given, so with the default drain of 1.0
    # its backlog stays at zero and the carry is inert; drain=0.5 carries
    # half of each frame's work over and feeds the backlog back into the
    # next frame's budgets — the path where a 1-ulp load sum would show
    parity = {}
    for label, congestion in (
        ("off", CongestionConfig()),
        ("on", CongestionConfig(enabled=True)),
        ("on drain=0.5", CongestionConfig(enabled=True, drain=0.5)),
    ):
        n0 = gus_assign.launches
        t0 = time.perf_counter()
        g = fleet(64, "cuda", congestion)
        t_gpu = time.perf_counter() - t0
        launched = gus_assign.launches - n0
        t0 = time.perf_counter()
        c = fleet(64, "cpu", congestion)
        t_cpu = time.perf_counter() - t0
        us_err = float(np.abs(g.mean_us_per_rep - c.mean_us_per_rep).max())
        same = (
            g.n_requests == c.n_requests and g.n_served == c.n_served
            and np.array_equal(g.satisfied_per_rep, c.satisfied_per_rep)
            and g.mean_compute_inflation == c.mean_compute_inflation
            and (not congestion.enabled
                 or np.array_equal(g.final_backlog_per_rep, c.final_backlog_per_rep))
        )
        backlog = None if g.final_backlog_per_rep is None else float(g.final_backlog_per_rep.sum())
        print(
            f"fleet parity n_rep=64 congestion {label}: cuda {t_gpu:.3f} s "
            f"({launched} launches) vs cpu {t_cpu:.3f} s; requests={g.n_requests} "
            f"served={g.n_served} satisfied={g.satisfied_pct:.4f}% "
            f"inflation={g.mean_compute_inflation} final_backlog_sum={backlog} "
            f"integer_fields_equal={same} mean_us_max_abs_diff={us_err}"
        )
        check(same, f"fleet on the card != fleet on the CPU (congestion {label})")
        check(launched > 0, "the card's fleet did not launch the GUS kernel")
        check(
            np.allclose(g.mean_us_per_rep, c.mean_us_per_rep, rtol=US_RTOL, atol=US_ATOL),
            "mean_us_per_rep out of tolerance",
        )
        parity[label] = g
    check(
        parity["on drain=0.5"].final_backlog_per_rep.sum() > 0,
        "the draining congested run never built a backlog",
    )

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr = fleet(n_rep_scale, "cuda", window=window)
    wall = time.perf_counter() - t0
    launches = gus_assign.launches
    check(hier_cells.launches == flash_attention.launches == decode_attention.launches
          == ssd_scan.launches == 0, "the dense main path launched another kernel")
    print(
        f"fleet scale n_rep={fr.n_rep} frames={fr.n_frames} window={fr.window} "
        f"prefetch={fr.prefetch}: wall {wall:.3f} s dispatch_s {fr.dispatch_s:.3f} "
        f"gen_s {fr.gen_s:.3f} requests={fr.n_requests} "
        f"requests/s {fr.n_requests / wall:.1f} satisfied={fr.satisfied_pct:.4f}% "
        f"gus_assign launches={launches} device={fr.device}"
    )
    print("fleet scale timings " + json.dumps({k: round(v, 4) for k, v in fr.timings.items()}))
    check(launches > 0, "the main path never launched the GUS kernel")
    check(
        fr.satisfied_per_rep.shape == (n_rep_scale,) and fr.mean_us_per_rep.shape == (n_rep_scale,)
        and np.isfinite(fr.satisfied_per_rep).all() and np.isfinite(fr.mean_us_per_rep).all()
        and 0 < fr.n_served <= fr.n_requests,
        "scale run results malformed",
    )
    # replication r draws from seed + r whatever n_rep and window are, and
    # padding never changes an assignment: its first 64 replications
    # satisfy exactly the parity run's requests
    check(
        np.array_equal(fr.satisfied_per_rep[:64], parity["off"].satisfied_per_rep),
        "the scale run's first 64 replications disagree with the parity run",
    )

    # -- 4. the hierarchical path: class allocator vs plain, fleet parity,
    #       the counted main path ------------------------------------------
    hier_err = 0.0

    def compare_hier(label, args):
        """Kernel == plain version on one batch of class grids (cells and
        fixed-order loads)."""
        nonlocal hier_err
        got = hier_cells(*args, backend="cuda", loads=True)
        want = hier_cells_ref(*args, loads=True)
        torch.cuda.synchronize()
        mism = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        err = max(
            float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0,
            float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0,
            float((got[2] - want[2]).abs().max()) if got[2].numel() else 0.0,
            float((got[3] - want[3]).abs().max()) if got[3].numel() else 0.0,
        )
        hier_err = max(hier_err, err)
        B, C = args[0].shape[:2]
        print(
            f"compare hier_cells {label}: B={B} C={C} classes={int((args[5] > 0).sum())} "
            f"members={int(args[5].sum())} placed={int(got[0].sum())} "
            f"mismatches={mism} max_abs_err={err}"
        )
        check(mism == 0 and err == 0.0, f"class-allocator kernel != plain version on {label}")
        return got

    def frames_of(batch):
        return [FlatInstance(**{f: getattr(batch, f)[i] for f in fields})
                for i in range(batch.A.shape[0])]

    t0 = time.perf_counter()
    for seed in (0, 1, 2):
        frames = frames_of(generate_batch(seed, 64, device="cpu"))
        for pad_to in (None, 256, 4352):
            compare_hier(f"generated seed={seed} pad_to={pad_to}",
                         class_batch(frames, pad_to=pad_to, device=dev))
    dup_cfg = GeneratorConfig(n_requests=24, n_services=6)
    dups = []
    for f in frames_of(generate_batch(3, 16, dup_cfg, device="cpu")):
        dups.append(dataclasses.replace(f, **{
            k: getattr(f, k).repeat_interleave(5, 0)
            for k in ("cover", "A", "C", "w_a", "w_c", "acc", "ctime", "v", "u", "avail")
        }))
    compare_hier("duplicate classes (rows x5)", class_batch(dups, device=dev))

    def degenerate(us, feas, v, u, cover, count, gamma, eta):
        f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)[None]  # noqa: E731
        i32 = lambda x: torch.tensor(np.asarray(x, np.int32), device=dev)[None]  # noqa: E731
        return (f32(us), torch.tensor(np.asarray(feas, bool), device=dev)[None], f32(v),
                f32(u), i32(cover), i32(count), f32(gamma), f32(eta))

    got = compare_hier("ties", degenerate(
        np.ones((3, 4, 2)), np.ones((3, 4, 2), bool), np.ones((3, 4, 2)), np.ones((3, 4, 2)),
        np.zeros(3), np.full(3, 2), np.full(4, 1e6), np.full(4, 1e6),
    ))
    check(bool((got[0][0, :, 0, 0] == 2).all()) and int(got[0].sum()) == 6,
          "ties must pick the lowest flat cell")
    feas_ = np.ones((4, 3, 2), bool)
    feas_[1] = False
    got = compare_hier("all-infeasible and zero-count rows", degenerate(
        np.random.default_rng(0).uniform(0, 1, (4, 3, 2)), feas_, np.ones((4, 3, 2)),
        np.ones((4, 3, 2)), np.zeros(4), [3, 3, 0, 3], np.full(3, 1e6), np.full(3, 1e6),
    ))
    check(int(got[0][0, 1].sum()) == 0 and int(got[0][0, 2].sum()) == 0,
          "an infeasible or zero-count class must place nobody")
    one_cell = np.array([[[1.0], [0.5]]])
    got = compare_hier("exact capacity (gamma)", degenerate(
        one_cell, [[[True], [False]]], np.ones((1, 2, 1)), np.zeros((1, 2, 1)),
        [0], [3], [2.0, 0.0], [1e6, 1e6],
    ))
    check(int(got[0][0, 0, 0, 0]) == 2 and int(got[0].sum()) == 2, "gamma must fit exactly two")
    got = compare_hier("exact capacity (eta)", degenerate(
        one_cell, [[[False], [True]]], np.ones((1, 2, 1)), np.ones((1, 2, 1)),
        [0], [3], [1e6, 1e6], [2.5, 1e6],
    ))
    check(int(got[0][0, 0, 1, 0]) == 2 and int(got[0].sum()) == 2, "eta must fit floor(2.5)")
    got = compare_hier("budget carry", degenerate(
        np.tile(np.array([[[1.0], [0.4]]]), (2, 1, 1)),
        np.ones((2, 2, 1), bool), np.ones((2, 2, 1)), np.zeros((2, 2, 1)),
        [0, 0], [3, 2], [3.0, 1e6], [1e6, 1e6],
    ))
    check(int(got[0][0, 1, 1, 0]) == 2, "the budget must carry across classes")
    print(f"hier_cells class-grid comparisons: {time.perf_counter() - t0:.3f} s")

    # the hierarchical main path's own frames: its first window, built as
    # the fleet builds it (8 replications x 1 frame, streamed arrivals)
    city = demo_cluster_spec(n_edge=20, n_cloud=1, n_services=5, n_variants=10)
    city_cfg = SimConfig(horizon_ms=9000.0)
    mega = get_scenario("mega-city")
    n_rep_city, T_city = 8, int(math.ceil(city_cfg.horizon_ms / city_cfg.frame_ms))
    t0 = time.perf_counter()
    city_sources = [
        _RepFrameSource(mega, r, city.n_edge, city.proc_ms.shape[1], city_cfg, T_city,
                        True, True, "vectorized")
        for r in range(n_rep_city)
    ]
    _, _, host, _, n_arr = _build_hier_window(
        city_sources, city, city_cfg, mega, 0, 1, QuantizationConfig(), Stopwatch(), True
    )
    city_inst, city_us, city_feas, city_count = _hier_device_inputs(host, dev)
    win_args = (city_us, city_feas, city_inst.v, city_inst.u, city_inst.cover, city_count,
                city_inst.gamma, city_inst.eta)
    print(f"hier window built: {time.perf_counter() - t0:.3f} s host, "
          f"users/frame={int(n_arr.sum()) / n_rep_city:.0f}, Cp={city_count.shape[1]}")
    compare_hier(f"hier main-path window ({n_rep_city} reps x 1 frame, full width)", win_args)

    def city_fleet(n_rep, device, scenario=mega, congestion=CongestionConfig()):
        return simulate_fleet(
            city, dataclasses.replace(city_cfg, congestion=congestion), scenario=scenario,
            n_rep=n_rep, seed=0, device=device,
            options=EngineOptions(scheduler="hierarchical", window=1, prefetch=2),
        )

    # ~10^3 users per frame; the half drain makes the backlog feed back
    small_city = dataclasses.replace(
        mega, rate_per_edge_per_s=1000.0 / (city.n_edge * city_cfg.frame_ms / 1000.0)
    )
    for label, congestion in (
        ("off", CongestionConfig()),
        ("on drain=0.5", CongestionConfig(enabled=True, drain=0.5)),
    ):
        n0 = hier_cells.launches
        t0 = time.perf_counter()
        g = city_fleet(4, "cuda", small_city, congestion)
        t_gpu = time.perf_counter() - t0
        launched = hier_cells.launches - n0
        t0 = time.perf_counter()
        c = city_fleet(4, "cpu", small_city, congestion)
        t_cpu = time.perf_counter() - t0
        same = (
            g.n_requests == c.n_requests and g.n_served == c.n_served
            and np.array_equal(g.satisfied_per_rep, c.satisfied_per_rep)
            and np.array_equal(g.mean_us_per_rep, c.mean_us_per_rep)
            and g.mean_compute_inflation == c.mean_compute_inflation
            and (not congestion.enabled
                 or np.array_equal(g.final_backlog_per_rep, c.final_backlog_per_rep))
        )
        backlog = None if g.final_backlog_per_rep is None else float(g.final_backlog_per_rep.sum())
        print(
            f"hier fleet parity n_rep=4 congestion {label}: cuda {t_gpu:.3f} s "
            f"({launched} launches) vs cpu {t_cpu:.3f} s; requests={g.n_requests} "
            f"served={g.n_served} satisfied={g.satisfied_pct:.4f}% "
            f"inflation={g.mean_compute_inflation} final_backlog_sum={backlog} "
            f"all_fields_equal={same}"
        )
        check(same, f"hier fleet on the card != hier fleet on the CPU (congestion {label})")
        check(launched > 0, "the card's hier fleet did not launch the class allocator")
        if congestion.enabled:
            check(g.final_backlog_per_rep.sum() > 0, "the draining hier run built no backlog")

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fh = city_fleet(n_rep_city, "cuda")
    hier_wall = time.perf_counter() - t0
    hier_launches = hier_cells.launches
    check(gus_assign.launches == flash_attention.launches == decode_attention.launches
          == ssd_scan.launches == 0, "the hierarchical main path launched another kernel")
    print(
        f"hier main path mega-city n_rep={fh.n_rep} frames={fh.n_frames} window={fh.window} "
        f"prefetch={fh.prefetch}: wall {hier_wall:.3f} s dispatch_s {fh.dispatch_s:.3f} "
        f"gen_s {fh.gen_s:.3f} requests={fh.n_requests} "
        f"users/frame={fh.n_requests / (fh.n_rep * fh.n_frames):.0f} "
        f"requests/s {fh.n_requests / hier_wall:.1f} served={fh.n_served} "
        f"satisfied={fh.satisfied_pct:.4f}% hier_cells launches={hier_launches} "
        f"device={fh.device}"
    )
    print("hier main path timings " + json.dumps({k: round(v, 4) for k, v in fh.timings.items()}))
    check(hier_launches == fh.n_frames, "the hier main path must launch once per window")
    check(
        fh.satisfied_per_rep.shape == (n_rep_city,)
        and np.isfinite(fh.satisfied_per_rep).all() and np.isfinite(fh.mean_us_per_rep).all()
        and 0 < fh.n_served <= fh.n_requests and fh.n_requests > 1e5 * n_rep_city * fh.n_frames,
        "hier main path results malformed",
    )
    check(int(n_arr.sum()) < fh.n_requests, "the compared window is not the main path's")

    # -- 5. every policy on the GUS kernel, the sequential testbed (B=1
    #       launches), the keyed and ordered dense fleets; their timings ----
    pol_mism, pol_launches, pol_times = policies_smoke(
        dev, zero_counts, paper, golden, spec, cfg, fleet_win, n_rep_scale, window)

    # -- 6.-7. attention kernels, the small model, the serving main path,
    #         attention timing ---------------------------------------------
    attn = serving_smoke(dev, zero_counts, get_config(SERVE_ARCH))

    # -- 8.-10. the SSD kernel, the ssm and hybrid models, their main paths,
    #          SSD timing ---------------------------------------------------
    ssd, hybrid_attn = ssm_smoke(dev, zero_counts, get_config(SSM_HYBRID_ARCH),
                                 get_config(SSM_ARCH))
    for name in ("flash_attention", "decode_attention"):
        attn[name][SSM_HYBRID_ARCH] = hybrid_attn[name]  # the same kernel on the hybrid's path

    # -- 11. kernel timing (the scheduler kernels) ---------------------------
    def time_kernel(args, reps):
        for _ in range(2):
            gus_assign(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            gus_assign(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def time_plain(args, reps=2):
        gus_assign_ref(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            gus_assign_ref(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def bound(batch):
        B, N, M, L = batch.acc.shape
        # each input read once (candidates 4 x f32 + avail u8, request rows
        # 5 x 4 B, budgets 2 x 4 B, normalizers 2 x 4 B), each output
        # written once (j, l: 2 x 4 B per request; loads 2 x 4 B per server)
        nbytes = B * (N * M * L * 17 + N * 20 + M * 8 + 8 + N * 8 + M * 8)
        ops = B * N * M * L * GUS_OPS_PER_CANDIDATE
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    timing = {}
    for label, batch in (
        ("fleet first frame B=1 N=256 M=10 L=10", fleet_first),
        ("fleet frame step B=1024 N=256 M=10 L=10", fleet_step),
        ("paper batch B=20000 N=100 M=10 L=10", paper),
        ("fleet window launch B=5120 N=256 M=10 L=10", fleet_win),
        ("chain floor: fleet window, every budget spent", fleet_spent),
    ):
        args = gus_kernel_args(batch)
        ms = time_kernel(args, 10)
        plain_ms = time_plain(args)
        b_ms, b_by = bound(batch)
        timing[label] = (ms, plain_ms, b_ms, b_by)
        print(
            f"time gus_assign {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), kernel/bound {ms / b_ms:.2f}x; "
            "library: none (no single PyTorch call computes GUS)"
        )

    main_ms, main_plain, main_bound, main_by = timing["fleet window launch B=5120 N=256 M=10 L=10"]
    gus_floor_ms = timing["chain floor: fleet window, every budget spent"][0]
    # one frame is short enough for the wrapper's host time to show in eager
    # timing: its device time too, by one replay of a captured CUDA graph
    first_args = gus_kernel_args(fleet_first)
    first_dev_ms = time_graph(lambda: gus_assign(*first_args), 50)
    print(f"time gus_assign fleet first frame B=1: {first_dev_ms:.4f} ms device "
          f"(CUDA-graph replay), {timing['fleet first frame B=1 N=256 M=10 L=10'][0]:.4f} ms eager")

    def time_hier(fn, args, reps):
        """Mean ms of ``fn(*args)`` after one warm-up call, both versions
        called as the main path calls the allocator (no loads)."""
        fn(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def hier_bound(args):
        us, _, _, _, _, count, _, _ = args
        B, C, M, L = us.shape
        real = int((count > 0).sum())
        # each input the function needs read once: the cells of the real
        # classes (us, v, u f32 + feas u8; padding rows are never read),
        # every row's cover and count, the budgets; each output written
        # once: take and start (int32) over the whole grid
        nbytes = real * M * L * 13 + B * C * 8 + B * M * 8 + B * C * M * L * 8
        ops = real * M * L * HIER_OPS_PER_CELL  # at least one chunk step per class
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    hier_ms = time_hier(lambda *a: hier_cells(*a, backend="cuda"), win_args, 5)
    hier_plain_ms = time_hier(hier_cells_ref, win_args, 2)
    hb_ms, hb_by = hier_bound(win_args)
    # the chain's floor: the same window with every budget spent, so each
    # class takes the shortest step (its summary test fails at once)
    spent = win_args[:6] + (torch.zeros_like(city_inst.gamma), torch.zeros_like(city_inst.eta))
    floor_ms = time_hier(lambda *a: hier_cells(*a, backend="cuda"), spent, 5)
    n_classes = city_us.shape[1]
    print(f"hier_cells chain floor: {floor_ms:.4f} ms for {n_classes} classes per frame with "
          f"every budget spent ({floor_ms / n_classes * 1e3:.4f} us per class)")
    print(
        f"time hier_cells main-path launch B={city_us.shape[0]} C={city_us.shape[1]} "
        f"M={city_us.shape[2]} L={city_us.shape[3]}: kernel {hier_ms:.4f} ms, plain "
        f"{hier_plain_ms:.4f} ms, bound {hb_ms:.4f} ms ({hb_by}), kernel/bound "
        f"{hier_ms / hb_ms:.2f}x; library: none (no single PyTorch call computes the allocator)"
    )
    kernels = {"kernels": [{
        "name": "gus_assign",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gus_assign.cu",
        "replaces": "src/repro/kernels/gus_pallas.py:155",
        "launches": launches,
        "max_abs_err": max_err,
        "policy_mismatches": pol_mism,
        "ms": main_ms,
        "plain_ms": main_plain,
        "bound_ms": main_bound,
        "bound_by": main_by,
        "library_ms": None,
        "chain_floor_ms": gus_floor_ms,
        "single_frame_ms": first_dev_ms,
        "launches_by_path": {f"dense fleet gus ({n_rep_scale} reps)": launches, **pol_launches},
        **pol_times,
    }, {
        "name": "hier_cells",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hier_cells.cu",
        "replaces": "src/repro/kernels/hier_pallas.py:178",
        "launches": hier_launches,
        "max_abs_err": hier_err,
        "ms": hier_ms,
        "plain_ms": hier_plain_ms,
        "bound_ms": hb_ms,
        "bound_by": hb_by,
        "library_ms": None,
        "chain_floor_ms": floor_ms,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        # the main path's route; f32 and other head dims take flash_attention.cu
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:118",
        **attn["flash_attention"],
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:91",
        **attn["decode_attention"],
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        # the main path's route; f32 and other shapes take ssd_scan.cu
        "source": "src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:84",
        **ssd,
    }]}
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
