#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and ``nvcc``:

    python3 chip_smoke.py

It drives the port (``src/repro_torch``) end to end and exits non-zero if
any phase fails:

1. builds every kernel of the main paths from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, all started together) and prints
   the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card — the
   GUS kernel's integer assignments must be equal (0 mismatches) on the
   golden frames, the paper's 20 000-instance numerical batch (plain and
   both Happy-* relaxations), degenerate frames and the dense fleet's own
   frames; the class allocator's ``take``/``start`` cells and fixed-order
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
5. holds the attention kernels against their plain versions on the card
   (ragged lengths, GQA rep 1/4/8, window None and 8, head_dim 64 and 128,
   f32 and bf16, decode masks partly and wholly invalid, and both kernels'
   serving-path launch shapes), then a small dense model (f32, GQA rep 4,
   a 16-token window whose ring wraps) on the card against the same
   weights on the CPU: prefill logits and 8 greedy tokens;
6. serves yi-9b at full width and depth (48 layers, bf16, seeded random
   weights on the card): ``ServingEngine.generate`` on batch 8 x a
   1024-token prompt from ``make_batch(seed=0)``, 32 greedy tokens — the
   serving main path, whose 48 ``flash_attention`` and 31 x 48
   ``decode_attention`` launches are counted; greedy decoding is checked
   against argmax decoding by one full re-forward (in f32, at full width
   and 8 layers); ``torch.profiler`` splits one prefill's and four decode
   steps' device time by kernel kind and gives the device's busy share;
7. times each kernel with CUDA events at its main path's launch shape
   beside its plain version, its bound (bytes over the card's memory
   rate, or operations over its rate) and, for attention, one
   ``scaled_dot_product_attention`` call as a library yardstick (never
   called by the port);
8. prints one JSON line listing every ported kernel, then the contract line
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


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def serving_smoke(dev, zero_counts, cfg_serve, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                  gen=SERVE_GEN):
    """Phases 5-6 and the attention half of phase 7: the attention kernels
    against their plain versions, the small model on the card against the
    CPU, the counted serving main path (``cfg_serve`` at its own width and
    depth, ``batch`` x ``prompt`` tokens, ``gen`` greedy tokens) and both
    kernels timed at its launch shapes.  Returns each kernel's entry of the
    ``kernels`` line without its name, route, source and replaced kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import reduce_for_smoke
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import (
        attention_mask,
        flash_attention,
        flash_attention_ref,
    )
    from repro_torch.kernels.gus import gus_assign
    from repro_torch.kernels.hier import hier_cells
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, params_to
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_batch

    # -- 5. the attention kernels vs their plain versions, the small model
    #       on the card vs the CPU --------------------------------------------
    attn_err = {"flash_attention": 0.0, "decode_attention": 0.0}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtypes[dtype])

    def compare_attn(name, label, got, want, dtype):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        attn_err[name] = max(attn_err[name], err)
        ok = torch.allclose(got.float(), want.float(), **ATTN_TOL[dtype])
        print(f"compare {name} {label} {dtype}: max_abs_err={err} within {ATTN_TOL[dtype]}: {ok}")
        check(ok, f"{name} kernel != plain version on {label} {dtype}")

    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for B, H, KV, S, hd, win in (
            (2, 4, 4, 100, 64, None),     # rep 1, ragged S
            (1, 8, 2, 200, 128, 8),       # rep 4, window 8
            (2, 16, 2, 77, 128, None),    # rep 8, ragged
            (1, 8, 1, 130, 64, 8),        # rep 8, window 8, ragged
        ):
            q = randn((B, S, H, hd), dtype, 1).transpose(1, 2)  # model-layout views
            k = randn((B, S, KV, hd), dtype, 2).transpose(1, 2)
            v = randn((B, S, KV, hd), dtype, 3).transpose(1, 2)
            compare_attn(
                "flash_attention", f"B={B} H={H} KV={KV} S={S} hd={hd} window={win}",
                flash_attention(q, k, v, causal=True, window=win, backend="cuda"),
                flash_attention_ref(q, k, v, causal=True, window=win), dtype,
            )
        for B, KV, rep, T, hd in ((2, 4, 1, 100, 64), (3, 2, 4, 257, 128), (2, 4, 8, 333, 128)):
            q = randn((B, KV, rep, hd), dtype, 4)
            k = randn((B, T, KV, hd), dtype, 5).transpose(1, 2)  # cache-layout views
            v = randn((B, T, KV, hd), dtype, 6).transpose(1, 2)
            g = torch.Generator(device=dev).manual_seed(7)
            valid = torch.rand((B, T), generator=g, device=dev) < 0.6
            valid[0] = False  # no valid position at all: zeros
            got = decode_attention(q, k, v, valid, backend="cuda")
            compare_attn("decode_attention", f"B={B} KV={KV} rep={rep} T={T} hd={hd}",
                         got, decode_attention_ref(q, k, v, valid), dtype)
            check(bool((got[0] == 0).all()), "an all-invalid decode row must be zeros")

    # both kernels at the serving main path's launch shapes and dtype
    mdt = cfg_serve.dtype
    Bm, Hm, KVm, hdm = batch, cfg_serve.num_heads, cfg_serve.num_kv_heads, cfg_serve.head_dim
    Sm, Tm = prompt, prompt + gen
    fq = randn((Bm, Sm, Hm, hdm), mdt, 8).transpose(1, 2)
    fk = randn((Bm, Sm, KVm, hdm), mdt, 9).transpose(1, 2)
    fv = randn((Bm, Sm, KVm, hdm), mdt, 10).transpose(1, 2)
    compare_attn("flash_attention", f"main-path launch B={Bm} H={Hm} KV={KVm} S={Sm} hd={hdm}",
                 flash_attention(fq, fk, fv, backend="cuda"), flash_attention_ref(fq, fk, fv), mdt)
    dq = randn((Bm, KVm, Hm // KVm, hdm), mdt, 11)
    dcache = randn((2, Bm, Tm, KVm, hdm), mdt, 12)
    dk, dv = dcache[0].transpose(1, 2), dcache[1].transpose(1, 2)
    # the last decode step's mask: every position but one holds a token
    dvalid = (torch.arange(Tm, device=dev) < Tm - 1)[None].expand(Bm, Tm)
    compare_attn("decode_attention", f"main-path launch B={Bm} KV={KVm} rep={Hm // KVm} T={Tm}",
                 decode_attention(dq, dk, dv, dvalid, backend="cuda"),
                 decode_attention_ref(dq, dk, dv, dvalid), mdt)
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

    # -- 6. the serving main path: at full width and depth ------------------
    serve_model = Model(cfg_serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # left by the earlier phases
    t0 = time.perf_counter()
    serve_params = serve_model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    param_bytes = nbytes(serve_params)
    engine = ServingEngine(serve_model, serve_params, device=dev)
    prompt_batch = make_batch(cfg_serve, batch, prompt, np.random.default_rng(0), device=dev)
    zero_counts()
    torch.cuda.synchronize()
    res = engine.generate(prompt_batch, max_new_tokens=gen)
    n_flash, n_decode = flash_attention.launches, decode_attention.launches
    check(gus_assign.launches == hier_cells.launches == 0,
          "the serving main path launched a scheduler kernel")
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
        f"flash_attention launches={n_flash} decode_attention launches={n_decode}"
    )
    check(n_flash == cfg_serve.num_layers,
          f"prefill must launch flash_attention once per layer, got {n_flash}")
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

    def time_events(fn, reps, warmup=2):
        """Mean ms of ``fn()`` over ``reps`` calls after ``warmup`` calls."""
        for _ in range(warmup):
            fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def attn_bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (BF16_OPS_PER_S if mdt == "bfloat16" else F32_OPS_PER_S) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def library_ms(fn, reps):
        """One PyTorch call for the same function, timed as a yardstick only."""
        try:
            return time_events(fn, reps)
        except RuntimeError as exc:  # a backend that refuses these inputs
            print(f"library yardstick unavailable: {exc}")
            return None

    sdpa = torch.nn.functional.scaled_dot_product_attention
    elt = dtypes[mdt].itemsize
    # flash: q and out once, k and v once; the causal (row, col) pairs' two
    # dot products of hd multiply-adds each
    pairs = int(attention_mask(Sm, Sm, True, None, dev).sum())
    fb_ms, fb_by = attn_bound(2 * Bm * Hm * Sm * hdm * elt + 2 * Bm * KVm * Sm * hdm * elt,
                              4 * hdm * Bm * Hm * pairs)
    flash_ms = time_events(lambda: flash_attention(fq, fk, fv, backend="cuda"), 10)
    flash_plain_ms = time_events(lambda: flash_attention_ref(fq, fk, fv), 3, warmup=1)
    flash_lib_ms = library_ms(lambda: sdpa(fq, fk, fv, is_causal=True, enable_gqa=True), 10)
    print(
        f"time flash_attention main-path launch B={Bm} H={Hm} KV={KVm} S={Sm} hd={hdm} {mdt} "
        f"causal: kernel {flash_ms:.4f} ms, plain {flash_plain_ms:.4f} ms, bound {fb_ms:.4f} ms "
        f"({fb_by}), kernel/bound {flash_ms / fb_ms:.2f}x, library "
        f"scaled_dot_product_attention {flash_lib_ms} ms"
    )
    # decode: the valid positions' k and v once, q and out once, the mask;
    # 6 caches of 17 MB in turn, so each launch finds its cache out of L2 as
    # the serving path does (48 layers' weights stream between two launches)
    n_valid = int(dvalid[0].sum())
    db_ms, db_by = attn_bound(
        2 * Bm * Hm * hdm * elt + 2 * Bm * KVm * n_valid * hdm * elt + Bm * Tm,
        4 * hdm * Bm * Hm * n_valid,
    )
    caches = randn((6, 2, Bm, Tm, KVm, hdm), mdt, 13)
    turn = [0]

    def next_cache():
        turn[0] = (turn[0] + 1) % caches.shape[0]
        return caches[turn[0], 0].transpose(1, 2), caches[turn[0], 1].transpose(1, 2)

    decode_ms = time_events(
        lambda: decode_attention(dq, *next_cache(), dvalid, backend="cuda"), 60)
    decode_plain_ms = time_events(lambda: decode_attention_ref(dq, *next_cache(), dvalid), 12)
    dmask = dvalid[:, None, None, :]
    decode_lib_ms = library_ms(
        lambda: sdpa(dq.flatten(1, 2)[:, :, None], *next_cache(), attn_mask=dmask,
                     enable_gqa=True), 60)
    print(
        f"time decode_attention main-path launch B={Bm} KV={KVm} rep={Hm // KVm} T={Tm} "
        f"valid={n_valid} hd={hdm} {mdt}: kernel {decode_ms:.4f} ms, plain {decode_plain_ms:.4f} "
        f"ms, bound {db_ms:.4f} ms ({db_by}), kernel/bound {decode_ms / db_ms:.2f}x, library "
        f"scaled_dot_product_attention {decode_lib_ms} ms"
    )
    print(
        f"serve main path attention share: flash {n_flash} x {flash_ms:.4f} ms of "
        f"{res.prefill_ms:.3f} ms prefill, decode {n_decode} x {decode_ms:.4f} ms of "
        f"{res.decode_ms_per_token * (gen - 1):.3f} ms decode (kernel times at the launch "
        "shape, out of L2)"
    )

    return {
        "flash_attention": {
            "launches": n_flash, "max_abs_err": attn_err["flash_attention"], "ms": flash_ms,
            "plain_ms": flash_plain_ms, "bound_ms": fb_ms, "bound_by": fb_by,
            "library_ms": flash_lib_ms,
        },
        "decode_attention": {
            "launches": n_decode, "max_abs_err": attn_err["decode_attention"], "ms": decode_ms,
            "plain_ms": decode_plain_ms, "bound_ms": db_ms, "bound_by": db_by,
            "library_ms": decode_lib_ms,
        },
    }


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
    kinds = (("flash_attention", "flash_attention_kernel"),
             ("decode_attention", "decode_attention_kernel"),
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
    from repro_torch.core.simulator import (
        _build_hier_window,
        _build_window,
        _hier_device_inputs,
        _pad_bucket,
        _RepFrameSource,
    )
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gus import gus_assign, gus_assign_ref
    from repro_torch.kernels.hier import hier_cells, hier_cells_ref
    from repro_torch.obs.trace import Stopwatch

    dev = torch.device("cuda")
    fields = [f.name for f in dataclasses.fields(FlatInstance)]
    # f32 comparisons on the card are full f32: no TF32 in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def zero_counts():
        gus_assign.launches = hier_cells.launches = 0
        flash_attention.launches = decode_attention.launches = 0
    t_start = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    builds = build_libraries(["gus_assign", "hier_cells", "flash_attention", "decode_attention"])
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

    # -- 2. kernel vs plain version on the card -----------------------------
    max_err = 0.0

    def kernel_args(batch):
        B = batch.A.shape[0]
        return tuple(
            getattr(batch, f).expand(B).contiguous() if f in ("max_as", "max_cs")
            else getattr(batch, f).contiguous()
            for f in fields
        )

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

    for path in sorted((ROOT / "tests" / "fixtures").glob("gus_golden_*.npz")):
        d = np.load(path)
        a = compare(path.stem, batch_of_one(d))
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
    spec = demo_cluster_spec(n_edge=9, n_cloud=1, n_services=5, n_variants=10)
    cfg = SimConfig(
        horizon_ms=30_000.0, arrival_rate_per_s=6.0, delay_req_ms=6000.0,
        acc_req_mean=50.0, acc_req_std=10.0,
    )
    n_rep_scale, window = 1024, 5
    T = int(math.ceil(cfg.horizon_ms / cfg.frame_ms))
    scn = get_scenario("paper-default")
    t0 = time.perf_counter()
    sources = [
        _RepFrameSource(
            scn, r, spec.n_edge, spec.proc_ms.shape[1], cfg, T, False, False, "vectorized"
        )
        for r in range(n_rep_scale)
    ]
    n_pad = _pad_bucket(max(s.max_bucket for s in sources))
    host, _ = _build_window(sources, spec, cfg, scn, 0, window, n_pad, Stopwatch(), True)
    fleet_win = FlatInstance(**{f: host[f].to(dev) for f in fields})
    print(f"fleet window built: {time.perf_counter() - t0:.3f} s host, n_pad={n_pad}")
    compare("fleet window (1024 reps x 5 frames)", fleet_win)
    fleet_step = FlatInstance(**{f: getattr(fleet_win, f)[:n_rep_scale] for f in fields})

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
    check(hier_cells.launches == flash_attention.launches == decode_attention.launches == 0,
          "the dense main path launched another kernel")
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
    check(gus_assign.launches == flash_attention.launches == decode_attention.launches == 0,
          "the hierarchical main path launched another kernel")
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

    # -- 5.-6. attention kernels, the small model, the serving main path,
    #         attention timing ---------------------------------------------
    attn = serving_smoke(dev, zero_counts, get_config(SERVE_ARCH))


    # -- 7. kernel timing (the scheduler kernels) ----------------------------
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
        ("fleet frame step B=1024 N=256 M=10 L=10", fleet_step),
        ("paper batch B=20000 N=100 M=10 L=10", paper),
        ("fleet window launch B=5120 N=256 M=10 L=10", fleet_win),
    ):
        args = kernel_args(batch)
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
        "ms": main_ms,
        "plain_ms": main_plain,
        "bound_ms": main_bound,
        "bound_by": main_by,
        "library_ms": None,
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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:118",
        **attn["flash_attention"],
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:91",
        **attn["decode_attention"],
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
