#!/usr/bin/env python3
"""Time flash attention's two routes at the serving launch shapes, on one GPU.

    PYTHONPATH=src python3 tools/flash_routes.py [--arch pixtral-12b ...] [--reps 10]

For each ``--arch`` (default: pixtral-12b at a 2048-token prompt,
stablelm-12b at 1024, both head_dim 160, zamba2-7b at 2048, head_dim 224
at its scale (hd/2)^-1/2, and yi-9b at 1024, head_dim 128, for
comparison), at batch 8 in bf16 and causal, the model-layout q/k/v
views that the serving path hands the kernel are drawn from a seed.  The
route the port takes (``flash_route``) is held against the plain version
``flash_attention_ref`` at ``chip_smoke.ATTN_TOL``, then timed in turns
(route, CUDA-core route forced, ``scaled_dot_product_attention``, route):
the route and SDPA as device time, one replay of a captured CUDA graph of
``--reps`` calls, and as CUDA events around eager calls; the CUDA-core
route by events.  Beside them the bound (``chip_smoke.attention_bounds``).
First the card's name and power limit, the ``-Xptxas -v`` lines of the
tensor-core library and its hd-160 and hd-224 instantiations' SASS counts.  The
results also go to ``chiprun_out/flash_routes.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: (arch, prompt) timed by default
SHAPES = {"pixtral-12b": 2048, "stablelm-12b": 1024, "zamba2-7b": 2048, "yi-9b": 1024}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=sorted(SHAPES),
                    help="repeat for several (default: all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_routes: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
        flash_route,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    builds = build_libraries(["flash_attention", "flash_attention_wgmma"])
    for line in builds["flash_attention_wgmma"].log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    for hd in (160, 224):
        cs.sass_check(builds["flash_attention_wgmma"].path, f"tensor-core flash at hd {hd}",
                      ("HGMMA", "UTMALDG", "UTMASTG"),
                      function=f"flash_attention_wgmma_kernelILi{hd}E")
    dev = torch.device("cuda")
    results = {"device": smi, "reps": args.reps, "shapes": {}}
    for arch in args.arch or list(SHAPES):
        cfg = get_config(arch)
        B, S, H, KV, hd, dt = args.batch, SHAPES[arch], cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim, "bfloat16"
        q = cs.randn(dev, (B, S, H, hd), dt, 31).transpose(1, 2)
        k = cs.randn(dev, (B, S, KV, hd), dt, 32).transpose(1, 2)
        v = cs.randn(dev, (B, S, KV, hd), dt, 33).transpose(1, 2)
        route = flash_route(q.dtype, hd)
        scale = getattr(cfg, "attn_scale", None)  # zamba2's (hd/2)^-1/2, else 1/sqrt(hd)
        got = flash_attention(q, k, v, backend="cuda", scale=scale)
        want = flash_attention_ref(q, k, v, scale=scale)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), **cs.ATTN_TOL[dt])
        del got, want
        (bound_ms, bound_by), _ = cs.attention_bounds(B, H, KV, S, S, S, hd, dt)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def kernel():
            flash_attention(q, k, v, backend="cuda", scale=scale)

        def lib():
            sdpa(q, k, v, is_causal=True, enable_gqa=True, scale=scale)

        t = {"route": route, "max_abs_err": err, "within_tol": ok,
             "bound_ms": bound_ms, "bound_by": bound_by}
        t["graph_ms"] = [cs.time_graph(kernel, args.reps)]
        t["simt_ms"] = cs.flash_simt_ms(kernel, max(2, args.reps // 3))
        t["library_graph_ms"] = cs.library_ms(lib, args.reps, cs.time_graph)
        t["graph_ms"].append(cs.time_graph(kernel, args.reps))
        t["ms"] = cs.time_events(kernel, args.reps)
        t["library_ms"] = cs.library_ms(lib, args.reps)
        results["shapes"][arch] = t
        g = min(t["graph_ms"])
        lib_g = t["library_graph_ms"]
        print(
            f"{arch} flash B={B} H={H} KV={KV} S={S} hd={hd} {dt} causal: {route} route "
            f"max_abs_err {err} within {cs.ATTN_TOL[dt]}: {ok}; device "
            f"{' / '.join(f'{x:.4f}' for x in t['graph_ms'])} ms (eager {t['ms']:.4f}), "
            f"CUDA-core route forced {t['simt_ms']:.4f} ms eager, SDPA {lib_g} ms device "
            f"({t['library_ms']} eager), bound {bound_ms:.4f} ms ({bound_by}): "
            f"{bound_ms / g:.1%} of the bound"
            + (f", {g / lib_g:.2f}x SDPA" if lib_g else ""))
        del q, k, v
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out" / "flash_routes.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    bad = [a for a, t in results["shapes"].items() if not t["within_tol"]]
    if bad:
        print(f"flash_routes: kernel != plain version at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
