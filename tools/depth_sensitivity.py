#!/usr/bin/env python3
"""How far a random-init yi-9b's logits move under a tiny change, by depth.

    PYTHONPATH=src python3 tools/depth_sensitivity.py [--layers 2 4 12 24 48]

yi-9b's layout (32 heads, 4 KV heads, the registry's init) at a width the
CPU runs (d_model 512, head dim 16, d_ff 1024, vocab 2048), float32, seed 0,
one prefill of 2 x 64 tokens.  For each depth it prints the largest
last-position logit and how far the logits move when the embedding is
multiplied by ``1 + 1e-6 * N(0, 1)``: a change of the size of float32
rounding; once with the weights as drawn and once with w_q, w_k, w_v
rescaled to a fan-in of d_model (``chip_smoke.qkv_to_fan_in_d``: the
reference's init gives them a fan-in of H or KV, so the scores are large
and every softmax nearly one-hot).  Where the move is of the order of the
logits, the network is chaotic at that depth, and two correct computations
that only add their partial sums in another order (tensor parallel against
one device) cannot be told apart from a fault by any tolerance on the
logits.  Runs on the CPU in well under a minute.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 12, 24, 48])
    ap.add_argument("--rel", type=float, default=1e-6)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import make_batch

    for n in args.layers:
        cfg = dataclasses.replace(get_config("yi-9b"), num_layers=n, d_model=512, head_dim=16,
                                  d_ff=1024, vocab_size=2048, dtype="float32",
                                  param_dtype="float32")
        model = Model(cfg)
        batch = make_batch(cfg, 2, 64, np.random.default_rng(0), device="cpu")
        row = {"layers": n, "rel": args.rel}
        for label in ("as drawn", "q/k/v at fan-in d"):
            params = model.init(0, device="cpu")
            if label != "as drawn":
                for lp in params["layers"]:
                    for name, fan_in in (("w_q", cfg.num_heads), ("w_k", cfg.num_kv_heads),
                                         ("w_v", cfg.num_kv_heads)):
                        lp["attn"][name].mul_(math.sqrt(fan_in / cfg.d_model))
            g = torch.Generator().manual_seed(1)
            moved = dict(params, embed=params["embed"] * (
                1 + args.rel * torch.randn(params["embed"].shape, generator=g)))
            with torch.no_grad():
                y0 = model.prefill(params, batch, model.init_cache(2, 65, device="cpu"))[0][:, -1]
                y1 = model.prefill(moved, batch, model.init_cache(2, 65, device="cpu"))[0][:, -1]
            row[label] = {"max_abs_logit": float(y0.abs().max()),
                          "moved_by": float((y1 - y0).abs().max())}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
