"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id>``.

The port's counterpart of ``repro/launch/serve.py``: runs batched
prefill + greedy decode through the ServingEngine on randomly initialised
weights (the reduced config unless ``smoke=False``) and prints the measured
latencies — the numbers a production deployment would feed back into the
GUS scheduler's processing-time table.  Every arch of the registry is
served; ``make_batch`` adds the VLM family's patch stub and the
encoder-decoder family's frame stub.  Runs on the CUDA device unless
``serve(..., device="cpu")``.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import ARCH_IDS, get_config, reduce_for_smoke
from ..core.instance import resolve_device
from ..models.model import Model
from ..serving import ServingEngine
from ..training import make_batch


def serve(arch: str, *, smoke: bool = True, batch: int = 4, prompt: int = 32, gen: int = 16,
          seed: int = 0, device=None):
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    model = Model(cfg)
    params = model.init(seed, device=dev)
    eng = ServingEngine(model, params, device=dev)
    b = make_batch(cfg, batch, prompt, np.random.default_rng(seed), device=dev)
    res = eng.generate(b, max_new_tokens=gen)
    print(
        f"{arch}: batch={batch} prompt={prompt} gen={gen} -> "
        f"prefill={res.prefill_ms:.1f}ms decode={res.decode_ms_per_token:.2f}ms/tok "
        f"total={res.total_ms:.1f}ms"
    )
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["squeeze-lm", "mid-lm", "google-lm"], default="squeeze-lm")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    serve(args.arch, batch=args.batch, prompt=args.prompt, gen=args.gen)


if __name__ == "__main__":
    main()
