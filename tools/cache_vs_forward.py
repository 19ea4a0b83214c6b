#!/usr/bin/env python3
"""Prefill, then decode steps through the cache, against the plain
reference's full forward over the same tokens, for a configuration of the
benchmark at its published widths and depth, on the card.

    python3 tools/cache_vs_forward.py --config zamba2-7b --batch 8 --prompt 1024 \
        [--steps 16] [--seed N] [--out FILE]

The benchmark's weights for ``--seed`` (``bench/harness/weights.py``, bf16
as served) and ``batch`` rows of ``prompt + steps`` token ids from the
seed.  The program (``repro_torch.models.Model``, the card's kernels)
prefills the first ``prompt`` tokens into caches from ``init_cache`` and
then takes ``steps`` decode steps, each fed the next token of the row; its
logits at the last prompt position and after each step are compared with
the reference's (``bench/reference/``, float32, TF32 off) over the whole
rows, position by position, and so are the reference's own logits in
float8 e4m3 (the output check's control).  Prints one JSON line: the
largest absolute logit difference of each against the float32 reference,
the reference logits' spread, and the widest gap by which the reference's
logit of each one's first-ranked token lies below its best (the output
check's number); ``ok`` where the program's difference and gap lie below
the control's.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2**33 + 1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness.cell import program_config
    from bench.harness.manifest import family, load_json, load_manifest
    from bench.harness.seeds import derive
    from bench.harness.weights import make_weights
    from bench.reference import logits_at
    from repro_torch.models import Model

    if not torch.cuda.is_available():
        print("the comparison needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    conf = next(c for c in load_manifest(ROOT)["configs"] if c["name"] == args.config)
    c = load_json(ROOT / conf["file"])
    cfg = program_config(c)
    w = make_weights(c, args.seed, dev, getattr(torch, c["param_dtype"]))
    B, P, n = args.batch, args.prompt, args.steps
    g = torch.Generator(device=dev).manual_seed(derive(args.seed, "cache_vs_forward"))
    tok = torch.randint(0, c["vocab_size"], (B, P + n), generator=g, device=dev)
    model = Model(cfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = model.init_cache(B, P + n, device=dev)
        logits, cache = model.prefill(w, {"tokens": tok[:, :P]}, cache)
        got = [logits[:, 0]]
        for j in range(n):
            logits, cache = model.decode_step(w, tok[:, P + j:P + j + 1], cache)
            got.append(logits[:, 0])
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    got = torch.stack(got, 1).float()  # positions P - 1 .. P + n - 1
    del cache, logits
    torch.cuda.empty_cache()
    seqs = list(tok)
    at = [torch.arange(P - 1, P + n, device=dev)] * B
    trunk = family(c).reference.trunk
    t0 = time.perf_counter()
    ref = torch.stack(logits_at(c, w, seqs, at, trunk=trunk))
    reference_s = time.perf_counter() - t0
    ctl = torch.stack(logits_at(c, w, seqs, at, "fp8", trunk=trunk))

    def gap(x):
        return float((ref.amax(-1) - ref.gather(-1, x.argmax(-1, keepdim=True)).squeeze(-1)).max())

    out = {"config": args.config, "device": torch.cuda.get_device_name(dev), "batch": B,
           "prompt": P, "steps": n, "seed": args.seed,
           "program_max_abs": float((got - ref).abs().max()),
           "control_max_abs": float((ctl - ref).abs().max()),
           "reference_std": float(ref.std()), "reference_max_abs": float(ref.abs().max()),
           "program_gap": gap(got), "control_gap": gap(ctl),
           "by_position_max_abs": [float(x) for x in (got - ref).abs().amax((0, 2))],
           "program_s": program_s, "reference_s": reference_s}
    out["ok"] = bool(out["program_max_abs"] < out["control_max_abs"]
                     and out["program_gap"] <= out["control_gap"])
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
