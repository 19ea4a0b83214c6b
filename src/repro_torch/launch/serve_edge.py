"""The serve -> schedule loop: ``python -m repro_torch.launch.serve_edge [--steps 200]``.

The port of ``examples/serve_edge.py`` (the reference's "deliverable (b)"):
train the paper-analog zoo (SqueezeNet/GoogleNet-style tiny LMs), measure
each variant's next-token accuracy and ``generate`` latency with the
serving engine, build the scheduler's cluster from those measurements,
and serve a request stream through GUS and two baselines, reporting
satisfied-%:   train -> profile -> schedule -> serve -> measure.

Everything runs on ``--device`` (default ``cuda``).  Training takes the
plain route, as the reference's does; the accuracy and the latency are
measured on the kernels (the zoo is float32 at head dims 32, 64 and 64,
so ``flash_attention`` and ``decode_attention`` run on the CUDA cores;
:func:`variant_config` keeps each base config's head dim, as the
example's ``dataclasses.replace`` does).
The latency is ``GenerationResult.total_ms`` of one batch-1 request (a
32-token prompt, 8 generated tokens): prefill plus 7 decode steps,
between two device synchronisations.  An untimed ``generate`` of the same
request runs first, so the timed one includes no kernel build, no first
launch and no allocator warm-up.  The schedulers are the reference's raw
callables: ``gus_schedule_np`` and the ``local_all`` / ``offload_all``
baselines (the baselines launch the GUS kernel on ``device``).

One step differs from the example: the measured ladder is placed at the
paper's testbed scale before it becomes the cluster's processing times.
The example's cluster is calibrated in absolute milliseconds (3 s frames,
requests arriving 4 a second, a 100 ms cloud delay, transfers at 600
bytes/ms, deadlines of 4x the slowest variant), and its GUS >= 50% claim
holds where a variant takes a large part of a second: the example's
own CPU measurement (1.4-1.7 s, its first, compiling call) is there, the
paper's testbed (1300 ms on a Raspberry Pi 4) too.  Warm, the zoo takes
~10-35 ms, where the same cluster leaves GUS a few per cent (every deadline
passes while a request queues).  So the edge times are the measured ones
scaled by one factor that puts the smallest variant at the paper's
:data:`PAPER_EDGE_MS`: the ladder's ratios are the measured ones, the
regime the paper's.  Both the measured and the scaled times are reported,
and the three schedulers also serve the cluster built from the measured
times unscaled: their satisfied-% is printed beside the scaled run's, and
the example's GUS >= 50% claim is held on the scaled run only.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.paper_zoo import GOOGLE_LM, MID_LM, SQUEEZE_LM
from ..core import ClusterSpec, SimConfig, gus_schedule_np, local_all, offload_all, simulate
from ..core.instance import resolve_device
from ..models import Model
from ..obs import counters
from ..serving import ServingEngine
from ..training import AdamWConfig, SyntheticLM, init_state, make_batch, make_train_step

# one shared learnable task (a peaky Markov chain); the example's note on
# why the three sizes reach similar accuracy at this scale holds here too
VOCAB = 128
SOURCE = SyntheticLM(VOCAB, seed=7, alpha=0.003)

# the example's size ladder
SIZES = {
    "squeeze-lm": dict(num_layers=2, d_model=96, num_heads=4, num_kv_heads=2, d_ff=256),
    "mid-lm": dict(num_layers=3, d_model=160, num_heads=4, num_kv_heads=2, d_ff=512),
    "google-lm": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, d_ff=768),
}
#: the example's measurement batches: next-token accuracy over 8 x 64
#: tokens, latency of one 32-token prompt and 8 generated tokens
EVAL_BATCH, EVAL_SEQ = 8, 64
GEN_PROMPT, GEN_TOKENS = 32, 8
#: the paper's testbed latency of its edge model on the edge device, and
#: of the cloud model on the desktop (the example's 1300:300)
PAPER_EDGE_MS = 1300.0
PAPER_CLOUD_MS = 300.0


def variant_config(cfg):
    """A zoo config at the example's vocabulary and size."""
    return dataclasses.replace(cfg, vocab_size=VOCAB, **SIZES[cfg.arch_id])


def train_variant(cfg, steps, seed=0, *, device=None):
    """The example's training of one zoo variant: AdamW at lr 1e-2, batches
    of 8 x 64 from :data:`SOURCE`.  Returns ``(model, params, first_loss,
    last_loss)``."""
    dev = resolve_device(device)
    cfg = variant_config(cfg)
    model = Model(cfg)
    opt = AdamWConfig(lr=1e-2, total_steps=steps, warmup_steps=max(steps // 10, 1))
    step = make_train_step(model, opt)
    state = init_state(model, seed, device=dev)
    rng = np.random.default_rng(seed)
    first = last = None
    for i in range(steps):
        state, m = step(state, make_batch(cfg, 8, 64, rng, SOURCE, device=dev))
        if i == 0:
            first = float(m["loss"])
        last = float(m["loss"])
    return model, state.params, first, last


def build_cluster(acc, proc_edge, proc_cloud):
    """The example's cluster from measured profiles: 2 edges holding the
    two cheap variants, 1 cloud holding all three, 3 services sharing the
    zoo.  Returns ``(spec, simcfg)``."""
    K, L, M = 3, len(acc), 3
    proc = np.zeros((M, K, L), np.float32)
    placed = np.zeros((M, K, L), bool)
    for j in range(2):  # edges hold the two cheap variants
        proc[j, :, :] = np.array(proc_edge)[None, :]
        placed[j, :, :2] = True
    proc[2, :, :] = np.array(proc_cloud)[None, :]
    placed[2, :, :] = True
    acc_kl = np.broadcast_to(np.array(acc, np.float32)[None, :], (K, L)).copy()
    spec = ClusterSpec(
        n_edge=2,
        n_cloud=1,
        gamma_frame=np.array([3 * max(proc_edge), 3 * max(proc_edge), 10 * max(proc_cloud)],
                             np.float32),
        eta_frame=np.array([350.0, 350.0, 3500.0], np.float32),
        proc_ms=proc,
        placed=placed,
        acc=acc_kl,
    )
    simcfg = SimConfig(
        horizon_ms=90_000.0,
        arrival_rate_per_s=4.0,
        delay_req_ms=4.0 * max(proc_edge),
        acc_req_mean=max(min(acc) - 1.0, 1.0),  # all variants accuracy-feasible
        frame_ms=3000.0,
        queue_cap=4,
    )
    return spec, simcfg


def schedulers(device):
    """The example's three raw scheduler callables, by name."""
    cloud = torch.arange(3) >= 2
    return {
        "GUS": gus_schedule_np,
        "local-all": lambda i: local_all(i, device=device),
        "offload-all": lambda i: offload_all(i, cloud, device=device),
    }


def main(steps=200, device=None):
    """Train, measure, schedule; print the example's tables, check its
    claims, and return what was measured: ``variants`` (one dict each),
    ``spec``, ``simcfg`` and ``results`` (the ``SimResult`` per policy) of
    the testbed-scaled cluster, and ``spec_measured``, ``simcfg_measured``
    and ``results_measured`` of the cluster built from the measured times
    unscaled."""
    dev = resolve_device(device)
    variants, acc, measured = [], [], []
    rng = np.random.default_rng(0)
    for cfg in (SQUEEZE_LM, MID_LM, GOOGLE_LM):
        t0 = time.time()
        model, params, l0, l1 = train_variant(cfg, steps, device=dev)
        train_s = time.time() - t0
        eng = ServingEngine(model, params, device=dev)
        eval_batch = make_batch(model.cfg, EVAL_BATCH, EVAL_SEQ, rng, SOURCE, device=dev)
        gen_batch = make_batch(model.cfg, 1, GEN_PROMPT, rng, SOURCE, device=dev)
        eng.generate(gen_batch, max_new_tokens=GEN_TOKENS)  # untimed: builds and warms
        counts0 = counters.snapshot()
        a = eng.eval_next_token_accuracy(eval_batch) * 100
        r = eng.generate(gen_batch, max_new_tokens=GEN_TOKENS)
        acc.append(a)
        measured.append(r.total_ms)
        variants.append(dict(
            arch=cfg.arch_id, loss0=l0, loss1=l1, acc=a, train_s=train_s,
            total_ms=r.total_ms, prefill_ms=r.prefill_ms,
            decode_ms_per_token=r.decode_ms_per_token,
            flash_launches=counters.launches("flash_attention", counts0),
            decode_launches=counters.launches("decode_attention", counts0),
        ))
        print(
            f"{cfg.arch_id:11s} trained {steps} steps ({train_s:.0f}s): "
            f"loss {l0:.2f}->{l1:.2f}, next-token acc {a:.1f}%, "
            f"measured latency {r.total_ms:.2f}ms on {dev}",
            flush=True,
        )
    if not max(acc) > 30.0:
        raise AssertionError("zoo should learn the task well beyond chance")
    if acc[-1] <= acc[0]:
        print(f"note: accuracy ladder within training noise at this scale "
              f"({acc[0]:.1f}% vs {acc[-1]:.1f}%)")

    # the testbed's scale (module docstring); the 'cloud' runs the same
    # hardware here, so model the paper's RPi4-vs-desktop gap with its
    # measured 1300:300 ratio
    scale = PAPER_EDGE_MS / measured[0]
    proc_edge = [t * scale for t in measured]
    proc_cloud = [t * PAPER_CLOUD_MS / PAPER_EDGE_MS for t in proc_edge]
    print("testbed processing ms (edge / cloud): " + ", ".join(
        f"{v['arch']} {e:.0f} / {c:.0f}" for v, e, c in zip(variants, proc_edge, proc_cloud)))
    spec, simcfg = build_cluster(acc, proc_edge, proc_cloud)
    # the example's own cluster: the measured times as they are
    spec_m, simcfg_m = build_cluster(
        acc, measured, [t * PAPER_CLOUD_MS / PAPER_EDGE_MS for t in measured])
    print("\npolicy        satisfied%  local%  cloud%  edge-off%  dropped%  [bw estimates]"
          "  satisfied% unscaled")
    results, results_measured = {}, {}
    for name, sched in schedulers(dev).items():
        r = simulate(spec, simcfg, sched, seed=1, device=dev)
        results[name] = r
        results_measured[name] = simulate(spec_m, simcfg_m, sched, seed=1, device=dev)
        d = r.as_dict()
        bw = ", ".join(f"{b:.0f}" for b in r.bandwidth_estimates[:4])
        print(
            f"{name:13s} {d['satisfied_pct']:9.1f} {d['local_pct']:7.1f} "
            f"{d['cloud_pct']:7.1f} {d['edge_offload_pct']:9.1f} "
            f"{d['dropped_pct']:8.1f}  [{bw}, ...]"
            f"  {results_measured[name].as_dict()['satisfied_pct']:9.1f}"
        )
    if not results["GUS"].as_dict()["satisfied_pct"] >= 50.0:
        raise AssertionError("GUS should satisfy most users in this regime")
    print("\nend-to-end: trained zoo -> measured profiles -> GUS serving OK "
          "(the GUS >= 50% claim held on the testbed-scaled cluster)")
    return dict(variants=variants, spec=spec, simcfg=simcfg, results=results,
                spec_measured=spec_m, simcfg_measured=simcfg_m,
                results_measured=results_measured)

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args()
    main(args.steps, device=args.device)
