"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

The port's counterpart of ``repro/launch/train.py``, with its flags,
defaults and log lines, plus ``--device`` (default ``cuda``).  The train
step runs the forward and backward on the plain route (the hand kernels
have no backward, as the reference trains with ``use_pallas=False``) and
AdamW on ``device``.  ``--smoke`` (the default) trains the reduced config;
``--no-smoke`` the full one, in its own dtypes.  Every arch of the
registry trains; the MoE family's loss adds ``router_aux_weight *
router_aux``, and the batches carry the VLM and encoder-decoder stubs.
"""
from __future__ import annotations

import argparse
import time

from ..configs import ARCH_IDS, get_config, reduce_for_smoke
from ..core.instance import resolve_device
from ..models.model import Model
from ..training import AdamWConfig, batch_iterator, init_state, make_train_step, save_checkpoint


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-3,
    seed: int = 0,
    ckpt: str | None = None,
    log_every: int = 10,
    device=None,
):
    """Train ``arch`` for ``steps`` steps on ``batch_iterator``'s synthetic
    stream; returns ``(state, losses)``.  ``device=None`` means the card
    (raises without one)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    model = Model(cfg)
    opt = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(steps // 10, 1))
    step_fn = make_train_step(model, opt)
    state = init_state(model, seed, device=dev)
    it = batch_iterator(cfg, batch, seq, seed=seed, device=dev)

    losses = []
    t0 = time.time()
    for i in range(steps):
        b = next(it)
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        if (i + 1) % log_every == 0 or i == 0:
            print(
                f"step {i+1:5d} loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.2f} "
                f"({(time.time()-t0)/(i+1):.2f}s/step)",
                flush=True,
            )
    if ckpt:
        save_checkpoint(ckpt, {"params": state.params}, step=steps)
        print(f"checkpoint -> {ckpt}")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["squeeze-lm", "mid-lm", "google-lm"],
                    default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    _, losses = train(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, ckpt=args.ckpt, device=args.device,
    )
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
