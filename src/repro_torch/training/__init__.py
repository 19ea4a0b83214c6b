"""Training for the port: AdamW, the loss and the train/eval steps,
synthetic data, npz checkpoints in the reference's layout."""
from .checkpoint import restore_checkpoint, save_checkpoint
from .data import SyntheticLM, audio_stub_batch, batch_iterator, make_batch, vision_stub_batch
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update, cosine_schedule
from .train_loop import (
    TrainState,
    cross_entropy,
    init_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
    "TrainState", "cross_entropy", "make_loss_fn", "make_train_step", "make_eval_step",
    "init_state", "SyntheticLM", "batch_iterator", "make_batch", "vision_stub_batch",
    "audio_stub_batch",
    "save_checkpoint", "restore_checkpoint",
]
