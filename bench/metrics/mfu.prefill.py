"""The model FLOPs of every batch of the traced window over the traced
window's seconds (the profiler's span around the window) times the card's
bf16 peak, in %: the whole step's share of the chip, which bounds what any
one kernel's gain can show."""
from bench.harness.peaks import BF16_FLOP_PER_S
from bench.metrics._model import window_flops


def read(run):
    if run.trace is None or not run.batches or run.trace.window_s <= 0:
        return None
    return 100.0 * window_flops(run) / (run.trace.window_s * BF16_FLOP_PER_S)
