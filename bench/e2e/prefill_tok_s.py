"""Prompt tokens of every batch the window completed, over the window's
seconds (host clock, from the first batch's call to the last one's served
tokens)."""


def value(run):
    return sum(b.batch * b.length for b in run.batches) / run.window_s
