"""Device time of the kernels launched inside the span ``ssm/gated_norm``
(the Mamba-2 block's RMSNorm of y * SiLU(z)), in ns a prompt token of the
traced window (``spans.METRICS``); nothing where no such span ran."""
from bench.harness.spans import read_metric


def read(run):
    return read_metric("gated_norm_ns_per_tok.prefill", run)
