"""Device time of the kernels launched inside the span ``ssm/conv`` (the
Mamba-2 block's causal conv, bias and SiLU: the kernel ``causal_conv`` on
the card), in ns a prompt token of the traced window (``spans.METRICS``);
nothing where no such span ran."""
from bench.harness.spans import read_metric


def read(run):
    return read_metric("ssm_conv_ns_per_tok.prefill", run)
