"""Device time of the kernels launched inside the span ``norm`` (the
layers' pre-norms and the final norm), in ns a prompt token of the traced
window (``spans.METRICS``)."""
from bench.harness.spans import read_metric


def read(run):
    return read_metric("norm_ns_per_tok.prefill", run)
